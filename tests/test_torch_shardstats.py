"""The sharding ledger and the slot programs' collective census against
the reference's ``observability/shardstats.py``: the same rows for the
same layouts (replicated, sharded, stacked), the projection against the
actual layout, the report text, the gauges and the flight event, the
census a master records, and where the ledgers surface (the flight
report, ``GET /memory``)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from deeplearning4j_tpu.observability import shardstats as jshard

from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.backend import mesh as tmesh
from deeplearning4j_tpu_torch.backend.mesh import P, Sharded
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.observability import (
    MetricsRegistry, flightrecorder, get_flight_recorder, shardstats,
)

from tests._torch_parallel_common import data, jmesh, pair, tmesh_of

ROW_KEYS = ("logical_bytes", "global_bytes", "per_device_bytes",
            "stored_bytes", "devices", "replication_factor",
            "zero_projected_per_device_bytes",
            "zero_savings_per_device_bytes")


def _layouts():
    K = 4
    w = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    b = np.arange(5, dtype=np.float32)
    jm, tm = jmesh(K), tmesh_of(K)
    jt = {"repl": {"W": jax.device_put(w, NamedSharding(jm, JP())),
                   "b": jax.device_put(b, NamedSharding(jm, JP()))},
          "zero": {"W": jax.device_put(w, NamedSharding(jm, JP("data"))),
                   "b": jax.device_put(b, NamedSharding(jm, JP()))},
          "stack": {"W": jax.device_put(np.stack([w] * K),
                                        NamedSharding(jm, JP("data")))}}
    tt = {"repl": {"W": Sharded.from_full(torch.tensor(w), P(), tm),
                   "b": Sharded.from_full(torch.tensor(b), P(), tm)},
          "zero": {"W": Sharded.from_full(torch.tensor(w), P("data"), tm),
                   "b": Sharded.from_full(torch.tensor(b), P(), tm)},
          "stack": {"W": tmesh.replica_stack(
              torch.tensor(np.stack([w] * K)), tm)}}
    logical = {"stack": {"W": w}}
    return jt, tt, logical, K


def test_ledger_rows_match_jax():
    jt, tt, logical, K = _layouts()
    jl = jshard.sharding_ledger(jt, logical_trees=logical,
                                data_axis_size=K)
    tl = shardstats.sharding_ledger(tt, logical_trees=logical,
                                    data_axis_size=K)
    for name in jt:
        for key in ROW_KEYS:
            assert tl["trees"][name][key] == jl["trees"][name][key], \
                (name, key)
        for sub in jl["trees"][name]["subtrees"]:
            for key in ROW_KEYS:
                assert tl["trees"][name]["subtrees"][sub].get(key) == \
                    jl["trees"][name]["subtrees"][sub].get(key), (name, sub)
    assert tl["total"] == jl["total"]
    assert tl["trees"]["repl"]["replication_factor"] == K
    assert tl["trees"]["stack"]["replication_factor"] == K
    zero = tl["trees"]["zero"]
    # the projection of the replicated row is the zero row's actual bytes
    assert tl["trees"]["repl"]["zero_projected_per_device_bytes"] == \
        zero["per_device_bytes"]


def test_ledger_handles_plain_tensors_and_non_arrays():
    led = shardstats.sharding_ledger(
        {"t": {"a": torch.ones(4, 2), "n": np.ones(3, np.float32),
               "x": 3.0}})
    row = led["trees"]["t"]
    assert row["logical_bytes"] == 4 * 2 * 4 + 3 * 4
    assert row["replication_factor"] == 1.0


def test_format_ledger_matches_jax_text():
    jt, tt, logical, K = _layouts()
    jl = jshard.sharding_ledger(jt, logical_trees=logical, data_axis_size=K)
    tl = shardstats.sharding_ledger(tt, logical_trees=logical,
                                    data_axis_size=K)
    assert shardstats.format_ledger(tl, "pw") == \
        jshard.format_ledger(jl, "pw")


def test_record_ledger_sets_gauges_and_flight_event():
    _, tt, logical, K = _layouts()
    reg = MetricsRegistry()
    led = shardstats.record_ledger("unit", tt, logical_trees=logical,
                                   data_axis_size=K, registry=reg,
                                   notes={"why": "test"})
    assert reg.get_value("dl4j_replication_factor", component="unit",
                         tree="repl") == K
    assert reg.get_value("dl4j_sharded_bytes", component="unit",
                         tree="zero") == led["trees"]["zero"][
        "per_device_bytes"]
    assert shardstats.latest_ledgers()["unit"]["notes"] == {"why": "test"}
    evs = [e for e in get_flight_recorder().events()
           if e.kind == "sharding_ledger" and e.attrs["component"] == "unit"]
    assert evs and evs[-1].attrs["data_axis_size"] == K
    assert shardstats.record_ledger("bad", {"t": object()}) is not None


def test_sync_master_census_matches_the_gradient_bytes():
    """The replicated sync step all-reduces each gradient leaf once over
    the K slots (the census's payload is the slot stack); ZeRO
    reduce-scatters instead."""
    K = 4
    x, y = data(32)
    _, tn = pair()
    shardstats.clear_ledgers()
    tpar.DistributedNetwork(tn, tpar.SyncTrainingMaster(
        mesh=tmesh_of(K))).fit(ListDataSetIterator(DataSet(x, y), 16))
    prog = shardstats.program_analysis("SyncTrainingMaster.step")
    param_bytes = sum(t.numel() * 4 for l in tn.params.values()
                      for t in l.values())
    ar = prog["collectives"]["all-reduce"]
    assert ar["group_sizes"] == [K]
    # K stacked gradients of every leaf, and the K weighted losses
    assert ar["bytes"] == K * param_bytes + K * 4
    assert prog["wire_bytes_estimate"] > 0
    assert prog["comm_seconds_estimate"] == pytest.approx(
        prog["wire_bytes_estimate"] / shardstats.CPU_LINK_BANDWIDTH_ESTIMATE)
    axes = shardstats.attribute_mesh_axes(prog["collectives"],
                                          {"data": K, "model": 1})
    assert axes["all-reduce"] == ["data"]


def test_link_bandwidth_and_ring_recipe_match_jax():
    assert shardstats.LINK_BANDWIDTH["gpu"] == 900e9
    assert shardstats.link_bandwidth_for("cpu") == (
        shardstats.CPU_LINK_BANDWIDTH_ESTIMATE, "cpu-estimate")
    for op in shardstats.COLLECTIVE_OPS:
        for g in (None, 1, 4):
            assert shardstats.ring_wire_bytes(op, 1000.0, g) == \
                jshard.ring_wire_bytes(op, 1000.0, g)


def test_flight_report_and_memory_endpoint_carry_the_ledger(tmp_path):
    import json
    import urllib.request

    from deeplearning4j_tpu_torch.ui.server import UIServer

    K = 2
    _, tn = pair()
    tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K)).fit(
        iter([DataSet(*data(8)), DataSet(*data(8, seed=2))]))
    path = flightrecorder.dump_flight_report(str(tmp_path / "r.jsonl"),
                                             "test")
    recs = flightrecorder.read_flight_report(path)
    led = [r for r in recs if r["record"] == "sharding_ledger"]
    assert led and "parallel_wrapper" in led[0]["ledgers"]
    ui = UIServer(port=0)
    port = ui.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/memory", timeout=10) as r:
            mem = json.loads(r.read())
    finally:
        ui.stop()
    assert mem["ledgers"]["parallel_wrapper"]["trees"]["params"][
        "replication_factor"] == K
    assert "ParallelWrapper.fit_window" in mem["programs"]

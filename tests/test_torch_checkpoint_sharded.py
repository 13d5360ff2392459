"""The sharded checkpoint in the port: slot pieces saved one a distinct
block with their ``PartitionSpec``, the resharded restore onto any slot
mesh without a whole-leaf host assembly, each npz member read once, the
device-side reshard when the slot counts match, resume equivalence, and
directories crossing between the JAX package and the port both ways."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from deeplearning4j_tpu import parallel as jpar

from deeplearning4j_tpu_torch import parallel as tpar
from deeplearning4j_tpu_torch.backend.mesh import P, Sharded
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.parallel import checkpoint as cp
from deeplearning4j_tpu_torch.resilience import CheckpointManager

from tests._torch_parallel_common import (
    data, jmesh, pair, tmesh_of, tvec,
)

W = np.arange(16 * 6, dtype=np.float32).reshape(16, 6)
V = np.arange(8 * 8, dtype=np.float32).reshape(8, 8)
B = np.arange(8, dtype=np.float32)


class _Fake:
    updater_state = {}
    net_state = {}
    _keys = None

    def __init__(self, params, iteration):
        self.params, self.iteration = params, iteration


def _port_2x2(tmp_path):
    m = tmesh_of(2, model=2)
    trees = {"params": {"l": {
        "W": Sharded.from_full(torch.tensor(W), P("data"), m),
        "V": Sharded.from_full(torch.tensor(V), P(None, "model"), m),
        "b": Sharded.from_full(torch.tensor(B), P(), m)}},
        "updater_state": {}, "net_state": {}}
    tpar.save_checkpoint(str(tmp_path), _Fake({}, 5), trees=trees, mesh=m)


def _jax_2x2(tmp_path):
    mesh = jmesh(2, model=2)
    arrs = {"W": jax.device_put(W, NamedSharding(mesh, JP("data"))),
            "V": jax.device_put(V, NamedSharding(mesh, JP(None, "model"))),
            "b": jax.device_put(B, NamedSharding(mesh, JP()))}
    jpar.save_checkpoint(str(tmp_path), _Fake({"l": arrs}, 5))


def _forbid_full_gather(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("whole-leaf host assembly on the mesh path")

    monkeypatch.setattr(cp, "_assemble", boom)


def test_sharded_leaves_saved_per_block_like_jax(tmp_path):
    """The port's manifest lists the same pieces, specs and slices as the
    JAX package's for the same layout."""
    _port_2x2(tmp_path / "port")
    _jax_2x2(tmp_path / "jax")
    mt = json.load(open(tmp_path / "port" / "manifest-0.json"))
    mj = json.load(open(tmp_path / "jax" / "manifest-0.json"))
    for path in ("params/l/W", "params/l/V", "params/l/b"):
        et, ej = mt["leaves"][path], mj["leaves"][path]
        assert et["spec"] == ej["spec"] and et["shape"] == ej["shape"]
        assert sorted(s["index"] for s in et["shards"]) == \
            sorted(s["index"] for s in ej["shards"])
    assert mt["mesh"]["axis_names"] == mj["mesh"]["axis_names"]
    assert mt["mesh"]["shape"] == mj["mesh"]["shape"]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("target", [(2, 1), (8, 1), (1, 8), (1, 1)])
def test_resharded_restore_matrix(tmp_path, monkeypatch, writer, target):
    """Saved on a 2x2 (data x model) layout by either package; restored
    onto K=2, K=8, 1x8 and one slot, bit-identical, the whole-leaf
    assembly forbidden."""
    (_port_2x2 if writer == "port" else _jax_2x2)(tmp_path)
    host, _, _, _ = tpar.restore_checkpoint(str(tmp_path))
    for k, v in (("W", W), ("V", V), ("b", B)):
        np.testing.assert_array_equal(host["l"][k], v)
    _forbid_full_gather(monkeypatch)
    mesh = tmesh_of(target[0], model=target[1])
    params, _, _, it = tpar.restore_checkpoint(str(tmp_path), mesh=mesh)
    assert it == 5
    for k, v in (("W", W), ("V", V), ("b", B)):
        got = params["l"][k]
        assert isinstance(got, Sharded) and got.mesh is mesh
        np.testing.assert_array_equal(got.full().numpy(), v)
    assert tuple(params["l"]["W"].spec) == ("data",)


def test_restore_reads_each_member_once(tmp_path, monkeypatch):
    _port_2x2(tmp_path)
    reads = []
    orig = np.lib.npyio.NpzFile.__getitem__

    def counting(self, key):
        reads.append(key)
        return orig(self, key)

    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", counting)
    tpar.restore_checkpoint(str(tmp_path), mesh=tmesh_of(8))
    members = [k for k in reads if "@" in k]
    assert members and len(members) == len(set(members))


def test_same_slot_count_reshards_on_the_device(tmp_path, monkeypatch):
    """2x4 -> 1x8: the pieces load in the saved layout and one reshard
    lays them out; the same topology places them directly."""
    m = tmesh_of(2, model=4)
    w = torch.arange(16 * 8.).reshape(16, 8)
    trees = {"params": {"l": {"W": Sharded.from_full(w, P("data", "model"),
                                                     m)}},
             "updater_state": {}, "net_state": {}}
    tpar.save_checkpoint(str(tmp_path), _Fake({}, 1), trees=trees, mesh=m)
    calls = []
    orig = cp._reshard_on_device
    monkeypatch.setattr(cp, "_reshard_on_device",
                        lambda a, s, mm: calls.append(1) or orig(a, s, mm))
    _forbid_full_gather(monkeypatch)
    params, _, _, _ = tpar.restore_checkpoint(str(tmp_path),
                                              mesh=tmesh_of(1, model=8))
    assert len(calls) == 1
    assert torch.equal(params["l"]["W"].full(), w)
    calls.clear()
    tpar.restore_checkpoint(str(tmp_path), mesh=m)
    assert not calls


def test_port_written_zero_checkpoint_restores_in_jax(tmp_path):
    """A ZeRO wrapper's trees saved with mesh=: the JAX package restores
    them onto its own meshes (sharded and single device), and the port
    into a single net, equal to the wrapper's averaged state."""
    K = 4
    x, y = data(64)
    _, tn = pair()
    pw = tpar.ParallelWrapper(tn, workers=K, mesh=tmesh_of(K),
                              update_sharding="zero")
    pw.fit(ListDataSetIterator(DataSet(x, y), 16))
    tpar.save_checkpoint(str(tmp_path), tn, trees=pw.state_trees(),
                         mesh=pw.mesh)
    man = json.load(open(tmp_path / "manifest-0.json"))
    assert man["leaves"]["params/layer_0/W"]["spec"] == ["data"]
    assert len(man["leaves"]["params/layer_0/W"]["shards"]) == K
    for jm in (jmesh(2), jmesh(1)):
        jp, ju, _, it = jpar.restore_checkpoint(str(tmp_path), mesh=jm)
        assert it == tn.iteration
        np.testing.assert_array_equal(np.asarray(jp["layer_0"]["W"]),
                                      tn.params["layer_0"]["W"].numpy())
        np.testing.assert_array_equal(np.asarray(ju["m"]["layer_1"]["W"]),
                                      tn.updater_state["m"]["layer_1"][
                                          "W"].numpy())
    _, fresh = pair(seed=99)
    tpar.restore_checkpoint(str(tmp_path), fresh, mesh=tmesh_of(2))
    np.testing.assert_array_equal(tvec(fresh), tvec(tn))


def test_zero_resume_is_bit_identical_on_the_same_mesh(tmp_path):
    """Save the ZeRO wrapper after two windows, restore into a fresh net,
    a new wrapper on the same mesh takes the next windows: the same
    params as the uninterrupted run, bit for bit."""
    K = 4
    x, y = data(128, seed=3)
    _, ref = pair()
    tpar.ParallelWrapper(ref, workers=K, mesh=tmesh_of(K),
                         update_sharding="zero").fit(
        ListDataSetIterator(DataSet(x, y), 16))
    _, a = pair()
    mesh = tmesh_of(K)
    pw = tpar.ParallelWrapper(a, workers=K, mesh=mesh,
                              update_sharding="zero")
    pw.fit(ListDataSetIterator(DataSet(x[:64], y[:64]), 16))
    tpar.save_checkpoint(str(tmp_path), a, trees=pw.state_trees(), mesh=mesh)
    _, b = pair(seed=1234)
    tpar.restore_checkpoint(str(tmp_path), b, mesh=mesh)
    assert b.iteration == a.iteration
    tpar.ParallelWrapper(b, workers=K, mesh=mesh,
                         update_sharding="zero").fit(
        ListDataSetIterator(DataSet(x[64:], y[64:]), 16))
    np.testing.assert_array_equal(tvec(b), tvec(ref))


def test_dp_resume_equivalence_through_the_sync_master(tmp_path):
    x, y = data(64, seed=1)
    mesh = tmesh_of(8)
    _, ref = pair()
    tpar.DistributedNetwork(ref, tpar.SyncTrainingMaster(mesh=mesh)).fit(
        ListDataSetIterator(DataSet(x, y), 16))
    _, a = pair()
    tpar.DistributedNetwork(a, tpar.SyncTrainingMaster(mesh=mesh)).fit(
        ListDataSetIterator(DataSet(x[:32], y[:32]), 16))
    tpar.save_checkpoint(str(tmp_path), a)
    _, b = pair(seed=1234)
    tpar.restore_checkpoint(str(tmp_path), b, mesh=mesh)
    assert b.iteration == 2
    tpar.DistributedNetwork(b, tpar.SyncTrainingMaster(mesh=mesh)).fit(
        ListDataSetIterator(DataSet(x[32:], y[32:]), 16))
    np.testing.assert_allclose(tvec(ref), tvec(b), atol=1e-6)


def test_manager_resume_onto_a_different_topology(tmp_path):
    x, y = data(32, seed=3)
    _, net = pair()
    tpar.DistributedNetwork(net, tpar.SyncTrainingMaster(
        mesh=tmesh_of(8))).fit(ListDataSetIterator(DataSet(x, y), 16))
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(net)
    _, fresh = pair(seed=777)
    assert cm.resume(fresh, mesh=tmesh_of(2)) == net.iteration
    np.testing.assert_array_equal(tvec(fresh), tvec(net))
    tpar.DistributedNetwork(fresh, tpar.SyncTrainingMaster(
        mesh=tmesh_of(2))).fit(ListDataSetIterator(DataSet(x, y), 16))
    assert fresh.iteration == net.iteration + 2


def test_multi_process_manifests_merge(tmp_path):
    full = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    for proc, rows in ((0, (0, 4)), (1, (4, 8))):
        man = {"leaves": {"params/l/W": {
            "shape": [8, 2], "dtype": "float32", "spec": ["data"],
            "shards": [{"key": f"p{proc}/params/l/W@0",
                        "index": [[rows[0], rows[1]], [0, 2]]}]}}}
        with open(tmp_path / f"manifest-{proc}.json", "w") as f:
            json.dump(man, f)
        np.savez(tmp_path / f"shards-{proc}.npz",
                 **{f"p{proc}/params/l/W@0": full[rows[0]:rows[1]]})
    with open(tmp_path / "checkpoint.json", "w") as f:
        json.dump({"format_version": 1, "iteration": 3, "processes": 2}, f)
    params, _, _, it = tpar.restore_checkpoint(str(tmp_path))
    assert it == 3
    np.testing.assert_array_equal(params["l"]["W"], full)
    params, _, _, _ = tpar.restore_checkpoint(str(tmp_path),
                                              mesh=tmesh_of(4))
    assert tuple(params["l"]["W"].local.shape) == (4, 2, 2)
    np.testing.assert_array_equal(params["l"]["W"].full().numpy(), full)


def test_replicated_leaves_stored_once(tmp_path):
    m = tmesh_of(4)
    trees = {"params": {"l": {"W": Sharded.from_full(torch.ones(4, 4), P(),
                                                     m)}},
             "updater_state": {}, "net_state": {}}
    tpar.save_checkpoint(str(tmp_path), _Fake({}, 0), trees=trees, mesh=m)
    man = json.load(open(os.path.join(tmp_path, "manifest-0.json")))
    assert len(man["leaves"]["params/l/W"]["shards"]) == 1
    with pytest.raises(FileNotFoundError):
        tpar.restore_checkpoint(str(tmp_path / "nope"))

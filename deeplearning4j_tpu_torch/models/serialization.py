"""Zip checkpoints — counterpart of ``deeplearning4j_tpu/models/serialization.py``.

The same container for both facades: ``manifest.json`` (the model type
and the iteration), ``configuration.json`` (the config JSON),
``coefficients.npz`` (params flattened to ``"layer/sub/name"`` keys),
``netState.npz`` (the layers' state, BatchNorm's running stats, when
there is any) and ``updaterState.npz`` (the updater's trees,
``"slot/layer/sub/name"``).  Reading goes through ``models.interop``, so
a zip the JAX package wrote loads and resumes training here, and a zip
written here loads there.  The reader carries the stability guard's
updater subtree across, and the introspection and numerics vectors where
the configuration sets their policy.
``load_model`` dispatches on the manifest's ``model_type``.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict

import numpy as np

from deeplearning4j_tpu_torch.backend.device import DeviceLike
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy, updater_state_from_numpy,
)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

FORMAT_VERSION = 1
CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.npz"
UPDATER_ENTRY = "updaterState.npz"
NET_STATE_ENTRY = "netState.npz"
MANIFEST_ENTRY = "manifest.json"


def _flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    flat = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat["/".join(prefix + (k,))] = v.detach().float().cpu().numpy()
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _npz_bytes(tree) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **_flatten(tree))
    return buf.getvalue()


def write_model(net, path, save_updater: bool = True) -> None:
    """A ``MultiLayerNetwork`` or ``ComputationGraph`` as a zip."""
    manifest = {"format_version": FORMAT_VERSION,
                "model_type": type(net).__name__,
                "iteration": net.iteration,
                "framework": "deeplearning4j_tpu_torch"}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(MANIFEST_ENTRY, json.dumps(manifest))
        zf.writestr(CONFIG_ENTRY, net.conf.to_json())
        zf.writestr(COEFFICIENTS_ENTRY, _npz_bytes(net.params))
        if net.net_state:
            zf.writestr(NET_STATE_ENTRY, _npz_bytes(net.net_state))
        if save_updater and net.updater_state:
            zf.writestr(UPDATER_ENTRY, _npz_bytes(net.updater_state))


def read_manifest(path) -> Dict[str, Any]:
    with zipfile.ZipFile(path, "r") as zf:
        return json.loads(zf.read(MANIFEST_ENTRY).decode())


def _read_npz(zf, entry) -> Dict[str, Any]:
    return _unflatten(dict(np.load(io.BytesIO(zf.read(entry)))))


def _restore(path, conf_from_json, build, device, load_updater):
    with zipfile.ZipFile(path, "r") as zf:
        names = set(zf.namelist())
        conf = conf_from_json(zf.read(CONFIG_ENTRY).decode())
        params = _read_npz(zf, COEFFICIENTS_ENTRY)
        net_state = (_read_npz(zf, NET_STATE_ENTRY)
                     if NET_STATE_ENTRY in names else None)
        state = (_read_npz(zf, UPDATER_ENTRY)
                 if load_updater and UPDATER_ENTRY in names else None)
        manifest = json.loads(zf.read(MANIFEST_ENTRY).decode())
    net = build(conf, params, net_state, device)
    if state is not None:
        net.updater_state = updater_state_from_numpy(net, state)
    net.iteration = manifest.get("iteration", 0)
    return net


def restore_multi_layer_network(path, device: DeviceLike = None,
                                load_updater: bool = True):
    return _restore(
        path, MultiLayerConfiguration.from_json,
        lambda conf, params, ns, dev: params_from_numpy(conf, params, dev,
                                                        net_state=ns),
        device, load_updater)


def restore_computation_graph(path, device: DeviceLike = None,
                              load_updater: bool = True):
    from deeplearning4j_tpu_torch.models.graph import GraphConfiguration

    return _restore(
        path, GraphConfiguration.from_json,
        lambda conf, params, ns, dev: graph_params_from_numpy(
            conf, params, net_state=ns, device=dev),
        device, load_updater)


def load_model(path, device: DeviceLike = None, load_updater: bool = True):
    """Restore either facade, as the manifest's ``model_type`` says."""
    mtype = read_manifest(path).get("model_type")
    if mtype == "MultiLayerNetwork":
        return restore_multi_layer_network(path, device, load_updater)
    if mtype == "ComputationGraph":
        return restore_computation_graph(path, device, load_updater)
    raise ValueError(f"Unknown model_type '{mtype}' in {path}")

"""Zip checkpoints — counterpart of ``deeplearning4j_tpu/models/serialization.py``.

The same container: ``manifest.json``, ``configuration.json`` (the
config JSON) and ``coefficients.npz`` (params flattened to
``"layer/sub/name"`` keys).  Reading goes through
``models.interop.params_from_numpy``, so a zip the JAX package wrote
loads here, and a zip written here loads there.  Updater state is not
read or written yet (training comes with a later slice).
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict

import numpy as np

from deeplearning4j_tpu_torch.backend.device import DeviceLike
from deeplearning4j_tpu_torch.models.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

FORMAT_VERSION = 1
CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.npz"
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


def write_model(net, path) -> None:
    manifest = {"format_version": FORMAT_VERSION,
                "model_type": "MultiLayerNetwork", "iteration": 0,
                "framework": "deeplearning4j_tpu_torch"}
    buf = io.BytesIO()
    np.savez(buf, **_flatten(net.params))
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(MANIFEST_ENTRY, json.dumps(manifest))
        zf.writestr(CONFIG_ENTRY, net.conf.to_json())
        zf.writestr(COEFFICIENTS_ENTRY, buf.getvalue())


def read_manifest(path) -> Dict[str, Any]:
    with zipfile.ZipFile(path, "r") as zf:
        return json.loads(zf.read(MANIFEST_ENTRY).decode())


def restore_multi_layer_network(path, device: DeviceLike = None):
    with zipfile.ZipFile(path, "r") as zf:
        conf = MultiLayerConfiguration.from_json(zf.read(CONFIG_ENTRY).decode())
        flat = dict(np.load(io.BytesIO(zf.read(COEFFICIENTS_ENTRY))))
    return params_from_numpy(conf, _unflatten(flat), device)

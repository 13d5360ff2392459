"""The rest of the conv zoo in the port: ``vgg16`` (a MultiLayerNetwork)
and ``googlenet`` (a ComputationGraph of inception modules joined by
``MergeVertex``) against the JAX builders' JSON and parameter counts,
and their outputs and scores on carried weights (float32, at
``rtol=1e-3, atol=1e-4``).  Small inputs keep the CPU cost down: VGG-16
at 32x32 with 4 classes, GoogLeNet at 64x64 with 5."""

import functools
import json

import numpy as np
import pytest

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.models.graph import GraphConfiguration
from deeplearning4j_tpu_torch.models.interop import (
    graph_params_from_numpy, params_from_numpy,
)
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

RTOL, ATOL = 1e-3, 1e-4
# GoogLeNet's parameters at 224x224x3 with 1000 classes (the smoke run's
# shape): global pooling makes the count independent of the image size
GOOGLENET_PARAMS_1000 = 6998552
VGG16_PARAMS_224 = 138357544

SMALL = {"vgg16": dict(height=32, width=32, n_classes=4),
         "googlenet": dict(height=64, width=64, n_classes=5)}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX net, the port's net on its weights), built once a module."""
    jnet = getattr(jzoo, name)(**SMALL[name])
    if name == "googlenet":
        net = graph_params_from_numpy(
            GraphConfiguration.from_json(jnet.conf.to_json()),
            _np(jnet.params), device="cpu")
    else:
        net = params_from_numpy(
            MultiLayerConfiguration.from_json(jnet.conf.to_json()),
            _np(jnet.params), device="cpu")
    return jnet, net


def _batch(name, n=2):
    kw = SMALL[name]
    rs = np.random.RandomState(0)
    x = rs.rand(n, kw["height"], kw["width"], 3).astype(np.float32)
    y = np.eye(kw["n_classes"], dtype=np.float32)[
        rs.randint(0, kw["n_classes"], n)]
    return x, y


@pytest.mark.parametrize("name", sorted(SMALL))
def test_zoo_builds_the_jax_json_and_count(name):
    """The port's zoo function and the JAX one give the same JSON and
    parameter count (the port's net built on the CPU)."""
    jnet, _ = _pair(name)
    net = getattr(zoo, name)(device="cpu", **SMALL[name])
    assert json.loads(net.conf.to_json()) == json.loads(jnet.conf.to_json())
    assert net.num_params() == jnet.num_params()


def test_googlenet_count_at_full_width_is_pinned():
    """The count ``chip_smoke.py``'s GoogLeNet phase checks: the port's
    net at 1000 classes against the JAX net's count with its head widened
    from 5 classes to 1000 (global pooling makes the count independent
    of the image size)."""
    jnet, _ = _pair("googlenet")
    net = zoo.googlenet(n_classes=1000, height=32, width=32, device="cpu")
    head = 1024 + 1                    # the fc layer's weights a class
    assert jnet.num_params() + (1000 - 5) * head == GOOGLENET_PARAMS_1000
    assert net.num_params() == GOOGLENET_PARAMS_1000
    assert sum(1 for n in net.conf.nodes if n.name.endswith("_cat")) == 9


def test_vgg16_count_at_full_width(monkeypatch):
    """VGG-16 at 224x224x3 with 1000 classes has 138,357,544 parameters,
    counted from the shapes of ``zoo.vgg16``'s configuration (its
    ``init`` stubbed: nothing allocated); the JAX configuration reads
    the same layers back."""
    from deeplearning4j_tpu.nn.conf import MultiLayerConfiguration as JMLC

    class _NoInit:
        def __init__(self, conf):
            self.conf = conf

        def init(self, device=None):
            return self

    monkeypatch.setattr(zoo, "MultiLayerNetwork", _NoInit)
    conf = zoo.vgg16(device="cpu").conf
    count = sum(int(np.prod(s)) for layer in conf.layers
                if layer.has_params()
                for s in layer.param_shapes().values())
    assert count == VGG16_PARAMS_224
    assert len(JMLC.from_json(conf.to_json()).layers) == len(conf.layers)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_outputs_match_jax_on_carried_weights(name):
    jnet, net = _pair(name)
    x, _ = _batch(name)
    inputs = {"input": x} if name == "googlenet" else x
    got = net.output(inputs).numpy()
    want = np.asarray(jnet.output(inputs))
    assert got.shape == (2, SMALL[name]["n_classes"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_vgg16_score_matches_jax_on_carried_weights():
    """The loss with VGG-16's l2 term (GoogLeNet's loss path is the
    ResNet-50 graph's, held in ``test_torch_graph.py``)."""
    jnet, net = _pair("vgg16")
    x, y = _batch("vgg16")
    np.testing.assert_allclose(net.score(x, y), float(jnet.score(x, y)),
                               rtol=RTOL, atol=ATOL)

"""Shared helpers of the port's parallel parity tests: the JAX net and its
port twin with the same weights, data, and slot meshes on the CPU."""

import jax
import numpy as np
import torch

from deeplearning4j_tpu.backend import device as jbackend
from deeplearning4j_tpu.models.sequential import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer

from deeplearning4j_tpu_torch.backend import mesh as tmesh
from deeplearning4j_tpu_torch.models.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration


def jax_net(seed=21, n_in=8, hidden=16, n_out=4, updater="adam", lr=0.05,
            stab=None, intro=False):
    b = (jconf.NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr))
    if stab is not None:
        b = b.training_stability(stab)
    if intro:
        b = b.training_introspection(jconf.TrainingIntrospection())
    return JNet(b.list()
                .layer(DenseLayer(n_in=n_in, n_out=hidden, activation="tanh"))
                .layer(OutputLayer(n_in=hidden, n_out=n_out, loss="mcxent",
                                   activation="softmax"))
                .build()).init()


def port_of(jnet):
    """The port's net for the JAX net's configuration, holding its
    weights, on the CPU."""
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return params_from_numpy(conf, jax.device_get(jnet.params), device="cpu")


def pair(**kw):
    j = jax_net(**kw)
    return j, port_of(j)


def data(n=64, n_in=8, n_out=4, seed=1):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, n_in).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rs.randint(0, n_out, n)]
    return x, y


def jmesh(data=None, model=1, seq=1):
    n = (data or 1) * model * seq
    return jbackend.default_mesh(data=data, model=model, seq=seq,
                                 devices=jax.devices()[:n])


def tmesh_of(data=None, model=1, seq=1):
    n = (data or 1) * model * seq
    return tmesh.default_mesh(data=data, model=model, seq=seq,
                              devices=["cpu"] * n)


def jvec(net):
    return np.asarray(net.params_to_vector(), np.float64)


def tvec(net):
    return np.asarray(net.params_to_vector(), np.float64)


def jtree(tree):
    """A JAX tree as nested dicts of float64 numpy arrays."""
    if isinstance(tree, dict):
        return {k: jtree(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def ttree(tree):
    if isinstance(tree, dict):
        return {k: ttree(v) for k, v in tree.items()}
    return tree.detach().double().cpu().numpy() if torch.is_tensor(tree) \
        else np.asarray(tree, np.float64)


def assert_trees_close(a, b, rtol, atol, path=""):
    assert set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_close(a[k], b[k], rtol, atol, f"{path}/{k}")
        else:
            np.testing.assert_allclose(np.reshape(a[k], np.shape(b[k])),
                                       b[k], rtol=rtol, atol=atol,
                                       err_msg=f"{path}/{k}")

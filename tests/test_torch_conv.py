"""The port's conv-net layers (``deeplearning4j_tpu_torch/nn/layers/
convolution.py``, ``ActivationLayer``) and weight init against the JAX
package: the same NHWC inputs, HWIO kernels and cotangents, made from a
seed with numpy, through the JAX layer and the port layer built from its
dict.  Tolerance: ``atol=1e-5`` on outputs and gradients (float32;
XLA's and PyTorch's CPU convolutions sum in different orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn import initializers as jinit
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import (
    ActivationLayer as JActivation, ConvolutionLayer as JConv,
    GlobalPoolingLayer as JGlobalPool, SubsamplingLayer as JPool,
)
from deeplearning4j_tpu_torch.nn import initializers
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict

ATOL = 1e-5


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check(jlayer, x, params=None, **apply_kw):
    """Forward and gradients (input and params) of the JAX layer and its
    port, for one numpy cotangent."""
    params = params or {}

    def jfn(p, x):
        y, _ = jlayer.apply(p, {}, x, **apply_kw)
        return y

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jy, vjp = jax.vjp(jfn, jp, jnp.asarray(x))
    g = _x(99, *jy.shape)
    jgp, jgx = vjp(jnp.asarray(g))
    layer = layer_from_dict(jlayer.to_dict())
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    kw = {k: torch.from_numpy(np.asarray(v)) for k, v in apply_kw.items()}
    y = layer.apply(tp, tx, **kw)
    assert tuple(y.shape) == tuple(jy.shape)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL)
    names = sorted(tp)
    got = torch.autograd.grad(y, [tp[n] for n in names] + [tx],
                              torch.from_numpy(g))
    want = [jgp[n] for n in names] + [jgx]
    for n, a, b in zip(names + ["x"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=n)
    return layer


CONV = {
    "3x3_same": dict(kernel_size=(3, 3), stride=(1, 1), padding=(1, 1)),
    "ragged": dict(kernel_size=(3, 2), stride=(2, 1), padding=(1, 0)),
    "1x1_stride2": dict(kernel_size=(1, 1), stride=(2, 2), padding=(0, 0)),
    "7x7_stem": dict(kernel_size=(7, 7), stride=(2, 2), padding=(3, 3)),
}


@pytest.mark.parametrize("name", sorted(CONV))
def test_convolution_matches_jax(name):
    jl = JConv(n_in=3, n_out=5, activation="relu", weight_init="relu",
               **CONV[name])
    params = jax.device_get(jl.init(jax.random.PRNGKey(0), jnp.float32))
    params = {k: np.asarray(v) for k, v in params.items()}
    params["b"] = _x(1, 5)
    x = _x(2, 2, 11, 9, 3)
    layer = _check(jl, x, params)
    assert layer.param_shapes()["W"] == params["W"].shape
    port = layer.output_type(InputType.convolutional(11, 9, 3))
    ref = jl.output_type(JInputType.convolutional(11, 9, 3))
    assert port.to_dict() == ref.to_dict()


POOL = {
    "max_3x3_s2_p1": ("max", (3, 3), (2, 2), (1, 1)),
    "max_2x2": ("max", (2, 2), (2, 2), (0, 0)),
    "avg_3x3_s2_p1": ("avg", (3, 3), (2, 2), (1, 1)),
    "sum_3x2_s1_p1": ("sum", (3, 2), (1, 1), (1, 1)),
    "max_wide_pad": ("max", (3, 3), (2, 2), (2, 2)),
    "avg_wide_pad": ("avg", (2, 2), (1, 1), (2, 1)),
}


@pytest.mark.parametrize("name", sorted(POOL))
def test_subsampling_matches_jax(name):
    pt, k, s, p = POOL[name]
    jl = JPool(pooling_type=pt, kernel_size=k, stride=s, padding=p)
    _check(jl, _x(3, 2, 9, 8, 4))


@pytest.mark.parametrize("pt", ["avg", "max", "sum"])
def test_global_pooling_matches_jax(pt):
    jl = JGlobalPool(pooling_type=pt)
    _check(jl, _x(4, 3, 5, 6, 4))
    _check(jl, _x(5, 3, 7, 4))
    mask = np.array([[1, 1, 1, 0, 0, 0, 0], [1] * 7, [1, 0, 0, 0, 0, 0, 0]],
                    np.float32)
    _check(jl, _x(6, 3, 7, 4), mask=mask)


def test_activation_layer_matches_jax():
    _check(JActivation(activation="relu"), _x(7, 2, 3, 3, 4))
    _check(JActivation(activation="tanh"), _x(8, 5, 6))


@pytest.mark.parametrize("shape", [(5,), (4, 6), (3, 3, 8, 16),
                                   (7, 7, 3, 64), (1, 1, 256, 64)])
def test_fans_follow_the_reference(shape):
    assert initializers.fans(shape) == jinit._fans(shape, None, None)


@pytest.mark.parametrize("name", ["relu", "xavier"])
def test_init_spread_follows_the_reference_rule(name):
    """Not draw for draw (the streams differ): the spread of a conv
    kernel's draws is the scheme's, from the reference's fans (0.4 %
    sampling error on 36 864 draws; held to 3 %)."""
    shape = (3, 3, 64, 64)
    fi, fo = jinit._fans(shape, None, None)
    want = np.sqrt(2.0 / fi) if name == "relu" else np.sqrt(2.0 / (fi + fo))
    w = initializers.init(name, torch.Generator().manual_seed(0), shape)
    assert w.shape == shape
    assert abs(w.std().item() / want - 1) < 0.03
    assert abs(w.mean().item()) < 3 * want / np.sqrt(w.numel())
    with pytest.raises(ValueError, match="Unknown weight init"):
        initializers.check("he_normal")

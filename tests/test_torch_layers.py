"""Layer parity: the port's layers (``deeplearning4j_tpu_torch/nn/``) against
the JAX package's on the same float32 inputs and the same weights.

Each port layer is built from the reference layer's own dict
(``layer_from_dict(jax_layer.to_dict())``), so the config bridge is
exercised too.  Tolerance: atol = 1e-5 (float32, different summation
orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.layers import (
    LayerNorm as JLayerNorm, ResidualBlock as JResidualBlock,
    SelfAttentionLayer as JSelfAttention,
)
from deeplearning4j_tpu.nn.layers.attention import rope as jrope
from deeplearning4j_tpu_torch.nn.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.layers.attention import rope

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32))


def _port(jlayer, key=0):
    """(reference params as numpy, port layer, port params)."""
    params = _np_tree(jlayer.init(jax.random.PRNGKey(key), jnp.float32))
    return params, layer_from_dict(jlayer.to_dict()), _torch_tree(params)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    x = _x(0, 2, 5, 3, 8)
    pos = (np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32) if per_row
           else np.arange(5, dtype=np.int32) + 11)
    ref = jrope(jnp.asarray(x), jnp.asarray(pos))
    out = rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_layer_norm():
    jl = JLayerNorm(n_in=16)
    params, pl, pp = _port(jl)
    params = {"gamma": _x(1, 16) + 1.0, "beta": _x(2, 16)}
    pp = _torch_tree(params)
    x = _x(3, 2, 5, 16) * 3.0 + 1.0
    ref, _ = jl.apply(jax.tree_util.tree_map(jnp.asarray, params), {},
                      jnp.asarray(x))
    np.testing.assert_allclose(pl.apply(pp, torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=ATOL)


ATTN = {
    "causal": dict(n_heads=4),
    "gqa": dict(n_heads=4, n_kv_heads=2),
    "window": dict(n_heads=4, n_kv_heads=1, window=3),
}


@pytest.mark.parametrize("name", sorted(ATTN))
def test_self_attention_apply(name):
    jl = JSelfAttention(n_in=16, n_out=16, causal=True, rope=True,
                        flash=False, **ATTN[name])
    params, pl, pp = _port(jl)
    x = _x(4, 2, 7, 16)
    ref, _ = jl.apply(jax.tree_util.tree_map(jnp.asarray, params), {},
                      jnp.asarray(x))
    np.testing.assert_allclose(pl.apply(pp, torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=ATOL)


def _paged_carry(pools, block, pos):
    return {**pools, "block": block, "pos": pos}


def test_apply_paged_across_page_boundary():
    """Prefill a 3-token chunk at positions 2..4 (page_size 4: it crosses
    into the row's second page), then decode one token; outputs and the
    written pools agree at every call."""
    jl = JSelfAttention(n_in=16, n_out=16, n_heads=4, n_kv_heads=2,
                        causal=True, rope=True)
    params, pl, pp = _port(jl, key=1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jpools = jl.init_paged_cache(6, 4, jnp.float32)
    tpools = pl.init_paged_cache(6, 4, torch.float32, "cpu")
    block = np.array([[3, 5, 0], [1, 2, 4]], np.int32)
    pos = np.array([2, 5], np.int32)
    for seed, t in ((5, 3), (6, 1)):
        x = _x(seed, 2, t, 16)
        jy, _, jc = jl.apply_with_carry(
            jparams, {}, jnp.asarray(x),
            _paged_carry(jpools, jnp.asarray(block), jnp.asarray(pos)))
        ty, tc = pl.apply_with_carry(
            pp, torch.from_numpy(x),
            _paged_carry(tpools, torch.from_numpy(block),
                         torch.from_numpy(pos)))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
        jpools = {"pk": jc["pk"], "pv": jc["pv"]}
        for k in ("pk", "pv"):
            assert tc[k] is tpools[k]        # written in place
            np.testing.assert_allclose(tpools[k].numpy(),
                                       np.asarray(jpools[k]), atol=ATOL)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        pos = pos + t


def _blocks():
    return JResidualBlock(layers=(
        JLayerNorm(n_in=16),
        JSelfAttention(n_in=16, n_out=16, n_heads=4, causal=True, rope=True,
                       flash=False)))


def test_residual_block_apply():
    jl = _blocks()
    params, pl, pp = _port(jl, key=2)
    x = _x(7, 2, 6, 16)
    ref, _ = jl.apply(jax.tree_util.tree_map(jnp.asarray, params), {},
                      jnp.asarray(x))
    np.testing.assert_allclose(pl.apply(pp, torch.from_numpy(x)).numpy(),
                               np.asarray(ref), atol=ATOL)


def test_residual_block_apply_with_carry():
    jl = _blocks()
    params, pl, pp = _port(jl, key=3)
    jpools = jl.init_paged_cache(5, 4, jnp.float32)
    tpools = pl.init_paged_cache(5, 4, torch.float32, "cpu")
    block = np.array([[2, 4], [1, 3]], np.int32)
    pos = np.array([0, 3], np.int32)
    x = _x(8, 2, 2, 16)

    def attach(pools, mk):
        return {"sub1": {**pools["sub1"], "block": mk(block), "pos": mk(pos)}}

    jy, _, jc = jl.apply_with_carry(
        jax.tree_util.tree_map(jnp.asarray, params), {}, jnp.asarray(x),
        attach(jpools, jnp.asarray))
    ty, tc = pl.apply_with_carry(pp, torch.from_numpy(x),
                                 attach(tpools, torch.from_numpy))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(tc["sub1"]["pk"].numpy(),
                               np.asarray(jc["sub1"]["pk"]), atol=ATOL)


# ----------------------------------------- activations and weight inits
_ACTIVATIONS = ["identity", "linear", "sigmoid", "tanh", "relu", "leakyrelu",
                "elu", "softplus", "softsign", "hardtanh", "hardsigmoid",
                "cube", "rationaltanh", "softmax", "gelu", "swish"]


@pytest.mark.parametrize("name", _ACTIVATIONS)
def test_activation_matches_jax(name):
    """Every reference activation on the same inputs (both sides of the
    clips and kinks, large magnitudes for softplus)."""
    from deeplearning4j_tpu.nn import activations as jact
    from deeplearning4j_tpu_torch.nn import activations

    x = np.concatenate([np.linspace(-6, 6, 97, dtype=np.float32),
                        np.array([-30.0, -2.5, 0.0, 2.5, 30.0],
                                 np.float32)]).reshape(6, 17)
    ref = np.asarray(jact.get(name)(jnp.asarray(x)))
    out = activations.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_activation_register_and_unknown_name():
    from deeplearning4j_tpu.nn import activations as jact
    from deeplearning4j_tpu_torch.nn import activations

    activations.register("Doubled", lambda x: 2 * x)
    assert torch.equal(activations.get("doubled")(torch.ones(2)),
                       torch.full((2,), 2.0))
    with pytest.raises(ValueError) as err:
        activations.get("nope")
    with pytest.raises(ValueError) as jerr:
        jact.get("nope")
    assert str(err.value).split(".")[0] == str(jerr.value).split(".")[0]


_SCHEMES = ["uniform", "xavier", "xavier_uniform", "xavier_fan_in",
            "xavier_legacy", "relu", "relu_uniform", "sigmoid_uniform",
            "normal"]


@pytest.mark.parametrize("fans", [None, (7, 300)])
@pytest.mark.parametrize("shape", [(400, 300), (3, 3, 40, 60)])
@pytest.mark.parametrize("scheme", _SCHEMES)
def test_init_scheme_scale_matches_jax(scheme, shape, fans):
    """The port's draws are its own; their scale is the reference's: the
    standard deviation of 72,000+ draws within 3% of the JAX scheme's on
    the same shape and fans, zero mean, and a uniform scheme's draws
    inside the same bound."""
    from deeplearning4j_tpu.nn import initializers as jinit
    from deeplearning4j_tpu_torch.nn import initializers

    kw = {} if fans is None else {"fan_in": fans[0], "fan_out": fans[1]}
    ref = np.asarray(jinit.init(scheme, jax.random.PRNGKey(0), shape,
                                jnp.float32, **kw))
    got = initializers.init(scheme, torch.Generator().manual_seed(0), shape,
                            **kw).numpy()
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got.std(), ref.std(), rtol=3e-2)
    assert abs(got.mean()) < 0.05 * got.std()
    if "uniform" in scheme:
        bound = np.abs(ref).max()
        assert np.abs(got).max() <= bound * 1.001
        assert np.abs(got).max() > 0.99 * bound


def test_constant_and_distribution_inits():
    from deeplearning4j_tpu.nn import initializers as jinit
    from deeplearning4j_tpu_torch.nn import initializers

    gen = torch.Generator().manual_seed(1)
    assert torch.equal(initializers.init("zero", gen, (2, 3)),
                       torch.zeros(2, 3))
    assert torch.equal(initializers.init("ones", gen, (4,)), torch.ones(4))
    for d in ({"type": "normal", "mean": 1.0, "std": 0.5},
              {"type": "uniform", "lower": 2.0, "upper": 3.0}):
        dist = initializers.distribution_from_dict(d)
        assert dist.to_dict() == d == \
            jinit.distribution_from_dict(d).to_dict()
        got = initializers.init("distribution", gen, (300, 200),
                                distribution=dist).numpy()
        ref = np.asarray(jinit.init("distribution", jax.random.PRNGKey(1),
                                    (300, 200), jnp.float32,
                                    distribution=jinit.distribution_from_dict(
                                        d)))
        np.testing.assert_allclose(got.mean(), ref.mean(), atol=0.01)
        np.testing.assert_allclose(got.std(), ref.std(), rtol=3e-2)
        if d["type"] == "uniform":
            assert 2.0 <= got.min() and got.max() <= 3.0
    assert initializers.distribution_from_dict(None) is None
    for mod in (initializers, jinit):
        with pytest.raises(ValueError, match="requires a distribution"):
            mod.init("distribution", None if mod is initializers else
                     jax.random.PRNGKey(0), (2, 2))
        with pytest.raises(ValueError, match="Unknown distribution type"):
            mod.distribution_from_dict({"type": "cauchy"})
    with pytest.raises(ValueError, match="Unknown weight init"):
        initializers.check("glorot")


def test_dense_and_conv_layers_draw_from_their_distribution():
    from deeplearning4j_tpu_torch.nn.layers import ConvolutionLayer, DenseLayer

    dist = {"type": "uniform", "lower": 5.0, "upper": 6.0}
    for layer in (DenseLayer(n_in=4, n_out=3, weight_init="distribution",
                             dist=dist),
                  ConvolutionLayer(n_in=2, n_out=3, kernel_size=(2, 2),
                                   weight_init="distribution", dist=dist)):
        w = layer.init(torch.Generator().manual_seed(0))["W"]
        assert 5.0 <= w.min() and w.max() <= 6.0

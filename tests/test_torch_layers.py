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

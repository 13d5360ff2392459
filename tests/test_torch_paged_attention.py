"""The port's paged decode attention (``deeplearning4j_tpu_torch/helpers/
paged_attention.py``) against the JAX package's, on the same numpy inputs.

Here on the CPU the port's wrapper runs the kernel's plain version; the
CUDA kernel itself is held against that plain version on the card
(``chip_smoke.py`` and ``tests/test_torch_cuda.py``).  Float32
throughout: the JAX side runs with x64 enabled for the session, so every
input is pinned to float32/int32.  Tolerance: atol = rtol = 1e-5 (the
two sides sum in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.helpers.paged_attention import (
    paged_decode_attention as jax_paged,
)
import deeplearning4j_tpu_torch.helpers as helpers
from deeplearning4j_tpu_torch.helpers import paged_attention as pa
from deeplearning4j_tpu_torch.nn.layers.attention import (
    gather_pages, paged_attention,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _scenario(seed, *, pages, page_size, maxp, b, t, hq, hkv, d):
    """Engine-shaped inputs: page 0 is the trash page and unassigned
    block-table slots point at it; row 0 is an all-padding fresh slot at
    position 0 (the trash row); row 1 ends exactly on the first slot of
    its second page (a page-boundary position); the other rows sit at
    random positions."""
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((pages * page_size, hkv, d)).astype(np.float32)
    pv = rng.standard_normal((pages * page_size, hkv, d)).astype(np.float32)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    block = rng.integers(1, pages, size=(b, maxp))
    qlast = rng.integers(t - 1, maxp * page_size, size=(b,))
    qlast[0] = t - 1
    block[0] = 0
    qlast[1] = max(page_size, t - 1)
    for bi in range(b):
        block[bi, int(qlast[bi]) // page_size + 1:] = 0
    qpos = (qlast - (t - 1))[:, None] + np.arange(t)[None]
    return (q, pk, pv, block.astype(np.int32), qpos.astype(np.int32))


SCENARIOS = {
    "decode": dict(pages=10, page_size=8, maxp=4, b=3, t=1, hq=4, hkv=4,
                   d=32),
    "prefill": dict(pages=12, page_size=8, maxp=4, b=2, t=4, hq=4, hkv=4,
                    d=32),
    "gqa": dict(pages=10, page_size=8, maxp=4, b=3, t=1, hq=4, hkv=2, d=32),
}


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("impl", ["pallas", "lax", "gather"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plain_matches_jax(name, impl):
    cfg = SCENARIOS[name]
    q, pk, pv, block, qpos = _scenario(7, **cfg)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                    jnp.asarray(block), jnp.asarray(qpos),
                    page_size=cfg["page_size"], impl=impl, interpret=True)
    out = pa.paged_attention_plain(*_torch(q, pk, pv, block, qpos),
                                   cfg["page_size"])
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gather_oracle_matches_jax(name):
    """The port's own oracle (gather_pages + paged_attention)."""
    cfg = SCENARIOS[name]
    ps = cfg["page_size"]
    q, pk, pv, block, qpos = _scenario(11, **cfg)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                    jnp.asarray(block), jnp.asarray(qpos), page_size=ps,
                    impl="gather")
    tq, tk, tv, tb, tp = _torch(q, pk, pv, block, qpos)
    out = paged_attention(tq, gather_pages(tk, tb, ps),
                          gather_pages(tv, tb, ps), tp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_wrapper_routes_cpu_tensors_to_plain_and_counts():
    cfg = SCENARIOS["gqa"]
    args = _torch(*_scenario(3, **cfg))
    pa.counts.reset()
    out = pa.paged_decode_attention(*args, page_size=cfg["page_size"])
    assert (pa.counts.launches, pa.counts.plain_calls) == (0, 1)
    np.testing.assert_array_equal(
        out.numpy(), pa.paged_attention_plain(*args, cfg["page_size"]).numpy())
    pa.counts.reset()
    assert (pa.counts.launches, pa.counts.plain_calls) == (0, 0)


def test_wrapper_rejects_bad_shapes_and_devices():
    cfg = SCENARIOS["decode"]
    q, pk, pv, block, qpos = _torch(*_scenario(5, **cfg))
    with pytest.raises(ValueError, match="q_positions"):
        pa.paged_decode_attention(q, pk, pv, block, qpos[:, :0],
                                  page_size=cfg["page_size"])
    with pytest.raises(ValueError, match="page_size"):
        pa.paged_decode_attention(q, pk, pv, block, qpos, page_size=7)
    meta = [x.to("meta") for x in (q, pk, pv, block, qpos)]
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_decode_attention(*meta, page_size=cfg["page_size"])


def test_mode_toggle_and_helper_seam():
    helper = helpers.get_helper("paged_attention")
    assert isinstance(helper, pa.PagedAttentionHelper)
    q = torch.zeros((1, 1, 4, 32))
    assert pa.paged_attention_mode() == "fused" and helper.supports(q, 4)
    try:
        pa.set_paged_attention_mode("gather")
        assert not helper.supports(q, 4)
    finally:
        pa.set_paged_attention_mode("fused")
    with pytest.raises(ValueError):
        pa.set_paged_attention_mode("einsum")
    try:
        helpers.enable_helpers(False)
        assert helpers.get_helper("paged_attention") is None
    finally:
        helpers.enable_helpers(True)


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
# the split schedule's edges: contexts up to 3600 keys in 8 splits a
# row tile (a cluster's most), splits of many chunks, pages of 36 keys (so split edges,
# multiples of 8, fall inside pages), rows whose later splits see no live
# key, GQA, and D = 128 (32 lanes a key, 8 keys a chunk per lane group)
LONG = dict(pages=420, page_size=36, maxp=100, b=4, t=1, hq=2, hkv=1,
            d=128)


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



# ------------------------------------------------- the split schedule
# ``paged_decode_kernel`` (csrc/paged_attention.cu) splits each row tile's
# keys across blocks; the emulation below follows its constants and its
# order of work, in float32.
NEG_INF32 = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
WARPS, STAGE_KEYS_MIN, SPLIT_KEYS, TARGET_BLOCKS, MAX_SPLITS = 4, 32, 8, \
    3 * 132, 8


def _plan(b, t, hq, hkv, d, page_size, maxp, esize=4):
    """The kernel's grid and lane layout: (rows a block, row tiles,
    splits, lanes a key, keys a warp scores at once, keys a chunk)."""
    rows = hq // hkv * t
    rb = 1 if rows == 1 else 4
    tiles = -(-rows // rb)
    pairs = b * hkv * tiles
    n = min(-(-TARGET_BLOCKS // pairs), -(-(maxp * page_size) // 32))
    n = max(1, min(n, MAX_SPLITS))
    nvec = d * esize // 16
    lpk = min(32, 1 << (nvec - 1).bit_length())
    kpw = 32 // lpk
    ck = max(STAGE_KEYS_MIN, WARPS * kpw)
    return rb, tiles, n, lpk, kpw, ck


def _merge(parts, sl2):
    """(m, l, acc) merged from partials in the given order, each scaled
    by 2^((m_j - m) sl2), as the kernel merges lane groups, warps and
    splits."""
    m = parts[0][0]
    for pm, _, _ in parts[1:]:
        m = np.maximum(m, pm)
    l = np.zeros_like(m)
    acc = np.zeros_like(parts[0][2])
    for pm, pl_, pa_ in parts:
        w = np.exp2((pm - m) * sl2)
        l = l + pl_ * w
        acc = acc + pa_ * w[:, None]
    return m, l, acc


def _split_schedule(q, pk, pv, block, qpos, page_size):
    """The kernel's output on one call, emulated: per (b, kv head, row
    tile) and split, each lane group's online softmax over its keys of
    each chunk, the lane groups merged by the butterfly, the warps in
    order, then the splits in order.  Also returns, per block, its
    (k_begin, k_end)."""
    b, t, hq, d = q.shape
    hkv = pk.shape[1]
    g, maxp = hq // hkv, block.shape[1]
    rb, tiles, n, lpk, kpw, ck = _plan(b, t, hq, hkv, d, page_size, maxp)
    sl2 = np.float32(1.0 / np.sqrt(d)) * LOG2E
    out = np.zeros_like(q)
    spans = {}
    for bi in range(b):
        for h in range(hkv):
            for tile in range(tiles):
                rs = [r for r in range(tile * rb, tile * rb + rb)
                      if r < g * t]
                heads = [h * g + r // t for r in rs]
                toks = [r % t for r in rs]
                pos = np.array([qpos[bi, ti] for ti in toks]
                               + [-1] * (rb - len(rs)))
                qr = np.zeros((rb, d), np.float32)
                for i, (hh, ti) in enumerate(zip(heads, toks)):
                    qr[i] = q[bi, ti, hh]
                ln = min(int(pos.max()) + 1, maxp * page_size)
                per = -(-(-(-ln // n)) // SPLIT_KEYS) * SPLIT_KEYS
                parts = []
                for sp in range(n):
                    k_begin = min(ln, sp * per)
                    k_end = min(ln, k_begin + per)
                    spans[bi, h, tile, sp] = (k_begin, k_end)
                    parts.append(_one_block(qr, pos, pk, pv, block[bi], h,
                                            page_size, k_begin, k_end, lpk,
                                            kpw, ck, sl2))
                m, l, acc = _merge(parts, sl2)
                o = np.where(l[:, None] > 0,
                             acc / np.where(l > 0, l, 1)[:, None], 0)
                for i, (hh, ti) in enumerate(zip(heads, toks)):
                    out[bi, ti, hh] = o[i]
    return out, spans


def _one_block(qr, pos, pk, pv, brow, h, page_size, k_begin, k_end, lpk,
               kpw, ck, sl2):
    """One block's partial (m, l, acc) over keys [k_begin, k_end)."""
    rb, d = qr.shape
    num_pages = pk.shape[0] // page_size
    groups = {}
    for w in range(WARPS):
        for grp in range(kpw):
            groups[w, grp] = (np.full(rb, NEG_INF32), np.zeros(rb, np.float32),
                              np.zeros((rb, d), np.float32))
    for c0 in range(k_begin, k_end, ck):
        for (w, grp), (m, l, acc) in groups.items():
            kps = [c0 + (it * WARPS + w) * kpw + grp
                   for it in range(ck // (WARPS * kpw))]
            kv = []
            for kp in kps:
                if kp < k_end:
                    page = min(max(int(brow[kp // page_size]), 0),
                               num_pages - 1)
                    slot = page * page_size + kp % page_size
                    kv.append((pk[slot, h], pv[slot, h]))
                else:                           # zero-filled by cp.async
                    kv.append((np.zeros(d, np.float32),) * 2)
            s = np.stack([qr @ k for k, _ in kv], 1)        # [rb, NI]
            keep = (np.array(kps)[None] < k_end) \
                & (np.array(kps)[None] <= pos[:, None])
            s = np.where(keep, s, NEG_INF32)
            mx = np.maximum(m, s.max(1))
            alpha = np.exp2((m - mx) * sl2)
            mu = np.where(mx > NEG_INF32 / 2, mx * sl2, np.float32(0))
            p = np.exp2(s * sl2 - mu[:, None])
            l = alpha * l + p.sum(1)
            acc = acc * alpha[:, None] + p @ np.stack([v for _, v in kv])
            groups[w, grp] = (mx, l, acc)
    warps = []
    for w in range(WARPS):       # the butterfly over the group bits
        vals = [groups[w, grp] for grp in range(kpw)]
        off = 1
        while off < kpw:
            vals = [_merge([vals[i], vals[i ^ off]], sl2)
                    for i in range(kpw)]
            off *= 2
        warps.append(vals[0])
    return _merge(warps, sl2)


def _split_inputs(name):
    """A scenario's inputs; in the long one row 2 fills the whole table
    (3600 keys)."""
    cfg = LONG if name == "long" else SCENARIOS[name]
    q, pk, pv, block, qpos = _scenario(17, **cfg)
    if name == "long":
        rng = np.random.default_rng(18)
        block[2] = rng.integers(1, cfg["pages"], size=cfg["maxp"])
        qpos[2] = cfg["maxp"] * cfg["page_size"] - 1
    return cfg, (q, pk, pv, block, qpos)


@pytest.mark.parametrize("name", sorted(SCENARIOS) + ["long"])
def test_split_schedule_matches_plain(name):
    """The kernel's split schedule, emulated, gives the plain version's
    output (float32, atol = rtol = 1e-5)."""
    cfg, (q, pk, pv, block, qpos) = _split_inputs(name)
    out, _ = _split_schedule(q, pk, pv, block, qpos, cfg["page_size"])
    ref = pa.paged_attention_plain(*_torch(q, pk, pv, block, qpos),
                                   cfg["page_size"])
    np.testing.assert_allclose(out, ref.numpy(), **TOL)


@pytest.mark.parametrize("name", sorted(SCENARIOS) + ["long"])
def test_split_schedule_matches_jax_kernel(name):
    """The same emulation against the JAX Pallas kernel in interpret
    mode."""
    cfg, (q, pk, pv, block, qpos) = _split_inputs(name)
    out, _ = _split_schedule(q, pk, pv, block, qpos, cfg["page_size"])
    ref = jax_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                    jnp.asarray(block), jnp.asarray(qpos),
                    page_size=cfg["page_size"], impl="pallas",
                    interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_long_context_reaches_the_split_edges():
    """The long scenario exercises what the split schedule must get
    right: many splits a row tile, split edges inside pages, the idle
    row 0 (one key), and splits that see no live key."""
    cfg, (q, pk, pv, block, qpos) = _split_inputs("long")
    ps = cfg["page_size"]
    rb, tiles, n, lpk, kpw, ck = _plan(cfg["b"], cfg["t"], cfg["hq"],
                                       cfg["hkv"], cfg["d"], ps,
                                       cfg["maxp"])
    assert (rb, n, lpk, kpw, ck) == (4, 8, 32, 1, 32)
    _, spans = _split_schedule(q, pk, pv, block, qpos, ps)
    edges = {e for (lo, hi) in spans.values() for e in (lo, hi) if hi > lo}
    assert any(e % ps for e in edges)
    assert spans[0, 0, 0, 0] == (0, 1) and qpos[0, 0] == 0
    assert any(lo == hi for lo, hi in spans.values())
    assert max(hi - lo for lo, hi in spans.values()) > ck

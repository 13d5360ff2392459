"""Fused paged decode attention — counterpart of ``deeplearning4j_tpu/helpers/paged_attention.py``.

Per-row causal attention of ``q`` [B, T, Hq, D] straight off the
flattened page pools ``pk``/``pv`` [P*page_size, Hkv, D] through the
int32 block table ``block`` [B, MAXP], never building the gathered
[B, MAXP*page_size, Hkv, D] view.  A key's global position is its
logical slot ``p * page_size + i``; a query row at ``q_positions[b, t]``
sees the keys at or below it, which also hides the trash page 0 and
unwritten slots.  GQA contracts the unexpanded kv heads.

- On a CUDA tensor ``paged_decode_attention`` launches the hand-written
  kernel ``csrc/paged_attention.cu`` (built with ``nvcc`` at first use,
  bound with ``ctypes``) or raises.  Nothing falls back.  The kernel
  splits each row's keys across the blocks of a thread-block cluster
  (flash-decoding) and merges their float32 partials through distributed
  shared memory in a fixed order, so its output is the same bits from
  call to call.
- On a CPU tensor it runs ``paged_attention_plain``, a port of the
  reference's ``_lax_paged``: a loop over the live pages with the same
  online softmax.  The kernel is held against it on the card.

``counts`` records kernel launches and plain-version calls, so a run can
show which of the two its decode path went through.

``set_paged_attention_mode("gather")`` routes
``SelfAttentionLayer._apply_paged`` through ``gather_pages`` +
``paged_attention`` instead: the oracle the kernel is compared with.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from deeplearning4j_tpu_torch.helpers import cuda_build

NEG_INF = -1e30
SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"

_VALID_MODES = ("fused", "gather")
_mode = "fused"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_launcher = None    # the library's C launcher, once ``build`` has loaded it


def set_paged_attention_mode(mode: str) -> None:
    """Select the paged decode path: ``"fused"`` (default — this module)
    or ``"gather"`` (the gather+softmax oracle)."""
    if mode not in _VALID_MODES:
        raise ValueError(f"paged attention mode {mode!r} not in "
                         f"{_VALID_MODES}")
    global _mode
    _mode = mode


def paged_attention_mode() -> str:
    return _mode


counts = cuda_build.Counts()


def _check_shapes(q, pk, pv, block, q_positions, page_size):
    if q.ndim != 4:
        raise ValueError(f"q must be [B, T, Hq, D]; got {tuple(q.shape)}")
    b, t, hq, d = q.shape
    if pk.ndim != 3 or pk.shape != pv.shape:
        raise ValueError(
            f"paged pools must be flattened [P*page_size, Hkv, D]; got "
            f"pk {tuple(pk.shape)}, pv {tuple(pv.shape)}")
    hkv = pk.shape[1]
    if pk.shape[2] != d:
        raise ValueError(f"pool head dim {pk.shape[2]} != q head dim {d}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if pk.shape[0] % page_size:
        raise ValueError(
            f"pool rows {pk.shape[0]} not a multiple of page_size "
            f"{page_size}")
    if block.ndim != 2 or block.shape[0] != b:
        raise ValueError(
            f"block table {tuple(block.shape)} does not match batch {b}")
    if tuple(q_positions.shape) != (b, t):
        raise ValueError(
            f"q_positions {tuple(q_positions.shape)} must be [B, T] = "
            f"{(b, t)}")
    return hkv, d


def paged_attention_plain(q, pk, pv, block, q_positions, page_size):
    """Plain PyTorch version (port of ``_lax_paged``): one
    [B, page_size, Hkv, D] page slab per iteration over the live pages,
    online softmax in float32.  A row that sees no key gives 0."""
    b, t, hq, d = q.shape
    hkv = pk.shape[1]
    g = hq // hkv
    maxp = block.shape[1]
    acc_dt = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    offs = torch.arange(page_size, device=dev)
    # [B, T, Hkv, G, D] — contract the UNEXPANDED kv heads (GQA)
    qg = q.reshape(b, t, hkv, g, d).to(acc_dt)
    qp = q_positions.to(torch.int64)
    m = torch.full((b, hkv, g, t), NEG_INF, dtype=acc_dt, device=dev)
    l = torch.zeros((b, hkv, g, t), dtype=acc_dt, device=dev)
    acc = torch.zeros((b, t, hkv, g, d), dtype=acc_dt, device=dev)
    blk = block.to(torch.int64)
    top = int(qp.max()) if qp.numel() else -1
    live = min(top // page_size + 1, maxp) if top >= 0 else 0
    for p in range(live):
        slots = blk[:, p, None] * page_size + offs[None]      # [B, ps]
        k = pk[slots].to(acc_dt)                              # [B, ps, Hkv, D]
        v = pv[slots].to(acc_dt)
        kpos = p * page_size + offs
        s = torch.einsum("bthgd,bkhd->bhgtk", qg, k) * scale
        keep = qp[:, None, None, :, None] >= kpos
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p_exp = torch.where(keep, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p_exp.sum(dim=-1)
        acc = (acc * alpha.permute(0, 3, 1, 2)[..., None]
               + torch.einsum("bhgtk,bkhd->bthgd", p_exp, v))
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))      # rows that see no key
    o = acc / safe.permute(0, 3, 1, 2)[..., None]
    return o.reshape(b, t, hq, d).to(q.dtype)


def build() -> cuda_build.Built:
    """Compile (at most once per source hash) and load the kernel's
    library, declaring the launcher's C signature."""
    global _launcher
    built = cuda_build.load_library(SOURCE)
    fn = built.lib.dl4j_paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    _launcher = fn
    return built


def _launch(q, pk, pv, block, q_positions, page_size, hkv, d):
    dev = q.device
    for name, x in (("pk", pk), ("pv", pv), ("block", block),
                    ("q_positions", q_positions)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if pk.dtype != q.dtype or pv.dtype != q.dtype:
        raise TypeError(f"pools ({pk.dtype}, {pv.dtype}) must match q "
                        f"({q.dtype})")
    if block.dtype != torch.int32 or q_positions.dtype != torch.int32:
        raise TypeError("block and q_positions must be int32")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"kernel takes a head dim that is a multiple of "
                         f"8 in [8, 256]; got {d}")
    for name, x in (("q", q), ("pk", pk), ("pv", pv), ("block", block),
                    ("q_positions", q_positions)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x in (("q", q), ("pk", pk), ("pv", pv)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, t, hq, _ = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if _launcher is None:
        build()
    fn = _launcher
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), block.data_ptr(),
                q_positions.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
                b, t, hq, hkv, d, page_size, block.shape[1],
                pk.shape[0] // page_size, 1.0 / (d ** 0.5), stream)
    if rc != 0:
        raise RuntimeError(f"paged decode attention kernel launch failed: "
                           f"CUDA error {rc}")
    counts.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, pk: torch.Tensor,
                           pv: torch.Tensor, block: torch.Tensor,
                           q_positions: torch.Tensor, *,
                           page_size: int) -> torch.Tensor:
    """See module docstring.  CUDA tensors launch the kernel (or raise);
    CPU tensors run the plain version."""
    hkv, d = _check_shapes(q, pk, pv, block, q_positions, page_size)
    if q.device.type == "cpu":
        counts.plain_calls += 1
        return paged_attention_plain(q, pk, pv, block, q_positions,
                                     page_size)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, pk, pv, block, q_positions, page_size, hkv, d)


class PagedAttentionHelper:
    """Discovery-seam wrapper: ``SelfAttentionLayer._apply_paged`` asks
    ``helpers.get_helper("paged_attention")`` and uses the gather oracle
    only when this helper is absent or the mode is ``"gather"``."""

    name = "PagedAttentionHelper"

    def supports(self, q, page_size: int) -> bool:
        return paged_attention_mode() == "fused"

    def attend(self, q, pk, pv, block, q_positions, *,
               page_size: int) -> torch.Tensor:
        return paged_decode_attention(q, pk, pv, block, q_positions,
                                      page_size=page_size)

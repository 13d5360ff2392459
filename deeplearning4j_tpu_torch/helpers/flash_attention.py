"""Flash attention — counterpart of ``deeplearning4j_tpu/helpers/flash_attention.py``.

softmax(q kᵀ / √D) v on [B, T, H, D] tensors (the layer layout), causal
or not, with an optional sliding-window band, and its gradient through a
``torch.autograd.Function`` (``_Flash``, the reference's ``_flash``
custom VJP): the forward saves (q, k, v, o, lse), the backward recomputes
the probabilities from lse.

- On CUDA tensors three hand-written kernels run (``csrc/flash_attention.cu``,
  built with ``nvcc`` at first use and bound with ``ctypes``): the forward
  (``_fwd_kernel``), dQ (``_dq_kernel``, q-major) and dK/dV
  (``_dkv_kernel``, k-major).  bfloat16 and float16 take the tensor
  cores: with D in {64, 128} all three on ``wgmma`` fed by TMA
  (``csrc/hopper.cuh``), with D in {16, 32} on ``mma.sync``; float32 and
  other head dims run on the CUDA cores.  ``kernel_path`` says which.
  On the wgmma route dQ also computes delta = rowsum(dO·O) from the tiles
  it holds and hands it to dK/dV; the other routes take it from the torch
  reduction ``_row_delta``.  Each launches or raises; nothing falls
  back.
- On CPU tensors the same ``autograd.Function`` runs the plain versions
  ``flash_attention_plain_fwd``/``flash_attention_plain_bwd``: a masked
  full softmax in float32 with the kernels' casts.  The kernels are held
  against them on the card.

The TPU version pads D to 128 lanes and needs T to tile by its blocks
(``pick_blocks``); the CUDA kernels take D as it is (a multiple of 8 up to
256) and mask the ragged tail themselves, so ``supports`` takes any T.

``fwd_counts``, ``dq_counts`` and ``dkv_counts`` record launches and
plain-version calls, so a run can show which path its attention took.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.helpers import cuda_build
from deeplearning4j_tpu_torch.nn.layers.attention import check_window

NEG_INF = -1e30
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KERNELS = {"fwd": 0, "dq": 1, "dkv": 2}
PATHS = ("cuda_cores", "mma_sync", "wgmma")   # dl4j_flash_path's answers
_MAP_ERROR = 10000      # kMapError in the source: a failed tensor-map encode
_lib = None     # the loaded library, once ``build`` has run

fwd_counts = cuda_build.Counts()
dq_counts = cuda_build.Counts()
dkv_counts = cuda_build.Counts()


def supports(q: torch.Tensor) -> bool:
    """What the kernels take: float32, bfloat16 or float16 [B, T, H, D]
    with D a multiple of 8 in [8, 256], any T >= 1.  float64 (gradient
    checks) runs on the layer's exact path with helpers disabled."""
    if q.ndim != 4 or q.dtype not in _DTYPE_CODES:
        return False
    d = q.shape[-1]
    return d % 8 == 0 and 8 <= d <= 256 and q.shape[1] >= 1


def _band(t: int, causal: bool, window: Optional[int], device):
    """[T, T] boolean keep-mask (query, key), or None when nothing is
    masked: ``qpos >= kpos`` and, with a window, ``kpos > qpos - window``."""
    if not causal:
        return None
    pos = torch.arange(t, device=device)
    keep = pos[:, None] >= pos[None, :]
    if window is not None:
        keep &= pos[None, :] > pos[:, None] - window
    return keep


def _acc(dtype):
    return torch.promote_types(dtype, torch.float32)


def _scores(q, k, causal, window):
    """Masked, scaled scores [B, H, T, T] in the accumulation type, and
    the keep-mask (or None)."""
    acc = _acc(q.dtype)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    keep = _band(q.shape[1], causal, window, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    return s, keep


def flash_attention_plain_fwd(q, k, v, causal: bool = False,
                              window: Optional[int] = None):
    """Plain version of the forward kernel: (o [B, T, H, D] in q's type,
    lse [B, H, T] float32).  p is rounded to v's type before p·v, every
    product accumulates in float32, as in the kernel."""
    check_window(causal, window)
    acc = _acc(q.dtype)
    s, keep = _scores(q, k, causal, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc), v.to(acc))
    return o.to(q.dtype), lse


def flash_attention_plain_bwd(q, k, v, o, lse, do, causal: bool = False,
                              window: Optional[int] = None):
    """Plain version of the dQ and dK/dV kernels: (dq, dk, dv) from p
    recomputed off ``lse``; delta = rowsum(do·o); ds rounded to q's type
    and p to do's type before their products, as in the kernels."""
    check_window(causal, window)
    acc = _acc(q.dtype)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s, keep = _scores(q, k, causal, window)
    p = torch.exp(s - lse.to(acc)[..., None])
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    do_a = do.to(acc)
    delta = (do_a * o.to(acc)).sum(-1).transpose(1, 2)          # [B, H, T]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(acc), do_a)
    dp = torch.einsum("bqhd,bkhd->bhqk", do_a, v.to(acc))
    ds = p * (dp - delta[..., None])
    ds = ds.to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc)) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# ------------------------------------------------------------------ kernels
def build() -> cuda_build.Built:
    """Compile (at most once per source hash) and load the kernels'
    library, declaring the launchers' C signatures."""
    global _lib
    built = cuda_build.load_library(SOURCE)
    lib = built.lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i] * 7 + [f, p]    # dtype, b, t, h, d, causal, window, scale, stream
    for name, n_ptr in (("dl4j_flash_fwd", 5), ("dl4j_flash_dq", 8),
                        ("dl4j_flash_dkv", 8)):
        fn = getattr(lib, name)
        fn.argtypes = [p] * n_ptr + tail
        fn.restype = i
    lib.dl4j_flash_path.argtypes = [i, i, i]
    lib.dl4j_flash_path.restype = i
    _lib = lib
    return built


def kernel_path(kernel: str, dtype: torch.dtype, d: int) -> str:
    """Which kernels a CUDA call of ``kernel`` ("fwd", "dq" or "dkv")
    takes for ``dtype`` and head dim ``d``, as the library's dispatch
    decides: "wgmma", "mma_sync" or "cuda_cores"."""
    if _lib is None:
        build()
    return PATHS[_lib.dl4j_flash_path(_KERNELS[kernel], _DTYPE_CODES[dtype],
                                      d)]


def _validate(name_tensors, dtype, device):
    for name, x in name_tensors:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, q on {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {dtype}: the kernels "
                            "take one type")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_kernel_args(q, k, v, extra=()):
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels run on CUDA tensors, got "
                         f"{q.device}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, T, H, D] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernels take float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    b, t, h, d = q.shape
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"the flash kernels take a head dim that is a "
                         f"multiple of 8 in [8, 256]; got {d}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernels' grid (65535)")
    _validate((("q", q), ("k", k), ("v", v)) + tuple(extra), q.dtype,
              q.device)
    return b, t, h, d


def _stats_check(name, x, b, h, t, device):
    if tuple(x.shape) != (b, h, t) or x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 [B, H, T] = {(b, h, t)}; "
                         f"got {x.dtype} {tuple(x.shape)}")
    _validate(((name, x),), torch.float32, device)


def _tail(q, b, t, h, d, causal, window):
    return (_DTYPE_CODES[q.dtype], b, t, h, d, int(bool(causal)),
            int(window or 0), 1.0 / (d ** 0.5))


def _raise_on(rc, what):
    if rc >= _MAP_ERROR:
        raise RuntimeError(f"flash attention {what}: TMA tensor-map encode "
                           f"failed (CUresult {rc - _MAP_ERROR})")
    if rc != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"CUDA error {rc}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_fwd(q, k, v, causal, window):
    b, t, h, d = _check_kernel_args(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if _lib is None:
        build()
    with torch.cuda.device(q.device):
        rc = _lib.dl4j_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *_tail(q, b, t, h, d, causal, window),
            _stream(q.device))
    _raise_on(rc, "forward")
    fwd_counts.launches += 1
    return o, lse


def _launch_dq(q, k, v, do, o, lse, causal, window):
    """(dq, delta): on the wgmma route the kernel writes delta itself;
    on the others ``_row_delta`` computes it first and the kernel reads
    it."""
    b, t, h, d = _check_kernel_args(q, k, v, (("do", do), ("o", o)))
    for name, x in (("do", do), ("o", o)):
        if x.shape != q.shape:
            raise ValueError(f"{name} {tuple(x.shape)} must match q "
                             f"{tuple(q.shape)}")
    _stats_check("lse", lse, b, h, t, q.device)
    if kernel_path("dq", q.dtype, d) == "wgmma":
        delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    else:
        delta = _row_delta(o, do)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib.dl4j_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            o.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_tail(q, b, t, h, d, causal, window), _stream(q.device))
    _raise_on(rc, "dQ")
    dq_counts.launches += 1
    return dq, delta


def _launch_dkv(q, k, v, do, lse, delta, causal, window):
    b, t, h, d = _check_kernel_args(q, k, v, (("do", do),))
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} must match q {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        _stats_check(name, x, b, h, t, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if _lib is None:
        build()
    with torch.cuda.device(q.device):
        rc = _lib.dl4j_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_tail(q, b, t, h, d, causal, window), _stream(q.device))
    _raise_on(rc, "dK/dV")
    dkv_counts.launches += 1
    return dk, dv


def _row_delta(o, do):
    """delta = rowsum(do·o) as float32 [B, H, T]: a torch reduction, as
    the reference leaves it to XLA (labelled ``flash_row_delta`` in a
    profile)."""
    with torch.profiler.record_function("flash_row_delta"):
        return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_fwd(q, k, v, *, causal: bool = False,
              window: Optional[int] = None) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """(o, lse): the forward kernel on CUDA tensors, its plain version on
    CPU tensors."""
    check_window(causal, window)
    if q.device.type == "cpu":
        fwd_counts.plain_calls += 1
        return flash_attention_plain_fwd(q, k, v, causal, window)
    return _launch_fwd(q, k, v, causal, window)


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = False,
              window: Optional[int] = None):
    """(dq, dk, dv): the dQ and dK/dV kernels on CUDA tensors, the plain
    backward on CPU tensors."""
    check_window(causal, window)
    if q.device.type == "cpu":
        dq_counts.plain_calls += 1
        dkv_counts.plain_calls += 1
        return flash_attention_plain_bwd(q, k, v, o, lse, do, causal, window)
    dq, delta = _launch_dq(q, k, v, do, o, lse, causal, window)
    dk, dv = _launch_dkv(q, k, v, do, lse, delta, causal, window)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: the forward saves
    (q, k, v, o, lse); the backward runs dQ and dK/dV.  ``causal`` and
    ``window`` are not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    window: Optional[int] = None) -> torch.Tensor:
    """Fused attention on [B, T, H, D] tensors (q, k, v of one shape: GQA
    heads are expanded by the caller).  The softmax scale is 1/√D."""
    check_window(causal, window)
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal, window)


class FlashAttentionHelper:
    """Discovery-seam wrapper: ``SelfAttentionLayer.apply`` asks
    ``helpers.get_helper("attention")`` and uses this when ``supports``
    holds.  On the card that is the kernels; on the CPU their plain
    versions through the same ``autograd.Function``."""

    name = "FlashAttentionHelper"

    def supports(self, q: torch.Tensor) -> bool:
        return supports(q)

    def attend(self, q, k, v, *, causal: bool = False,
               window: Optional[int] = None) -> torch.Tensor:
        return flash_attention(q, k, v, causal=causal, window=window)

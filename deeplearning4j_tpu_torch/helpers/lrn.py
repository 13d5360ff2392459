"""Local response normalization — counterpart of the LRN half of
``deeplearning4j_tpu/helpers/pallas_ops.py`` (``lrn`` and its custom VJP),
on a channel-contiguous ``[rows, C]`` view of any rank:

    s = k + alpha * Σ_{|w| <= n/2} x[c + w]²   (channels outside [0, C) are 0)
    y = x · s^-β
    dx = g · s^-β − 2αβ · x · Σ_{|w| <= n/2} t[c + w],   t = g · x · s^(−β−1)

The window spans the offsets −⌊n/2⌋ … ⌊n/2⌋, so an even n sums n + 1
channels, as the Pallas kernel does (the JAX layer's ``reduce_window``
path fails on even n).  alpha is not divided by n (DL4J's semantics).

- On CUDA tensors both directions are the hand-written kernels
  ``csrc/lrn.cu`` (built with ``nvcc`` at first use, bound with
  ``ctypes``), on one of two routes that ``route`` picks from the shape,
  type, n and alignment:
  - ``"vector"`` (AlexNet's shapes): one lane a 16-byte vector of a row,
    the halo channels from the neighbour lanes by warp shuffles, the
    window sums in registers, one pass with no shared memory;
  - ``"staged"`` (everything else): a block stages a tile of rows (whole
    rows where C fits, channel tiles with a halo where it does not) in
    shared memory and takes every window sum there.
  float32 arithmetic whatever x's type, outputs in x's type, no size cap.
  They launch or raise; nothing falls back.
- On CPU tensors the plain versions below run instead, through the same
  ``autograd.Function`` (``_LRN``).

The backward recomputes s from x; the forward saves only x (the Pallas
VJP saves s as well, a storage choice and not a semantic).

``fwd_counts`` and ``bwd_counts`` record kernel launches and
plain-version calls.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.helpers import cost, cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "lrn.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TILE = 2048               # elements of a block's tile (staged route)
MAX_ROWS = 256            # rows of a block's tile (staged route)
# the vector route's warp schedule, as in csrc/lrn.cu: lane l of warp tile
# t holds vector t * TILE_VECTORS + l - 1 and stores it for l in 1..30
LANES = 32
TILE_VECTORS = LANES - 2
FWD_TILES, BWD_TILES = 1, 1     # tiles a warp takes, loads first
MAX_VECTORS = 2 ** 31 - 256
_launchers = {}

fwd_counts = cuda_build.Counts()
bwd_counts = cuda_build.Counts()


def supports(x: torch.Tensor) -> bool:
    """What the kernels take: float32, bfloat16 or float16 with at least
    one element.  ``LocalResponseNormalization`` raises on a CUDA tensor
    outside this; float64 (gradient checks) runs with helpers disabled."""
    return x.dtype in _DTYPE_CODES and x.ndim >= 1 and x.numel() > 0


# ------------------------------------------------------------ plain versions
def window_sum(v: torch.Tensor, half: int) -> torch.Tensor:
    """Σ_{|w| <= half} v[..., c + w] with zeros past either edge, summed
    from offset −half up, as the kernels sum."""
    c = v.shape[-1]
    padded = F.pad(v, (half, half))
    out = padded[..., 0:c]
    for d in range(1, 2 * half + 1):
        out = out + padded[..., d:d + c]
    return out


def _acc(x):
    return torch.promote_types(x.dtype, torch.float32)


def _s(xf, k, n, alpha):
    return k + alpha * window_sum(xf * xf, n // 2)


def lrn_fwd_plain(x, k: float, n: int, alpha: float, beta: float):
    """Plain version of the forward kernel on [rows, C]: float32
    arithmetic, y in x's type."""
    xf = x.to(_acc(x))
    return (xf * _s(xf, k, n, alpha).pow(-beta)).to(x.dtype)


def lrn_bwd_plain(x, g, k: float, n: int, alpha: float, beta: float):
    """Plain version of the backward kernel on [rows, C]: s recomputed
    from x, float32 arithmetic, dx in x's type."""
    acc = _acc(x)
    xf, gf = x.to(acc), g.to(acc)
    s = _s(xf, k, n, alpha)
    pw = s.pow(-beta)
    t = gf * xf * (pw / s)
    dx = gf * pw - (2.0 * alpha * beta) * xf * window_sum(t, n // 2)
    return dx.to(x.dtype)


# ---------------------------------------------------------------- kernels
def build() -> cuda_build.Built:
    """Compile (at most once per source hash) and load the kernels."""
    built = cuda_build.load_library(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    staged = [i] * 6 + [f] * 3 + [i, p]  # dtype..half, k, alpha, beta, vec
    vector = [i] * 4 + [f] * 3 + [p]     # dtype..half, k, alpha, beta
    for name, n_ptr, tail in (("dl4j_lrn_fwd", 2, staged),
                              ("dl4j_lrn_bwd", 3, staged),
                              ("dl4j_lrn_fwd_vec", 2, vector),
                              ("dl4j_lrn_bwd_vec", 3, vector)):
        fn = getattr(built.lib, name)
        fn.argtypes = [p] * n_ptr + tail
        fn.restype = i
        _launchers[name] = fn
    return built


def route(x: torch.Tensor, n: int, *others: torch.Tensor) -> str:
    """The route a call on x [rows, C] takes, with ``others`` the call's
    other [rows, C] tensors (g, the output): ``"vector"`` where C is a
    whole number of 16-byte vectors of V channels and at most ``TILE``,
    2·⌊n/2⌋ <= V (an edge lane's inner t needs x no further in), every
    pointer is 16-byte aligned and there are at most ``MAX_VECTORS``
    vectors; else ``"staged"``."""
    rows, c = x.shape
    v = 16 // x.element_size()
    if (c % v == 0 and c <= TILE and 2 * (n // 2) <= v
            and rows * c // v <= MAX_VECTORS
            and all(t.data_ptr() % 16 == 0 for t in (x,) + others)):
        return "vector"
    return "staged"


def tiling(c: int) -> Tuple[int, int]:
    """(rows, channels) of a block's tile: whole rows where C fits in
    ``TILE`` (at most ``MAX_ROWS`` of them: narrow rows carry padded
    halos), else channel tiles of ``TILE`` with a single row."""
    ct = min(c, TILE)
    return max(1, min(TILE // ct, MAX_ROWS)), ct


def _check(name, t, x):
    if t.device != x.device:
        raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if t.dtype != x.dtype:
        raise TypeError(f"{name} must be {x.dtype}, got {t.dtype}")
    if t.shape != x.shape:
        raise ValueError(f"{name} must be {tuple(x.shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name, counts, x, g, k, n, alpha, beta):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the LRN kernels take float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"x must be [rows, C]; got {tuple(x.shape)}")
    rows, c = x.shape
    if rows < 1 or c < 1 or rows >= 2 ** 31:
        raise ValueError(f"x must have 1 to 2^31 - 1 rows and a channel; "
                         f"got {(rows, c)}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    tensors = [("x", x)] + ([("g", g)] if g is not None else [])
    for tname, t in tensors:
        _check(tname, t, x)
    out = torch.empty_like(x)
    ins = [t for _, t in tensors]
    if not _launchers:
        build()
    ptrs = [t.data_ptr() for t in ins] + [out.data_ptr()]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route(x, n, *ins[1:], out) == "vector":
            rc = _launchers[name + "_vec"](
                *ptrs, _DTYPE_CODES[x.dtype], rows, c, n // 2, float(k),
                float(alpha), float(beta), stream)
        else:
            rpb, ct = tiling(c)
            vec = int(all(p % 16 == 0 for p in ptrs))
            rc = _launchers[name](
                *ptrs, _DTYPE_CODES[x.dtype], rows, c, rpb, ct, n // 2,
                float(k), float(alpha), float(beta), vec, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    counts.launches += 1
    return out


def _use_kernel(x, counts):
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor, counted); anything else raises."""
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def work(elems: int, esz: int, n: int, kind: str):
    """(operations, bytes) of a call on ``elems`` elements of ``esz``
    bytes (``kind``: ``fwd`` or ``bwd``): each tensor read or written
    once, and the kernels' float32 operations — the window's 2n+1
    products and sums, the power and the scaling: 2(2h+1) + 6 forward,
    3(2h+1) + 14 backward."""
    win = 2 * (n // 2) + 1
    if kind == "fwd":
        return elems * (2 * win + 6), 2 * elems * esz
    return elems * (3 * win + 14), 3 * elems * esz


def lrn_fwd_2d(x, k: float, n: int, alpha: float, beta: float):
    """y on [rows, C]: the kernel on CUDA tensors, its plain version on
    CPU tensors (no autograd)."""
    with cost.kernel_cost(lambda: work(x.numel(), x.element_size(), n,
                                       "fwd")):
        if _use_kernel(x, fwd_counts):
            return _launch("dl4j_lrn_fwd", fwd_counts, x, None, k, n,
                           alpha, beta)
        return lrn_fwd_plain(x, k, n, alpha, beta)


def lrn_bwd_2d(x, g, k: float, n: int, alpha: float, beta: float):
    """dx on [rows, C], as ``lrn_fwd_2d``."""
    with cost.kernel_cost(lambda: work(x.numel(), x.element_size(), n,
                                       "bwd")):
        if _use_kernel(x, bwd_counts):
            return _launch("dl4j_lrn_bwd", bwd_counts, x, g, k, n, alpha,
                           beta)
        return lrn_bwd_plain(x, g, k, n, alpha, beta)


class _LRN(torch.autograd.Function):
    """The reference's ``lrn`` custom VJP: the forward kernel, then the
    backward kernel from the saved x (s is recomputed)."""

    @staticmethod
    def forward(ctx, x, k, n, alpha, beta):
        ctx.save_for_backward(x)
        ctx.args = (k, n, alpha, beta)
        return lrn_fwd_2d(x, k, n, alpha, beta)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lrn_bwd_2d(x, g.contiguous(), *ctx.args),
                None, None, None, None)


def lrn(x: torch.Tensor, k: float, n: int, alpha: float,
        beta: float) -> torch.Tensor:
    """LRN across the trailing (channel) axis of ``x``, any rank, with its
    gradient; a contiguous x is only viewed as [rows, C], never copied."""
    shape = x.shape
    y = _LRN.apply(x.contiguous().view(-1, shape[-1]), float(k), int(n),
                   float(alpha), float(beta))
    return y.view(shape)


class LRNHelper:
    """Discovery-seam wrapper (kind ``"lrn"``, the JAX package's
    ``PallasLRNHelper``): ``LocalResponseNormalization`` routes every call
    through it when ``supports`` holds, with no size cap."""

    name = "LRNHelper"

    def supports(self, x: torch.Tensor) -> bool:
        return supports(x)

    def apply(self, x, k, n, alpha, beta):
        return lrn(x, k, n, alpha, beta)

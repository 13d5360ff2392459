"""Fused dropout + residual + LayerNorm — counterpart of
``deeplearning4j_tpu/helpers/fused_epilogue.py``.

    out = dropout(LayerNorm_affine(res + h))

on [..., C] tensors; ``res=None`` is the prologue form
``dropout(LayerNorm(h))`` that a pre-norm ``ResidualBlock`` opens with
(its LayerNorm and the next sublayer's input dropout).

- On CUDA tensors the forward is the hand-written kernel
  ``csrc/fused_epilogue.cu`` (built with ``nvcc`` at first use, bound with
  ``ctypes``): one pass over each row, moments in float32, no size cap.
  It launches or raises; nothing falls back.
- On CPU tensors ``dropout_residual_norm_plain`` runs instead, through the
  same ``autograd.Function``.

The keep-mask is drawn outside the kernel with ``backend.rng.bernoulli``,
the draw ``Layer.maybe_dropout`` makes, so the fused and unfused paths
drop the same elements for the same key; the kernel only applies
``mask * y / keep``.  The backward is torch ops from recomputed row
moments (the standard LayerNorm adjoint), as the reference's ``_drn_bwd``
is plain jnp.

``counts`` records kernel launches and plain-version calls.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.helpers import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_epilogue.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VECTORS = 128 * 16   # 16-byte vectors a row may hold (kernel's K <= 16)
_launcher = None

counts = cuda_build.Counts()


def supports(x: torch.Tensor) -> bool:
    """What the kernel takes: float32 or bfloat16 rows whose width is a
    whole number of 16-byte vectors, up to 2048 of them (C <= 16384 in
    bfloat16, 8192 in float32).  float64 stays on the exact path."""
    if x.dtype not in _DTYPE_CODES or x.ndim < 1:
        return False
    vec = 16 // x.element_size()
    c = x.shape[-1]
    return c >= 1 and c % vec == 0 and c // vec <= _MAX_VECTORS


def dropout_residual_norm_plain(h, res, gamma, beta, mask, eps: float,
                                keep: float) -> torch.Tensor:
    """Plain version of the kernel on [rows, C]: the residual add and the
    LayerNorm in float32, then ``where(mask, y / keep, 0)``, in h's type.
    On float32 inputs this is exactly ``LayerNorm.apply`` followed by
    ``Layer.maybe_dropout`` (the same ops), so the fused and unfused paths
    agree bit for bit on the CPU."""
    x = h.float() if h.dtype != torch.float64 else h
    if res is not None:
        x = x + res.to(x.dtype)
    y = F.layer_norm(x, (x.shape[-1],), gamma.to(x.dtype), beta.to(x.dtype),
                     eps)
    if mask is not None:
        y = torch.where(mask, y / keep, torch.zeros_like(y))
    return y.to(h.dtype)


def build() -> cuda_build.Built:
    """Compile (at most once per source hash) and load the kernel."""
    global _launcher
    built = cuda_build.load_library(SOURCE)
    fn = built.lib.dl4j_dropout_residual_norm
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _launcher = fn
    return built


def _launch(h, res, gamma, beta, mask, eps, keep):
    dev = h.device
    if h.ndim != 2:
        raise ValueError(f"h must be [rows, C]; got {tuple(h.shape)}")
    rows, c = h.shape
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{h.dtype}")
    if not supports(h):
        raise ValueError(f"the kernel takes C a multiple of "
                         f"{16 // h.element_size()} up to "
                         f"{_MAX_VECTORS * 16 // h.element_size()}; got {c}")
    named = [("h", h, h.dtype, (rows, c)), ("gamma", gamma, h.dtype, (c,)),
             ("beta", beta, h.dtype, (c,))]
    if res is not None:
        named.append(("res", res, h.dtype, (rows, c)))
    if mask is not None:
        named.append(("mask", mask, torch.bool, (rows, c)))
    for name, x, dtype, shape in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, h on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "mask" and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not keep > 0.0:
        raise ValueError(f"keep = 1 - rate must be > 0, got {keep}")
    out = torch.empty_like(h)
    if rows == 0:
        return out
    if _launcher is None:
        build()
    with torch.cuda.device(dev):
        rc = _launcher(
            h.data_ptr(), 0 if res is None else res.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(),
            0 if mask is None else mask.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[h.dtype], rows, c, float(eps), float(keep),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dropout/residual/norm kernel launch failed: "
                           f"CUDA error {rc}")
    counts.launches += 1
    return out


def dropout_residual_norm_2d(h, res, gamma, beta, mask, eps: float,
                             keep: float) -> torch.Tensor:
    """The kernel on CUDA tensors, its plain version on CPU tensors, both
    on [rows, C] (no autograd)."""
    if h.device.type == "cpu":
        counts.plain_calls += 1
        return dropout_residual_norm_plain(h, res, gamma, beta, mask, eps,
                                           keep)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    return _launch(h, res, gamma, beta, mask, eps, keep)


class _DropResNorm(torch.autograd.Function):
    """The reference's ``_drn`` custom VJP: saves (h, res, gamma, mask);
    the backward is the LayerNorm adjoint from recomputed moments, with
    the mask-scale folded into the incoming gradient."""

    @staticmethod
    def forward(ctx, h, res, gamma, beta, mask, eps, keep):
        out = dropout_residual_norm_2d(h, res, gamma, beta, mask, eps, keep)
        ctx.save_for_backward(h, res, gamma, mask)
        ctx.eps, ctx.keep = eps, keep
        return out

    @staticmethod
    def backward(ctx, g):
        h, res, gamma, mask = ctx.saved_tensors
        acc = torch.promote_types(h.dtype, torch.float32)
        x = h.to(acc)
        if res is not None:
            x = x + res.to(acc)
        mu = x.mean(dim=1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
        rstd = torch.rsqrt(var + ctx.eps)
        xhat = (x - mu) * rstd
        g32 = g.to(acc)
        if mask is not None:
            g32 = g32 * mask.to(acc) * (1.0 / ctx.keep)
        dgamma = (g32 * xhat).sum(dim=0).to(gamma.dtype)
        dbeta = g32.sum(dim=0).to(gamma.dtype)
        dxhat = g32 * gamma.to(acc)
        dx = rstd * (dxhat - dxhat.mean(dim=1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(dim=1, keepdim=True))
        dres = dx.to(res.dtype) if res is not None else None
        return dx.to(h.dtype), dres, dgamma, dbeta, None, None, None


def dropout_residual_norm(h: torch.Tensor, res: Optional[torch.Tensor],
                          gamma: torch.Tensor, beta: torch.Tensor, *,
                          eps: float = 1e-5, rate: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          train: bool = False,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``dropout(LayerNorm_affine(res + h))`` on [..., C]; ``res=None`` is
    the prologue form.  Dropout applies when ``mask`` is given (nonzero
    keeps), or when ``train`` and ``rate > 0`` (the mask is then drawn on
    h's device from ``generator``, as ``Layer.maybe_dropout`` draws it)."""
    shape = h.shape
    c = shape[-1]
    keep = 1.0 - rate
    if mask is None and train and rate > 0.0:
        if generator is None:
            raise ValueError(
                "dropout_residual_norm: rate > 0 at train time requires a "
                "generator (or an explicit mask)")
        mask = rng_mod.bernoulli(generator, keep, shape, h.device)
    m2 = None if mask is None else (mask != 0).reshape(-1, c).contiguous()
    r2 = None if res is None else res.reshape(-1, c).contiguous()
    out = _DropResNorm.apply(h.reshape(-1, c).contiguous(), r2,
                             gamma.to(h.dtype).contiguous(),
                             beta.to(h.dtype).contiguous(), m2, float(eps),
                             float(keep))
    return out.reshape(shape)


class FusedEpilogueHelper:
    """Discovery-seam wrapper (kind ``"epilogue"``): ``ResidualBlock``
    routes its leading LayerNorm and the next sublayer's input dropout
    through ``prologue`` when ``supports`` holds."""

    name = "FusedEpilogueHelper"

    def supports(self, x: torch.Tensor) -> bool:
        return supports(x)

    def prologue(self, x, gamma, beta, *, eps, rate=0.0, generator=None,
                 train=False):
        return dropout_residual_norm(x, None, gamma, beta, eps=eps,
                                     rate=rate, generator=generator,
                                     train=train)

    def epilogue(self, h, resid, gamma, beta, *, eps, rate=0.0,
                 generator=None, train=False, mask=None):
        return dropout_residual_norm(h, resid, gamma, beta, eps=eps,
                                     rate=rate, generator=generator,
                                     train=train, mask=mask)

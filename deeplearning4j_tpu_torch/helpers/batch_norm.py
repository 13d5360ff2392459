"""BatchNorm — counterpart of the BatchNorm half of
``deeplearning4j_tpu/helpers/pallas_ops.py``: training forward
(``bn_training``), its backward, and inference (``bn_inference``), on a
channel-contiguous ``[rows, C]`` view of any rank.

- On CUDA tensors each is the hand-written kernel
  ``csrc/batch_norm.cu`` (built with ``nvcc`` at first use, bound with
  ``ctypes``): gridded per-channel reductions with float32 partials merged
  in a fixed order, then one elementwise pass on a grid of channel slices
  by row chunks (``elementwise_grid``).  gamma and beta are read in their
  own type (float32, bfloat16 or float16), so no call casts them.  No size
  cap and no rank gate, unlike the JAX package (a single VMEM block below
  2^20 elements, training only at rank 2).  They launch or raise; nothing
  falls back.
- On CPU tensors the plain versions below run instead, through the same
  ``autograd.Function``s.

Every sum is float32 whatever x's type, and the outputs are in x's type;
the moments come back in float32 for the running-stat update and carry
no gradient.  The training backward recomputes x̂ from x and the saved
float32 mean and inv.  The inference backward is torch ops, the
reference's analytic ``_bn_inference_bwd``.

``inference_counts``, ``train_fwd_counts`` and ``train_bwd_counts``
record kernel launches (one per wrapper call, whatever number of CUDA
kernels the call runs) and plain-version calls.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.helpers import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "batch_norm.cu"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_CHANNEL_TILE = 32        # channels a reduction block covers (csrc kTx)
_ROW_LANES = 8            # rows it walks at once (csrc kTy)
_BLOCKS_PER_SM = 8        # reduction blocks to aim for on each SM
_EW_THREADS = 256         # threads of an elementwise block (csrc kThreads)
_EW_THREADS_PER_SM = 1024  # elementwise threads to aim for on each SM
_EW_MIN_ROWS = 8          # rows a thread walks at least (csrc unrolls 4)
_launchers: Dict[str, object] = {}
_sms: Dict[int, int] = {}

inference_counts = cuda_build.Counts()
train_fwd_counts = cuda_build.Counts()
train_bwd_counts = cuda_build.Counts()


def supports(x: torch.Tensor) -> bool:
    """What the kernels take: float32, bfloat16 or float16, at least one
    row and one channel.  ``BatchNormalization`` raises on a CUDA tensor
    outside this; float64 (gradient checks) runs with helpers disabled."""
    return x.dtype in _DTYPE_CODES and x.ndim >= 2 and x.numel() > 0


# ------------------------------------------------------------ plain versions
def _acc(x):
    return torch.promote_types(x.dtype, torch.float32)


def bn_inference_plain(x, mean, var, gamma, beta, eps: float):
    """Plain version of the inference kernel on [rows, C]:
    ``(x - mean) * (gamma * rsqrt(var + eps)) + beta`` in float32, in x's
    type."""
    acc = _acc(x)
    scale = gamma.to(acc) * torch.rsqrt(var.to(acc) + eps)
    return ((x.to(acc) - mean.to(acc)) * scale + beta.to(acc)).to(x.dtype)


def bn_train_fwd_plain(x, gamma, beta, eps: float):
    """Plain version of the training forward on [rows, C]: (y in x's type,
    mean, biased var, inv = rsqrt(var + eps)), the moments in float32."""
    xf = x.to(_acc(x))
    mean = xf.mean(dim=0)
    var = ((xf - mean) ** 2).mean(dim=0)
    inv = torch.rsqrt(var + eps)
    y = (xf - mean) * (gamma.to(xf.dtype) * inv) + beta.to(xf.dtype)
    return y.to(x.dtype), mean, var, inv


def bn_train_bwd_plain(x, g, gamma, mean, inv):
    """Plain version of the training backward on [rows, C]: (dx in x's
    type, dgamma = Σ g·x̂, dbeta = Σ g in float32), x̂ = (x - mean)·inv."""
    acc = _acc(x)
    m = x.shape[0]
    xhat = (x.to(acc) - mean) * inv
    gf = g.to(acc)
    sum_g = gf.sum(dim=0)
    sum_gx = (gf * xhat).sum(dim=0)
    dx = (gamma.to(acc) * inv / m) * (m * gf - sum_g - xhat * sum_gx)
    return dx.to(x.dtype), sum_gx, sum_g


# ---------------------------------------------------------------- kernels
def build() -> cuda_build.Built:
    """Compile (at most once per source hash) and load the kernels."""
    built = cuda_build.load_library(SOURCE)
    lib, p, i, f = built.lib, ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    grid = [i] * 4       # vec, bx, by, rows per chunk of the elementwise
    sig = {
        "dl4j_bn_train_fwd": [p] * 6 + [i, i, ll, i, i, f] + grid + [p],
        "dl4j_bn_train_bwd": [p] * 8 + [i, i, ll, i, i] + grid + [p],
        "dl4j_bn_inference": [p] * 6 + [i, i, ll, i, f] + grid + [p],
    }
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _launchers[name] = fn
    return built


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def chunking(m: int, c: int, sms: int) -> Tuple[int, int]:
    """(rows per chunk, chunks) of the reduction grid: about
    ``_BLOCKS_PER_SM`` blocks of (chunk, 32 channels) on each SM, at least
    eight rows per row lane."""
    tiles = -(-c // _CHANNEL_TILE)
    want = max(1, _BLOCKS_PER_SM * sms // tiles)
    rpc = max(8 * _ROW_LANES, -(-m // want))
    rpc = -(-rpc // _ROW_LANES) * _ROW_LANES
    return rpc, -(-m // rpc)


def elementwise_grid(m: int, c: int, vec: int,
                     sms: int) -> Tuple[int, int, int, int]:
    """(bx, by, rows per chunk, chunks) of the elementwise pass over
    ``vec``-channel vectors: a block of at most ``_EW_THREADS`` threads is
    ``bx`` vector columns (one channel slice; C / vec split into as few
    slices as fit) by ``by`` rows; row chunks give about
    ``_EW_THREADS_PER_SM`` threads on each SM (4 blocks of 256; more of a
    ragged C's narrower blocks), each thread walking at least
    ``_EW_MIN_ROWS`` rows."""
    cols = c // vec
    slices = -(-cols // _EW_THREADS)
    bx = -(-cols // slices)
    by = max(1, _EW_THREADS // bx)
    want = max(1, _EW_THREADS_PER_SM * sms // (slices * bx * by))
    rpc = max(by * _EW_MIN_ROWS, -(-m // want))
    rpc = -(-rpc // by) * by
    return bx, by, rpc, -(-m // rpc)


def _ew_args(x, *ts):
    """The elementwise grid's launch arguments (vec, bx, by, rows per
    chunk) for x [rows, C] and the other [rows, C] tensors of a call:
    16-byte vectors when every row is whole vectors and the tensors are
    16-byte aligned, else the scalar path (vec 1)."""
    m, c = x.shape
    vec = 16 // x.element_size()
    if c % vec or any(t.data_ptr() % 16 for t in (x,) + ts):
        vec = 1
    bx, by, rpc, _ = elementwise_grid(m, c, vec, _sm_count(x.device))
    return vec, bx, by, rpc


def _check_2d(name, t, dev, dtype, shape):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_AFFINE = ("gamma", "beta")   # per-channel tensors read in their own type


def _prepare(x, **named):
    """Validate x [rows, C] (and tensors of its shape or of [C]) for a
    launch.  gamma and beta come back as they are (float32, bfloat16 or
    float16, one type for both); the running stats, mean and inv as
    contiguous float32 (a no-op for the float32 tensors the layer
    keeps)."""
    dev = x.device
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernels take float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"x must be [rows, C]; got {tuple(x.shape)}")
    m, c = x.shape
    if m < 1 or c < 1:
        raise ValueError(f"x must have a row and a channel; got {(m, c)}")
    _check_2d("x", x, dev, x.dtype, (m, c))
    out = {}
    for name, t in named.items():
        if t.ndim == 2:
            _check_2d(name, t, dev, x.dtype, (m, c))
            out[name] = t
        else:
            if not t.is_floating_point():
                raise TypeError(f"{name} must be floating, got {t.dtype}")
            _check_2d(name, t, dev, None, (c,))
            if name in _AFFINE:
                if t.dtype not in _DTYPE_CODES:
                    raise TypeError(f"{name} must be float32, bfloat16 or "
                                    f"float16, got {t.dtype}")
                out[name] = t
            else:
                out[name] = t.float().contiguous()
    affine = {out[n].dtype for n in _AFFINE if n in out}
    if len(affine) > 1:
        raise TypeError(f"gamma and beta must share one type, got "
                        f"{sorted(map(str, affine))}")
    return m, c, out


def _adt(t) -> int:
    """The dtype code of the affine tensors in ``_prepare``'s output."""
    return _DTYPE_CODES[t["gamma"].dtype]


def _run(name, counts, *args):
    if not _launchers:
        build()
    rc = _launchers[name](*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    counts.launches += 1


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_train_fwd(x, gamma, beta, eps):
    m, c, t = _prepare(x, gamma=gamma, beta=beta)
    dev = x.device
    sms = _sm_count(dev)
    rpc, n_chunks = chunking(m, c, sms)
    y = torch.empty_like(x)
    stats = torch.empty((5, c), dtype=torch.float32, device=dev)
    scratch = torch.empty((2, n_chunks, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run("dl4j_bn_train_fwd", train_fwd_counts, x.data_ptr(),
             t["gamma"].data_ptr(), t["beta"].data_ptr(), y.data_ptr(),
             stats.data_ptr(), scratch.data_ptr(), _DTYPE_CODES[x.dtype],
             _adt(t), m, c, rpc, float(eps), *_ew_args(x, y), _stream(dev))
    return y, stats[0], stats[1], stats[2]


def _launch_train_bwd(x, g, gamma, mean, inv):
    m, c, t = _prepare(x, g=g, gamma=gamma, mean=mean, inv=inv)
    dev = x.device
    sms = _sm_count(dev)
    rpc, n_chunks = chunking(m, c, sms)
    dx = torch.empty_like(x)
    dgb = torch.empty((2, c), dtype=torch.float32, device=dev)
    scratch = torch.empty(2 * n_chunks * c + 4 * c, dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        _run("dl4j_bn_train_bwd", train_bwd_counts, x.data_ptr(),
             g.data_ptr(), t["gamma"].data_ptr(), t["mean"].data_ptr(),
             t["inv"].data_ptr(), dx.data_ptr(), dgb.data_ptr(),
             scratch.data_ptr(), _DTYPE_CODES[x.dtype], _adt(t), m, c, rpc,
             *_ew_args(x, g, dx), _stream(dev))
    return dx, dgb[0], dgb[1]


def _launch_inference(x, mean, var, gamma, beta, eps):
    m, c, t = _prepare(x, mean=mean, var=var, gamma=gamma, beta=beta)
    dev = x.device
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        _run("dl4j_bn_inference", inference_counts, x.data_ptr(),
             t["mean"].data_ptr(), t["var"].data_ptr(),
             t["gamma"].data_ptr(), t["beta"].data_ptr(), y.data_ptr(),
             _DTYPE_CODES[x.dtype], _adt(t), m, c, float(eps),
             *_ew_args(x, y), _stream(dev))
    return y


def _route(x, counts):
    """True for the kernel (CUDA tensor), False for the plain version (CPU
    tensor, counted); anything else raises."""
    if x.device.type == "cpu":
        counts.plain_calls += 1
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def bn_train_fwd_2d(x, gamma, beta, eps: float):
    """(y, mean, var, inv) on [rows, C]: the kernel on CUDA tensors, its
    plain version on CPU tensors (no autograd)."""
    if _route(x, train_fwd_counts):
        return _launch_train_fwd(x, gamma, beta, eps)
    return bn_train_fwd_plain(x, gamma, beta, eps)


def bn_train_bwd_2d(x, g, gamma, mean, inv):
    """(dx, dgamma, dbeta) on [rows, C], as ``bn_train_fwd_2d``."""
    if _route(x, train_bwd_counts):
        return _launch_train_bwd(x, g, gamma, mean, inv)
    return bn_train_bwd_plain(x, g, gamma, mean, inv)


def bn_inference_2d(x, mean, var, gamma, beta, eps: float):
    """y on [rows, C], as ``bn_train_fwd_2d``."""
    if _route(x, inference_counts):
        return _launch_inference(x, mean, var, gamma, beta, eps)
    return bn_inference_plain(x, mean, var, gamma, beta, eps)


class _BNTrain(torch.autograd.Function):
    """The reference's ``_bn_training_vjp``: (y, mean, var) forward, the
    backward kernel for (dx, dgamma, dbeta); the moments carry no
    gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, var, inv = bn_train_fwd_2d(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, gamma, mean, inv = ctx.saved_tensors
        dx, dgamma, dbeta = bn_train_bwd_2d(x, gy.contiguous(), gamma, mean,
                                            inv)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


class _BNInference(torch.autograd.Function):
    """The reference's ``bn_inference`` custom VJP: the kernel forward, the
    analytic ``_bn_inference_bwd`` as torch ops."""

    @staticmethod
    def forward(ctx, x, mean, var, gamma, beta, eps):
        ctx.save_for_backward(x, mean, var, gamma)
        ctx.eps = eps
        return bn_inference_2d(x, mean, var, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, mean, var, gamma = ctx.saved_tensors
        acc = _acc(x)
        xc = x.to(acc) - mean.to(acc)
        inv = torch.rsqrt(var.to(acc) + ctx.eps)
        gf = g.to(acc)
        a = gamma.to(acc) * inv
        sum_g = gf.sum(dim=0)
        dx = gf * a
        dgamma = (gf * xc * inv).sum(dim=0)
        dmean = -sum_g * a
        dvar = (gf * xc).sum(dim=0) * a * (-0.5) * inv * inv
        return (dx.to(x.dtype), dmean.to(mean.dtype), dvar.to(var.dtype),
                dgamma.to(gamma.dtype), sum_g.to(gamma.dtype), None)


def _rows(x):
    return x.reshape(-1, x.shape[-1]).contiguous()


class BatchNormHelper:
    """Discovery-seam wrapper (kind ``"batch_norm"``, the JAX package's
    ``PallasBatchNormHelper``): ``BatchNormalization`` routes every call
    through it when ``supports`` holds, at any rank."""

    name = "BatchNormHelper"

    def supports(self, x: torch.Tensor) -> bool:
        return supports(x)

    def apply_inference(self, x, mean, var, gamma, beta, eps):
        y = _BNInference.apply(_rows(x), mean, var, gamma, beta, float(eps))
        return y.reshape(x.shape)

    def apply_training(self, x, gamma, beta, eps):
        """(y, batch mean, batch var); the moments are float32."""
        y, mean, var = _BNTrain.apply(_rows(x), gamma, beta, float(eps))
        return y.reshape(x.shape), mean, var


"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught):

1. Build every CUDA kernel of the serving and training paths from the
   sources in this checkout (``nvcc``, one process per source, all
   started together), and print each kernel's registers and shared
   memory as ``ptxas`` reports them.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, and time the kernel, the plain version and a
   library yardstick (which the port never calls: ``gather_pages`` +
   ``scaled_dot_product_attention`` for paged decode, SDPA forward and
   backward for flash attention (bfloat16, float32 and float16 cases),
   ``F.layer_norm`` for the prologue (bfloat16, float32, float16),
   ``F.batch_norm`` for BatchNorm),
   beside the least time the card could take (the bytes the call must
   move at 3.35 TB/s, or its operations at the peak rate for their type,
   whichever is larger).  Each flash case prints the kernels its calls
   take (``fa.kernel_path``); a bfloat16 or float16 case at D = 64 or 128
   must take wgmma for the forward, dQ and dK/dV, and the delta its dQ
   hands to dK/dV must match the torch reduction ``_row_delta``.
3. Serve the transformer char-LM at full width (vocab 128, d_model 1024,
   8 heads, 8 layers, bfloat16, seeded random weights) through the port's
   ``GenerationEngine`` (16 slots, pages of 16, context 512): 16
   concurrent greedy requests of 64 new tokens from 4 client threads.
   The kernel launch counts are reset just before and read just after;
   every attention call of the run must have launched the kernel.  The
   first prefill's logits are then checked against the gather oracle, and
   a few full-batch decode steps run under ``torch.profiler`` to split
   the step's host wall from the device's busy time.
4. Train the same model at full width (batch 8, T = 2048, Adam at 1e-3,
   ``bench.py``'s batch: random ids from ``RandomState(0)``, labels the
   one-hot of the ids rolled by one).  The first step's loss and
   per-layer gradients are held against the built-in path
   (``enable_helpers(False)``); then 2 warm-up and 5 timed ``fit`` steps,
   the flash and prologue launch counts reset just before and read just
   after (8 forward, 8 dQ, 8 dK/dV and 16 prologue launches a step, no
   plain-version call), and one step under ``torch.profiler`` (then one
   more with the host traced, which must show no ``_row_delta``
   reduction: delta comes from the dQ kernel).
5. Hold the three BatchNorm kernels (training forward, training
   backward, inference) against their plain versions at ResNet-50's
   shapes (bfloat16; a float32 and a float16 case, ragged C, and gamma
   and beta in bfloat16 as the layer passes them), and time them beside
   ``F.batch_norm`` (cuDNN, on channels_last views) and their bound.
6. ResNet-50 as a ComputationGraph at full width (224x224x3, 1000
   classes, batch 128, bfloat16, Nesterov at 0.1, ``bench.py``'s batch:
   ``RandomState(0)`` images in [0, 1) and one-hot labels; seeded random
   weights).  ``output`` is held against the built-in path
   (``enable_helpers(False)``: the logits and their argmax) and must
   launch the inference kernel once per BatchNorm layer (53), and one
   ``output`` runs under ``torch.profiler``; the first step's loss (bfloat16) and
   per-node gradients (float32 compute, where they are not rounding) are
   held against the built-in path; then 2 warm-up and 5 timed ``fit``
   steps (53 training-forward and 53 training-backward launches a step,
   no plain-version call, finite losses, running stats that moved), and
   one step under ``torch.profiler``.
7. Hold the two LRN kernels (forward, backward) against their plain
   versions at AlexNet's shapes (``[373248, 96]`` and ``[86528, 256]``
   in bfloat16; a float32, a float16, a ragged C = 130, a C = 3 < n and
   an n = 7 case), and time them beside ``F.local_response_norm`` (odd n
   only, its alpha times n: cuDNN's convention divides alpha by the
   window) and their bound.
8. AlexNet as a MultiLayerNetwork at full width (zoo ``alexnet``:
   224x224x3, 1000 classes, batch 128, bfloat16, Nesterov at 0.01 with
   l2 5e-4; ``RandomState(0)`` images in [0, 1) and one-hot labels;
   seeded random weights).  ``output`` is held against the built-in path
   (logits and argmax) and must launch the LRN forward kernel twice; the
   first step's loss (bfloat16) and per-layer gradients (float32
   compute) are held against the built-in path with the same dropout
   key; then 2 warm-up and 5 timed ``fit`` steps (2 forward and 2
   backward LRN launches a step, no plain-version call, finite losses),
   and one step under ``torch.profiler``.
9. Print the kernels line, then ``{"ok": true, "device": ...}`` last.

Exits non-zero without printing a result when no CUDA device is
available or the port's package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.backend.device import pin_fp32_precision
from deeplearning4j_tpu_torch.generation import GenerationEngine
from deeplearning4j_tpu_torch.helpers import batch_norm as bn
from deeplearning4j_tpu_torch.helpers import flash_attention as fa
from deeplearning4j_tpu_torch.helpers import fused_epilogue as fe
from deeplearning4j_tpu_torch.helpers import lrn
from deeplearning4j_tpu_torch.helpers import paged_attention as pa
from deeplearning4j_tpu_torch.models.sequential import tree_leaves
from deeplearning4j_tpu_torch.models.zoo import (
    alexnet, resnet50, transformer_char_lm,
)
from deeplearning4j_tpu_torch.nn.layers.attention import gather_pages
from deeplearning4j_tpu_torch.nn.layers.convolution import ConvolutionLayer
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.dense import DenseLayer, EmbeddingLayer

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
LOGITS_TOL = 0.1    # bf16 logits, kernel vs gather oracle, 8 layers
MODEL = dict(vocab_size=128, d_model=1024, n_heads=8, layers=8,
             max_cache=512, compute_dtype="bfloat16", seed=12345)
ENGINE = dict(slots=16, page_size=16, max_context=512, prefill_buckets=(16,))
PS, MAXP, PAGES = 16, 32, 16 * 32 + 1
CLIENTS, PER_CLIENT, NEW_TOKENS = 4, 4, 64
SPIN_CYCLES = 2_000_000     # about 1 ms of GPU clock: outlasts any enqueue
PROFILED_STEPS = 10
TRAIN_MODEL = dict(vocab_size=128, d_model=1024, n_heads=8, layers=8,
                   compute_dtype="bfloat16", seed=12345)
TRAIN_BATCH, TRAIN_T = 8, 2048
WARM_STEPS, TIMED_STEPS = 2, 5
LOSS_RTOL, GRAD_RTOL = 2e-2, 5e-2   # kernel path vs built-in path, bf16
KERNEL_ITERS = 10
RESNET = dict(compute_dtype="bfloat16", seed=12345)   # 224x224x3, 1000
RESNET_BATCH, RESNET_BN_LAYERS = 128, 53
# bf16 logits, kernels vs built-in path: error over max |logit| (7.4e-3
# measured on the H100) and images whose argmax may differ
RESNET_LOGITS_TOL, RESNET_ARGMAX_MISSES = 2e-2, 2
BN_CASES = [  # name, NHWC shape, dtype, gamma/beta dtype
    ("stem_bf16", (128, 112, 112, 64), torch.bfloat16, torch.float32),
    ("last_stage_bf16", (128, 7, 7, 2048), torch.bfloat16, torch.float32),
    ("stage3_bf16", (128, 14, 14, 1024), torch.bfloat16, torch.float32),
    ("stage1_f32", (128, 56, 56, 256), torch.float32, torch.float32),
    ("ragged_bf16", (13, 77, 101, 130), torch.bfloat16, torch.float32),
    ("ragged_f16", (13, 77, 101, 130), torch.float16, torch.float32),
    # gamma and beta as the layer passes them under a bf16 compute dtype
    ("last_stage_bf16_affine", (128, 7, 7, 2048), torch.bfloat16,
     torch.bfloat16),
]
DELTA_TOL = 1e-5    # dQ's delta vs _row_delta, over max(1, max |delta|)
LRN = dict(k=2.0, n=5, alpha=1e-4, beta=0.75)     # AlexNet's LRN layers
LRN_CASES = [  # name, NHWC shape, dtype, n
    ("lrn1_bf16", (128, 54, 54, 96), torch.bfloat16, 5),
    ("lrn2_bf16", (128, 26, 26, 256), torch.bfloat16, 5),
    ("lrn1_f32", (128, 54, 54, 96), torch.float32, 5),
    ("lrn2_f16", (128, 26, 26, 256), torch.float16, 5),
    ("ragged130_bf16", (13, 77, 101, 130), torch.bfloat16, 5),
    ("c3_bf16", (64, 55, 55, 3), torch.bfloat16, 5),
    ("n7_bf16", (128, 26, 26, 256), torch.bfloat16, 7),
]
ALEXNET = dict(compute_dtype="bfloat16", seed=12345)  # 224x224x3, 1000
ALEXNET_BATCH, ALEXNET_LRN_LAYERS = 128, 2
# logits, kernels vs built-in path: bf16 error over max |logit|, and
# images whose argmax may differ (bf16 near-ties counted apart)
ALEXNET_LOGITS_TOL, ALEXNET_ARGMAX_MISSES = 2e-2, 2


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# ------------------------------------------------------------------ phase 1
def build_kernels():
    modules = [pa, fa, fe, bn, lrn]
    with ThreadPoolExecutor(len(modules)) as ex:
        built = list(ex.map(lambda m: m.build(), modules))
    for m, b in zip(modules, built):
        print(f"build {m.SOURCE.name}: {b.build_s:.1f} s -> {b.path.name}")
        entry = "?"
        for ln in b.log.splitlines():
            if "Compiling entry function" in ln:
                # the kernel's name and template arguments, from the
                # mangled symbol
                found = re.search(r"((?:flash_[a-z]+|drn|paged_decode|"
                                  r"lrn_[a-z]+)_(?:kernel|mma|wgmma))"
                                  r"(I\w*?E)?E"
                                  r"|(bn_[a-z_]+)(I\w*?E)?", ln)
                entry = "".join(x for x in found.groups() if x) \
                    if found else ln
            elif "Used" in ln or "spill" in ln:
                print(f"  ptxas {entry}: {ln.split(':', 1)[-1].strip()}")
            elif "warning" in ln.lower() or "Performance Loss" in ln:
                print(f"  {ln.strip()[:200]}")


# ------------------------------------------------------------------ phase 2
def paged_case(seed, b, t, hq, hkv, d, dtype, start=None):
    """Engine-shaped inputs: trash page 0; row 0 an idle slot (all-trash
    block row at position 0); the other rows at mixed positions ending in
    partly filled pages (or, with ``start``, one prompt written from
    there)."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    pk = torch.randn(PAGES * PS, hkv, d, generator=g)
    pv = torch.randn(PAGES * PS, hkv, d, generator=g)
    q = torch.randn(b, t, hq, d, generator=g)
    block = rng.permutation(np.arange(1, PAGES))[:b * MAXP].reshape(b, MAXP)
    if start is None:
        last = rng.integers(t - 1, MAXP * PS, size=(b,))
        last[0] = t - 1
        block[0] = 0
    else:
        last = np.full((b,), start + t - 1)
    for i in range(b):
        block[i, int(last[i]) // PS + 1:] = 0
    qpos = (last - (t - 1))[:, None] + np.arange(t)
    return ([x.to("cuda", dtype) for x in (q, pk, pv)]
            + [torch.as_tensor(block, dtype=torch.int32, device="cuda"),
               torch.as_tensor(qpos, dtype=torch.int32, device="cuda")])


def bound_ms(q, pk, block, qpos):
    """Least time: the live K/V the call must read (keys up to each row's
    highest position), q, positions and block table read once, the output
    written once — or the 4*D flops per (query, key) pair at the peak rate
    of the input type — whichever is larger."""
    esz = q.element_size()
    b, t, hq, d = q.shape
    hkv = pk.shape[1]
    keys = torch.clamp(qpos.max(dim=1).values + 1, max=MAXP * PS)
    nbytes = (int(keys.sum()) * hkv * d * esz * 2 + 2 * q.numel() * esz
              + (block.numel() + qpos.numel()) * 4)
    pairs = int(torch.clamp(qpos + 1, max=MAXP * PS).sum()) * hq
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = pairs * 4 * d / PEAK_OPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, flush, iters=30, warm=3):
    """Mean device ms per call from CUDA events, the L2 cache flushed
    before each call (the decode loop finds it full of other layers'
    weights).  A spin kernel queued ahead of the start event keeps the
    card busy while the host enqueues the call, so the host's launch
    cost stays outside the measured interval."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def host_ms(fn, calls=100):
    """Host ms to enqueue one call, the card kept busy by a spin kernel
    meanwhile so that no call waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40 * SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / calls


def library_call(q, pk, pv, block, qpos):
    """Yardstick: gather the paged view, then one SDPA with a boolean
    causal-by-position mask."""
    gk = gather_pages(pk, block, PS).transpose(1, 2)
    gv = gather_pages(pv, block, PS).transpose(1, 2)
    kpos = torch.arange(gk.shape[2], device=q.device)
    mask = (qpos[:, None, :, None] >= kpos)               # [B, 1, T, L]
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), gk, gv, attn_mask=mask,
        enable_gqa=q.shape[2] != pk.shape[1])
    return o.transpose(1, 2)


def kernel_phase(flush, name_card):
    cases = [
        ("decode", dict(b=16, t=1, hq=8, hkv=8, d=128), torch.bfloat16, None),
        ("prefill", dict(b=1, t=16, hq=8, hkv=8, d=128), torch.bfloat16, 0),
        ("decode_f32", dict(b=16, t=1, hq=8, hkv=8, d=128), torch.float32,
         None),
        ("decode_gqa", dict(b=16, t=1, hq=8, hkv=2, d=128), torch.bfloat16,
         None),
    ]
    rows = {}
    for i, (name, shape, dtype, start) in enumerate(cases):
        args = paged_case(100 + i, dtype=dtype, start=start, **shape)
        out = pa.paged_decode_attention(*args, page_size=PS)
        ref = pa.paged_attention_plain(*args, PS)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        call = lambda: pa.paged_decode_attention(*args, page_size=PS)
        ms = time_ms(call, flush)
        enqueue_ms = host_ms(call)
        plain_ms = time_ms(lambda: pa.paged_attention_plain(*args, PS), flush)
        lib = library_call(*args)
        lib_err = (lib.float() - ref.float()).abs().max().item()
        lib_ms = time_ms(lambda: library_call(*args), flush)
        bms, by = bound_ms(args[0], args[1], args[3], args[4])
        rows[name] = dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                          bound_ms=bms, bound_by=by)
        print(f"paged_decode_attention[{name}] q{list(args[0].shape)} "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e} (tol {TOL[dtype]:g}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms (err {lib_err:.2e}), bound {bms:.5f} ms "
              f"({by}); host enqueue {enqueue_ms:.4f} ms [{name_card}]")
        check(err <= TOL[dtype], f"{name}: kernel vs plain {err} > "
                                 f"{TOL[dtype]}")
    return rows


# ------------------------------------------------------------------ phase 3
def engine_phase(name_card):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"],
                            int(rng.integers(4, 13))).tolist()
               for _ in range(CLIENTS * PER_CLIENT)]
    net = transformer_char_lm(device="cuda", **MODEL)
    pa.counts.reset()
    t_build = time.perf_counter()
    eng = GenerationEngine(net, **ENGINE).start()
    print(f"engine start (warm-up included): "
          f"{time.perf_counter() - t_build:.2f} s")
    results = [None] * len(prompts)
    handles = [None] * len(prompts)
    errors = []

    def client(c):
        try:
            mine = range(c * PER_CLIENT, (c + 1) * PER_CLIENT)
            for i in mine:
                handles[i] = eng.submit(prompts[i], NEW_TOKENS)
            for i in mine:
                results[i] = handles[i].result(timeout=300)
        except Exception as e:          # reported below, fails the run
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t0
    launches, plain = pa.counts.launches, pa.counts.plain_calls
    progs = eng.programs
    calls = progs.prefill_calls + progs.decode_calls
    steps = sorted(eng.decode_step_s)
    eng.stop()
    check(not errors and not any(th.is_alive() for th in threads),
          f"client errors {errors!r}")
    check(all(r is not None and len(r) == NEW_TOKENS for r in results),
          "every request returns 64 tokens")
    check(launches == MODEL["layers"] * calls and launches > 0,
          f"launches {launches} == layers x calls {MODEL['layers']} x "
          f"{calls}")
    check(plain == 0, f"plain-version calls {plain} == 0")
    ttft = np.asarray([h.ttft_s for h in handles]) * 1e3
    tok_s = sum(len(r) for r in results) / wall
    print(f"engine: {len(results)} requests x {NEW_TOKENS} tokens in "
          f"{wall:.3f} s; prefill calls {progs.prefill_calls}, decode "
          f"steps {progs.decode_calls}; kernel launches {launches}, plain "
          f"calls {plain}")
    print(f"engine: {tok_s:.1f} tokens/s [{name_card}]")
    print(f"engine: TTFT p50 {np.percentile(ttft, 50):.2f} ms, p99 "
          f"{np.percentile(ttft, 99):.2f} ms [{name_card}]")
    print(f"engine: decode step median {np.median(steps) * 1e3:.3f} ms "
          f"over {len(steps)} steps [{name_card}]")

    # the first prefill through the kernel vs the gather oracle
    p0 = prompts[0]
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :len(p0)] = p0
    block = np.zeros((1, progs.pages_per_slot), np.int32)
    block[0, 0] = 1
    start = np.zeros((1,), np.int32)
    fused = progs.forward(progs.fresh_pools(), block, start, tokens)
    pa.set_paged_attention_mode("gather")
    try:
        gathered = progs.forward(progs.fresh_pools(), block, start, tokens)
    finally:
        pa.set_paged_attention_mode("fused")
    a = fused[0, len(p0) - 1].float()
    b = gathered[0, len(p0) - 1].float()
    d = (a - b).abs().max().item()
    print(f"first prefill logits, kernel vs gather oracle: max_abs_err "
          f"{d:.3e} (tol {LOGITS_TOL}; max |logit| {b.abs().max().item():.3f};"
          f" argmax {int(a.argmax())} vs {int(b.argmax())})")
    check(bool(torch.isfinite(a).all()) and d <= LOGITS_TOL,
          f"prefill logits kernel vs gather {d} > {LOGITS_TOL}")
    decode_profile(progs, name_card)
    return launches


def decode_profile(progs, name_card):
    """Where a decode step's time goes: ``PROFILED_STEPS`` full-batch
    steps (every slot live, at the positions the served requests reach)
    under ``torch.profiler``, the device's busy time per step against
    the host wall per step."""
    from torch.profiler import ProfilerActivity, profile

    s, maxp = progs.slots, progs.pages_per_slot
    pools = progs.fresh_pools()
    block = (1 + np.arange(s * maxp, dtype=np.int32)).reshape(s, maxp)
    pos = np.random.default_rng(1).integers(8, 72, s).astype(np.int32)
    zi, zf = np.zeros(s, np.int32), np.zeros(s, np.float32)
    keys = np.zeros((s, 2), np.uint32)

    def step():
        progs.decode(pools, block, pos, zi, keys, zi, zf, zi,
                     np.ones(s, np.float32))

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    ev = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / PROFILED_STEPS
    attn_ms = sum(e.self_device_time_total for e in ev
                  if "paged_decode_kernel" in e.key) / 1e3 / PROFILED_STEPS
    launches = sum(e.count for e in ev
                   if e.self_device_time_total > 0) / PROFILED_STEPS
    check(attn_ms > 0, "the profiled decode steps ran the kernel")
    print(f"decode step (profiled, {PROFILED_STEPS} steps, {s} live slots): "
          f"host wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}) in {launches:.0f} device "
          f"operations, paged attention kernel {attn_ms:.3f} ms "
          f"[{name_card}]")


# ------------------------------------------------- phase 2, training kernels
def _randn(seed, shape, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _scaled_err(a, ref):
    """Largest difference over the reference's largest magnitude."""
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _abs_err(a, ref):
    return (a.float() - ref.float()).abs().max().item()


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _live_pairs(t, causal, window):
    """(query, key) pairs inside the mask of one (b, h)."""
    if not causal:
        return t * t
    q = np.arange(t)
    seen = q + 1 if window is None else np.minimum(q + 1, window)
    return int(seen.sum())


def _sdpa_mask(t, causal, window):
    if not causal or window is None:
        return None
    pos = torch.arange(t, device="cuda")
    return ((pos[:, None] >= pos[None, :])
            & (pos[None, :] > pos[:, None] - window))


def flash_case(name, seed, shape, dtype, causal, window, flush, name_card):
    b, t, h, d = shape
    paths = {k: fa.kernel_path(k, dtype, d) for k in ("fwd", "dq", "dkv")}
    print(f"flash[{name}] paths: forward {paths['fwd']}, dQ {paths['dq']}, "
          f"dK/dV {paths['dkv']}")
    if dtype != torch.float32 and d in (64, 128):
        check(paths == {"fwd": "wgmma", "dq": "wgmma", "dkv": "wgmma"},
              f"flash[{name}] takes wgmma for the forward, dQ and dK/dV: "
              f"{paths}")
    q, k, v, do = (_randn(seed + i, shape, dtype) for i in range(4))
    o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    ro, rlse = fa.flash_attention_plain_fwd(q, k, v, causal, window)
    rdq, rdk, rdv = fa.flash_attention_plain_bwd(q, k, v, ro, rlse, do,
                                                 causal, window)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    errs = {"o": _abs_err(o, ro), "lse": _abs_err(lse, rlse),
            "dq": _scaled_err(dq, rdq), "dk": _scaled_err(dk, rdk),
            "dv": _scaled_err(dv, rdv)}
    abs_errs = {"dq": _abs_err(dq, rdq), "dk": _abs_err(dk, rdk),
                "dv": _abs_err(dv, rdv)}
    for what, err in errs.items():
        check(err <= tol, f"flash[{name}] {what}: kernel vs plain {err} > "
                          f"{tol}")
    del ro, rlse, rdq, rdk, rdv

    # the delta dQ hands to dK/dV (the kernel's own on the wgmma route)
    _, delta = fa._launch_dq(q, k, v, do, o, lse, causal, window)
    rdelta = fa._row_delta(o, do)
    torch.cuda.synchronize()
    delta_err = _abs_err(delta, rdelta) / max(
        1.0, rdelta.abs().max().item())
    check(delta_err <= DELTA_TOL, f"flash[{name}] delta: dQ's vs "
                                  f"_row_delta {delta_err} > {DELTA_TOL}")
    del rdelta
    fwd_ms = time_ms(lambda: fa.flash_fwd(q, k, v, causal=causal,
                                          window=window), flush,
                     iters=KERNEL_ITERS)
    # dQ with its delta: the kernel's own, or _row_delta on other routes
    dq_ms = time_ms(lambda: fa._launch_dq(q, k, v, do, o, lse, causal,
                                          window), flush, iters=KERNEL_ITERS)
    dkv_ms = time_ms(lambda: fa._launch_dkv(q, k, v, do, lse, delta, causal,
                                            window), flush,
                     iters=KERNEL_ITERS)
    pfwd_ms = time_ms(lambda: fa.flash_attention_plain_fwd(q, k, v, causal,
                                                           window), flush,
                      iters=3, warm=1)
    pbwd_ms = time_ms(lambda: fa.flash_attention_plain_bwd(
        q, k, v, o, lse, do, causal, window), flush, iters=3, warm=1)

    # yardstick: one SDPA call forward, its autograd backward
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = _sdpa_mask(t, causal, window)
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None)
    lib_fwd_ms = time_ms(sdpa, flush, iters=KERNEL_ITERS)
    out = sdpa()
    gdo = do.transpose(1, 2)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), gdo, retain_graph=True), flush,
        iters=KERNEL_ITERS)
    lib_err = _abs_err(out.transpose(1, 2), o)
    del out, qs, ks, vs

    esz = q.element_size()
    pairs = _live_pairs(t, causal, window) * b * h
    tensor_bytes = q.numel() * esz
    row_bytes = b * h * t * 4                         # lse or delta, f32
    bounds = {
        "fwd": _bound(4 * tensor_bytes + row_bytes, 4 * d * pairs, dtype),
        # q, k, v, dO and O read, dq written; lse read, delta written
        "dq": _bound(6 * tensor_bytes + 2 * row_bytes,
                     6 * d * pairs + 2 * d * b * h * t, dtype),
        "dkv": _bound(6 * tensor_bytes + 2 * row_bytes, 8 * d * pairs,
                      dtype),
    }
    print(f"flash[{name}] q{list(shape)} {str(dtype)[6:]} causal={causal} "
          f"window={window}: err o {errs['o']:.3e}, lse {errs['lse']:.3e}, "
          f"dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e} "
          f"(grads scaled by max abs; tol {tol:g}); delta vs _row_delta "
          f"{delta_err:.3e} (tol {DELTA_TOL:g}); library o err "
          f"{lib_err:.3e} [{name_card}]")
    print(f"flash[{name}] fwd {fwd_ms:.4f} ms (bound {bounds['fwd'][0]:.5f}"
          f" ms, {bounds['fwd'][1]}), dQ with delta {dq_ms:.4f} ms (bound "
          f"{bounds['dq'][0]:.5f}), dK/dV {dkv_ms:.4f} ms (bound "
          f"{bounds['dkv'][0]:.5f}); plain fwd {pfwd_ms:.4f} ms, plain bwd "
          f"{pbwd_ms:.4f} ms; SDPA fwd {lib_fwd_ms:.4f} ms, SDPA bwd "
          f"{lib_bwd_ms:.4f} ms [{name_card}]")
    return {
        "fwd": dict(err=errs["o"], ms=fwd_ms, plain_ms=pfwd_ms,
                    lib_ms=lib_fwd_ms, bound=bounds["fwd"]),
        "dq": dict(err=abs_errs["dq"], ms=dq_ms, plain_ms=pbwd_ms,
                   lib_ms=lib_bwd_ms, bound=bounds["dq"]),
        "dkv": dict(err=max(abs_errs["dk"], abs_errs["dv"]), ms=dkv_ms,
                    plain_ms=pbwd_ms, lib_ms=lib_bwd_ms,
                    bound=bounds["dkv"]),
    }


def prologue_case(name, seed, rows, c, dtype, has_res, has_mask, flush,
                  name_card):
    h = _randn(seed, (rows, c), dtype) * 3 + 1
    res = _randn(seed + 1, (rows, c), dtype) if has_res else None
    gamma = _randn(seed + 2, (c,), dtype) + 1
    beta = _randn(seed + 3, (c,), dtype)
    keep = 0.9 if has_mask else 1.0
    mask = (torch.rand((rows, c), device="cuda") < keep) if has_mask \
        else None
    args = (h, res, gamma, beta, mask, 1e-5, keep)
    out = fe.dropout_residual_norm_2d(*args)
    ref = fe.dropout_residual_norm_plain(*args)
    torch.cuda.synchronize()
    # bf16, f16: one rounding of values up to ~10, held relative to the
    # largest magnitude; f32 absolute
    err = (_abs_err(out, ref) if dtype == torch.float32
           else _scaled_err(out, ref))
    check(err <= TOL[dtype], f"prologue[{name}]: kernel vs plain {err} > "
                             f"{TOL[dtype]}")
    ms = time_ms(lambda: fe.dropout_residual_norm_2d(*args), flush)
    plain_ms = time_ms(lambda: fe.dropout_residual_norm_plain(*args), flush,
                       iters=KERNEL_ITERS)
    lib_ms = time_ms(lambda: F.layer_norm(h, (c,), gamma, beta, 1e-5),
                     flush)
    esz = h.element_size()
    nbytes = (2 + has_res) * h.numel() * esz + 2 * c * esz + (
        rows * c if has_mask else 0)
    bms, by = _bound(nbytes, 0, dtype)
    print(f"prologue[{name}] [{rows}, {c}] {str(dtype)[6:]} res={has_res} "
          f"mask={has_mask}: err {err:.3e} (tol {TOL[dtype]:g}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.layer_norm {lib_ms:.4f} "
          f"ms, bound {bms:.5f} ms ({by}) [{name_card}]")
    return dict(err=_abs_err(out, ref), ms=ms, plain_ms=plain_ms,
                lib_ms=lib_ms, bound=(bms, by))


def train_kernel_phase(flush, name_card):
    full = (TRAIN_BATCH, TRAIN_T, 8, 128)
    flash = {}
    for i, (name, shape, dtype, causal, window) in enumerate([
            ("causal_bf16", full, torch.bfloat16, True, None),
            ("causal_f32", full, torch.float32, True, None),
            ("full_bf16", full, torch.bfloat16, False, None),
            ("window256_bf16", full, torch.bfloat16, True, 256),
            ("ragged1000_bf16", (TRAIN_BATCH, 1000, 8, 128), torch.bfloat16,
             True, None),
            ("causal_f16", full, torch.float16, True, None),
            ("causal_f16_d64", (TRAIN_BATCH, TRAIN_T, 8, 64), torch.float16,
             True, None)]):
        flash[name] = flash_case(name, 200 + 10 * i, shape, dtype, causal,
                                 window, flush, name_card)
    rows = TRAIN_BATCH * TRAIN_T
    prologue = {}
    for i, (name, dtype, has_res, has_mask) in enumerate([
            ("prologue_bf16", torch.bfloat16, False, False),
            ("prologue_mask_bf16", torch.bfloat16, False, True),
            ("residual_bf16", torch.bfloat16, True, False),
            ("residual_mask_bf16", torch.bfloat16, True, True),
            ("prologue_mask_f32", torch.float32, False, True),
            ("prologue_mask_f16", torch.float16, False, True),
            ("residual_f16", torch.float16, True, False)]):
        prologue[name] = prologue_case(name, 300 + 10 * i, rows, 1024, dtype,
                                       has_res, has_mask, flush, name_card)
    return flash["causal_bf16"], prologue["prologue_bf16"]


# ------------------------------------------------------------ phase 4, train
def _matmul_params(net) -> int:
    """Weights of rank >= 2 outside the embedding: the N of the 6·N·tokens
    count (``bench.py`` ``_matmul_params``)."""
    return sum(p.numel() for layer in net.layers
               if not isinstance(layer, EmbeddingLayer)
               for p in tree_leaves(net.params[layer.name]) if p.ndim >= 2)


def _loss_and_grads(net, loss_of):
    """Loss and per-layer flat gradients of one forward/backward, no
    update; ``loss_of(params) -> (loss, new state)``."""
    trainable = net._trainable(net.params)
    names = [n for n in sorted(trainable)]
    leaves = {n: tree_leaves(trainable[n]) for n in names}
    flat = [p for n in names for p in leaves[n]]
    for p in flat:
        p.requires_grad_(True)
    try:
        loss, _ = loss_of(net.params)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    out, i = {}, 0
    for n in names:
        k = len(leaves[n])
        out[n] = torch.cat([g.reshape(-1) for g in grads[i:i + k]])
        i += k
    return float(loss.detach()), out


def _kernel_counts():
    return (fa.fwd_counts, fa.dq_counts, fa.dkv_counts, fe.counts)


def _rel_l2(grads, ref):
    return {n: ((grads[n] - ref[n]).norm()
                / ref[n].norm().clamp_min(1e-30)).item() for n in ref}


def first_step_check(what, net, loss_of, floor=False):
    """The first step's loss and per-layer gradients through the kernels
    against the built-in path (``enable_helpers(False)``).  ``floor``:
    also print how far two runs of the built-in path lie apart (the
    libraries' own run-to-run spread)."""
    k_loss, k_grads = _loss_and_grads(net, loss_of)
    helpers.enable_helpers(False)
    try:
        b_loss, b_grads = _loss_and_grads(net, loss_of)
        again = _loss_and_grads(net, loss_of)[1] if floor else None
    finally:
        helpers.enable_helpers(True)
    loss_rel = abs(k_loss - b_loss) / abs(b_loss)
    grad_rel = _rel_l2(k_grads, b_grads)
    worst = max(grad_rel, key=grad_rel.get)
    print(f"{what}: first-step loss kernels {k_loss:.6f} vs built-in "
          f"{b_loss:.6f} (rel {loss_rel:.3e}, tol {LOSS_RTOL}); per-layer "
          f"gradient rel L2 max {grad_rel[worst]:.3e} at {worst} (tol "
          f"{GRAD_RTOL})")
    if again is not None:
        spread = _rel_l2(again, b_grads)
        top = max(spread, key=spread.get)
        print(f"{what}: built-in path against itself, per-layer gradient "
              f"rel L2 max {spread[top]:.3e} at {top}, {spread[worst]:.3e} "
              f"at {worst}")
    check(loss_rel <= LOSS_RTOL, f"{what} first-step loss rel {loss_rel}")
    check(all(r <= GRAD_RTOL for r in grad_rel.values()),
          f"{what} per-layer gradient rel L2 {grad_rel}")
    del k_grads, b_grads, again
    torch.cuda.empty_cache()


def train_phase(name_card):
    net = transformer_char_lm(device="cuda", **TRAIN_MODEL)
    vocab = TRAIN_MODEL["vocab_size"]
    ids = np.random.RandomState(0).randint(0, vocab, (TRAIN_BATCH, TRAIN_T))
    x = torch.as_tensor(ids, device="cuda")
    y = torch.as_tensor(np.eye(vocab, dtype=np.float32)[np.roll(ids, -1, 1)],
                        device="cuda")

    # the first step through the kernels against the built-in path
    first_step_check("train", net,
                     lambda params: net._loss_fn(params, x, y, None))

    steps = WARM_STEPS + TIMED_STEPS
    for c in _kernel_counts():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        losses.append(net.score_value)      # reads the loss: waits for it
        step_s.append(time.perf_counter() - t0)
    launches = [c.launches for c in _kernel_counts()]
    plain = [c.plain_calls for c in _kernel_counts()]
    layers = TRAIN_MODEL["layers"]
    want = [layers * steps] * 3 + [2 * layers * steps]
    print(f"train: launches over {steps} steps (fwd, dQ, dK/dV, prologue) "
          f"{launches}, expected {want}; plain-version calls {plain}")
    check(launches == want, f"launches {launches} == {want}")
    check(plain == [0, 0, 0, 0], f"plain-version calls {plain} == 0")
    check(all(np.isfinite(losses)), f"losses finite {losses}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")

    med = float(np.median(step_s[WARM_STEPS:]))
    tokens = TRAIN_BATCH * TRAIN_T
    heads, d_model = TRAIN_MODEL["n_heads"], TRAIN_MODEL["d_model"]
    flops = (6.0 * _matmul_params(net) * tokens
             + 12.0 * layers * heads * TRAIN_T * TRAIN_T
             * (d_model // heads) * TRAIN_BATCH * 0.5)
    mfu = flops / med / PEAK_OPS[torch.bfloat16]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"train: losses {[round(v, 6) for v in losses]}")
    print(f"train: step median {med * 1e3:.3f} ms over {TIMED_STEPS} steps "
          f"(after {WARM_STEPS} warm-up); {tokens / med:.1f} tokens/s; "
          f"analytic-FLOP utilisation {mfu:.4f} of 989 TFLOP/s "
          f"({flops / 1e12:.2f} TFLOP a step); peak memory {peak_gb:.2f} GB "
          f"[{name_card}]")
    train_profile(net, x, y, name_card)
    return launches


def train_profile(net, x, y, name_card):
    """Where one train step's time goes: the device's busy time by kernel
    against the step's host wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    check(busy_ms > 0, "the profiler saw device time")
    ours = {"flash fwd": "flash_fwd_", "flash dQ": "flash_dq_",
            "flash dK/dV": "flash_dkv_", "prologue": "drn_kernel"}
    share = {k: sum(e.self_device_time_total for e in ev if pat in e.key)
             / 1e3 for k, pat in ours.items()}
    print(f"train step (profiled): host wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f}) in "
          f"{sum(e.count for e in ev)} device operations [{name_card}]")
    print("train step kernels: " + ", ".join(
        f"{k} {v:.3f} ms ({v / busy_ms:.3f})" for k, v in share.items())
        + f"; the four together {sum(share.values()) / busy_ms:.3f} of busy")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  top: {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")

    # the host's side, in a second step: its launches, and no delta
    # reduction (``_row_delta`` labels itself flash_row_delta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(x, y)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    launch = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    row_delta = sum(e.count for e in ev if e.key == "flash_row_delta")
    print(f"train step host side (traced): cudaLaunchKernel {launch} calls;"
          f" _row_delta reductions {row_delta} [{name_card}]")
    check(row_delta == 0, f"the train step ran {row_delta} _row_delta "
                          "reductions")


# ------------------------------------------------- phase 5, batch norm
BN_EPS = 1e-5


def bn_case(name, seed, shape, dtype, adt, flush, name_card):
    """The three BatchNorm kernels on one NHWC shape, as [N·H·W, C], with
    gamma and beta in ``adt``."""
    n, h, w, c = shape
    m = n * h * w
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(m, c, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    gy = torch.randn(m, c, generator=g, device="cuda").to(dtype)
    gamma = (torch.randn(c, generator=g, device="cuda") + 1).to(adt)
    beta = torch.randn(c, generator=g, device="cuda").to(adt)
    y, mean, var, inv = bn.bn_train_fwd_2d(x, gamma, beta, BN_EPS)
    dx, dgamma, dbeta = bn.bn_train_bwd_2d(x, gy, gamma, mean, inv)
    rvar = var + 0.25       # running stats of the inference case
    yi = bn.bn_inference_2d(x, mean, rvar, gamma, beta, BN_EPS)
    ry, rmean, rv, rinv = bn.bn_train_fwd_plain(x, gamma, beta, BN_EPS)
    rdx, rdg, rdb = bn.bn_train_bwd_plain(x, gy, gamma, rmean, rinv)
    ryi = bn.bn_inference_plain(x, mean, rvar, gamma, beta, BN_EPS)
    torch.cuda.synchronize()
    pairs = {"fwd": ((y, ry), (mean, rmean), (var, rv)),
             "bwd": ((dx, rdx), (dgamma, rdg), (dbeta, rdb)),
             "inf": ((yi, ryi),)}
    errs = {k: max(_scaled_err(a, r) for a, r in v) for k, v in pairs.items()}
    abs_errs = {k: max(_abs_err(a, r) for a, r in v)
                for k, v in pairs.items()}
    for k, err in errs.items():
        check(err <= TOL[dtype], f"batch_norm[{name}] {k}: kernel vs plain "
                                 f"{err} > {TOL[dtype]}")
    del ry, rmean, rv, rinv, rdx, rdg, rdb, ryi, y, dx, yi
    torch.cuda.empty_cache()

    calls = {
        "fwd": (lambda: bn.bn_train_fwd_2d(x, gamma, beta, BN_EPS),
                lambda: bn.bn_train_fwd_plain(x, gamma, beta, BN_EPS)),
        "bwd": (lambda: bn.bn_train_bwd_2d(x, gy, gamma, mean, inv),
                lambda: bn.bn_train_bwd_plain(x, gy, gamma, mean, inv)),
        "inf": (lambda: bn.bn_inference_2d(x, mean, rvar, gamma, beta,
                                           BN_EPS),
                lambda: bn.bn_inference_plain(x, mean, rvar, gamma, beta,
                                              BN_EPS)),
    }
    ms = {k: time_ms(kern, flush) for k, (kern, _) in calls.items()}
    plain_ms = {k: time_ms(plain, flush, iters=KERNEL_ITERS)
                for k, (_, plain) in calls.items()}

    # yardsticks the port never calls: F.batch_norm on the channels_last
    # NCHW view of the NHWC tensor, gamma and beta in float32 (as cuDNN
    # takes them beside the float32 running stats)
    x4 = x.view(n, h, w, c).permute(0, 3, 1, 2)
    gy4 = gy.view(n, h, w, c).permute(0, 3, 1, 2)
    xl, gl, bl = (t.detach().clone().requires_grad_()
                  for t in (x4, gamma.float(), beta.float()))
    lib_fwd = lambda: F.batch_norm(xl, None, None, gl, bl, True, 0.1, BN_EPS)
    out = lib_fwd()
    lib_err = _abs_err(out.permute(0, 2, 3, 1).reshape(m, c),
                       bn.bn_train_fwd_plain(x, gamma, beta, BN_EPS)[0])
    lib_ms = {
        "fwd": time_ms(lib_fwd, flush),
        "bwd": time_ms(lambda: torch.autograd.grad(
            out, (xl, gl, bl), gy4, retain_graph=True), flush),
        "inf": time_ms(lambda: F.batch_norm(x4, mean, rvar, gl.detach(),
                                            bl.detach(), False, 0.1, BN_EPS),
                       flush),
    }
    del out, xl, gl, bl

    esz, asz = x.element_size(), gamma.element_size()
    bounds = {"fwd": _bound(2 * m * c * esz + 2 * c * asz + 3 * c * 4, 0,
                            dtype),
              "bwd": _bound(3 * m * c * esz + c * asz + 4 * c * 4, 0, dtype),
              "inf": _bound(2 * m * c * esz + 2 * c * asz + 2 * c * 4, 0,
                            dtype)}
    print(f"batch_norm[{name}] [{m}, {c}] {str(dtype)[6:]} (gamma, beta "
          f"{str(adt)[6:]}): err train fwd "
          f"{errs['fwd']:.3e}, train bwd {errs['bwd']:.3e}, inference "
          f"{errs['inf']:.3e} (scaled by max abs; tol {TOL[dtype]:g}); "
          f"F.batch_norm fwd abs err {lib_err:.3e} [{name_card}]")
    print(f"batch_norm[{name}] " + "; ".join(
        f"{label} {ms[k]:.4f} ms (bound {bounds[k][0]:.5f} ms, "
        f"{bounds[k][1]}; plain {plain_ms[k]:.4f} ms, F.batch_norm "
        f"{lib_ms[k]:.4f} ms)" for k, label in (
            ("fwd", "train fwd"), ("bwd", "train bwd"),
            ("inf", "inference"))) + f" [{name_card}]")
    return {k: dict(err=abs_errs[k], ms=ms[k], plain_ms=plain_ms[k],
                    lib_ms=lib_ms[k], bound=bounds[k]) for k in ms}


def bn_kernel_phase(flush, name_card):
    return {name: bn_case(name, 400 + 10 * i, shape, dtype, adt, flush,
                          name_card)
            for i, (name, shape, dtype, adt) in enumerate(BN_CASES)}


# -------------------------------------------------- phase 6, ResNet-50
def _forward_flops(net, acts) -> int:
    """Multiply-adds x 2 of every convolution and of the head, from the
    activations' shapes."""
    total = 0
    for node in net.conf.nodes:
        layer = node.layer
        if isinstance(layer, ConvolutionLayer):
            kh, kw = layer.kernel_size
            total += 2 * acts[node.name].numel() * kh * kw * layer.n_in
        elif node.name in net.conf.outputs:
            total += 2 * acts[node.inputs[0]].numel() * layer.n_out
    return total


def _bn_counts():
    return (bn.inference_counts, bn.train_fwd_counts, bn.train_bwd_counts)


def resnet_phase(name_card):
    net = resnet50(device="cuda", **RESNET)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(RESNET_BATCH, 224, 224, 3).astype(
        np.float32), device="cuda")
    y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
        rs.randint(0, 1000, RESNET_BATCH)], device="cuda")
    print(f"resnet50: {net.num_params()} params, "
          f"{sum(1 for l in net.layers if type(l).__name__ == 'BatchNormalization')}"
          f" BatchNorm layers, batch {RESNET_BATCH}x224x224x3 bf16")

    # output() through the inference kernel
    for c in _bn_counts():
        c.reset()
    probs = net.output(x)
    torch.cuda.synchronize()
    inf_launches = bn.inference_counts.launches
    seen = [c.launches for c in _bn_counts()]
    plain = [c.plain_calls for c in _bn_counts()]
    print(f"resnet50 output: BatchNorm launches (inference, train fwd, "
          f"train bwd) {seen}, plain-version calls {plain}")
    check(seen == [RESNET_BN_LAYERS, 0, 0], f"output launches {seen}")
    check(plain == [0, 0, 0], f"output plain-version calls {plain}")
    check(tuple(probs.shape) == (RESNET_BATCH, 1000)
          and bool(torch.isfinite(probs).all())
          and (probs.sum(-1) - 1).abs().max().item() < 1e-3,
          "output: finite probabilities of shape [128, 1000]")
    output_profile("resnet50", lambda: net.output(x),
                   r"\bbn_[a-z_]+(kernel|finalize)", "BatchNorm", name_card)

    def logits():
        with torch.no_grad():
            acts, _ = net._forward(net.params, net.net_state, {"input": x})
        return acts

    acts = logits()
    fwd_flops = _forward_flops(net, acts)
    # each BatchNorm keeps one [M, C] tensor for its backward (x here, x̂
    # in the reference); a step must read x and write y forward, read x
    # and g and write dx backward
    bn_elems = sum(acts[n.inputs[0]].numel() for n in net.conf.nodes
                   if isinstance(n.layer, BatchNormalization))
    bn_bytes = 5 * bn_elems * 2
    print(f"resnet50 BatchNorm: {bn_elems} input elements over the "
          f"{RESNET_BN_LAYERS} layers, {bn_elems * 2 / 1e9:.3f} GB saved "
          f"for the backward in bfloat16; least bytes a train step "
          f"{bn_bytes / 1e9:.3f} GB = {bn_bytes / HBM_BYTES_PER_S * 1e3:.3f} "
          f"ms at 3.35 TB/s")
    k_logits = acts["fc"].float()
    del acts
    helpers.enable_helpers(False)
    try:
        b_logits = logits()["fc"].float()
    finally:
        helpers.enable_helpers(True)
    err = _scaled_err(k_logits, b_logits)
    agree = (k_logits.argmax(-1) == b_logits.argmax(-1)).sum().item()
    print(f"resnet50 logits, kernels vs built-in path: max abs err "
          f"{_abs_err(k_logits, b_logits):.3e} over max |logit| "
          f"{b_logits.abs().max().item():.3f} = {err:.3e} (tol "
          f"{RESNET_LOGITS_TOL}); argmax agrees on {agree}/{RESNET_BATCH} "
          f"(at least {RESNET_BATCH - RESNET_ARGMAX_MISSES})")
    check(err <= RESNET_LOGITS_TOL, f"resnet50 logits {err}")
    check(agree >= RESNET_BATCH - RESNET_ARGMAX_MISSES,
          f"resnet50 argmax agrees on {agree}/{RESNET_BATCH}")
    del k_logits, b_logits, probs
    torch.cuda.empty_cache()

    def loss_of(params):
        return net._loss_fn(params, net.net_state, x, y, None)

    with torch.no_grad():
        k_loss = float(loss_of(net.params)[0])
        helpers.enable_helpers(False)
        try:
            b_loss = float(loss_of(net.params)[0])
        finally:
            helpers.enable_helpers(True)
    loss_rel = abs(k_loss - b_loss) / abs(b_loss)
    print(f"resnet50: first-step loss in bfloat16, kernels {k_loss:.6f} vs "
          f"built-in {b_loss:.6f} (rel {loss_rel:.3e}, tol {LOSS_RTOL})")
    check(loss_rel <= LOSS_RTOL, f"resnet50 bf16 first-step loss {loss_rel}")
    # gradients in float32: in bfloat16 the lower layers' gradients at
    # initialisation are mostly rounding, on the built-in path as on the
    # kernels' (the BatchNorm backward cancels), so only a float32 run
    # can hold the two paths to each other
    bf16_conf = net.conf
    net.conf = dataclasses.replace(bf16_conf, compute_dtype=None)
    try:
        first_step_check("resnet50 (float32)", net, loss_of)
    finally:
        net.conf = bf16_conf

    steps = WARM_STEPS + TIMED_STEPS
    start = {k: {s: v.clone() for s, v in st.items()}
             for k, st in net.net_state.items()}
    for c in _bn_counts():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        losses.append(net.score_value)      # reads the loss: waits for it
        step_s.append(time.perf_counter() - t0)
    launches = [c.launches for c in _bn_counts()]
    plain = [c.plain_calls for c in _bn_counts()]
    want = [0, RESNET_BN_LAYERS * steps, RESNET_BN_LAYERS * steps]
    print(f"resnet50 train: BatchNorm launches over {steps} steps "
          f"(inference, train fwd, train bwd) {launches}, expected {want}; "
          f"plain-version calls {plain}")
    check(launches == want, f"launches {launches} == {want}")
    check(plain == [0, 0, 0], f"plain-version calls {plain} == 0")
    check(all(np.isfinite(losses)), f"losses finite {losses}")
    stats = [(k, s, v) for k, st in net.net_state.items()
             for s, v in st.items()]
    check(all(bool(torch.isfinite(v).all()) for _, _, v in stats),
          "running stats finite")
    check(all(not torch.equal(v, start[k][s]) for k, s, v in stats),
          "every running stat moved")
    med = float(np.median(step_s[WARM_STEPS:]))
    util = 3.0 * fwd_flops / med / PEAK_OPS[torch.bfloat16]
    print(f"resnet50 train: losses {[round(v, 6) for v in losses]}")
    print(f"resnet50 train: step median {med * 1e3:.3f} ms over "
          f"{TIMED_STEPS} steps (after {WARM_STEPS} warm-up); "
          f"{RESNET_BATCH / med:.1f} images/s; analytic-FLOP utilisation "
          f"{util:.4f} of 989 TFLOP/s ({3 * fwd_flops / 1e12:.3f} TFLOP a "
          f"step, 3 x forward); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{name_card}]")
    step_profile("resnet50", net, x, y, r"\bbn_[a-z_]+(kernel|finalize)",
                 "BatchNorm", name_card)
    return inf_launches, launches[1], launches[2]


def output_profile(what, call, kernel_re, label, name_card):
    """Where one ``output`` call's time goes: device busy against host
    wall, and the share of the kernels whose names match ``kernel_re``."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    ours = [e for e in ev if re.search(kernel_re, e.key)]
    ours_ms = sum(e.self_device_time_total for e in ours) / 1e3
    check(ours_ms > 0, f"the profiled {what} output ran the {label} kernels")
    print(f"{what} output (profiled): host wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f}) "
          f"in {sum(e.count for e in ev)} device operations; {label} "
          f"kernels {ours_ms:.3f} ms ({ours_ms / busy_ms:.3f} of busy) in "
          f"{sum(e.count for e in ours)} launches [{name_card}]")


def step_profile(what, net, x, y, kernel_re, label, name_card):
    """Where one train step's time goes: device busy against host wall,
    the share of the kernels whose names match ``kernel_re``, copy
    kernels, then the host's operations in a second traced step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    check(busy_ms > 0, "the profiler saw device time")
    ours = [e for e in ev if re.search(kernel_re, e.key)]
    ours_ms = sum(e.self_device_time_total for e in ours) / 1e3
    copies = [e for e in ev if "copy" in e.key.lower()]
    print(f"{what} step (profiled): host wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f}) "
          f"in {sum(e.count for e in ev)} device operations; {label} "
          f"kernels {ours_ms:.3f} ms ({ours_ms / busy_ms:.3f} of busy) in "
          f"{sum(e.count for e in ours)} launches; copy kernels "
          f"{sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms in "
          f"{sum(e.count for e in copies)} launches [{name_card}]")
    check(ours_ms > 0, f"the profiled {what} step ran the {label} kernels")
    for e in sorted(ours, key=lambda e: -e.self_device_time_total):
        print(f"  {label}: {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:100]}")
    for e in sorted(copies, key=lambda e: -e.self_device_time_total)[:4]:
        print(f"  copy: {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:100]}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  top: {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:100]}")

    # the host's side: one more step with the host's operations traced
    # too (the tracing adds its own cost to the host time it reports)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(x, y)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    host_ms = sum(e.self_cpu_time_total for e in ev) / 1e3
    launch = [e for e in ev if e.key == "cudaLaunchKernel"]
    print(f"{what} step host side (traced): self host time {host_ms:.3f} "
          f"ms; cudaLaunchKernel {sum(e.count for e in launch)} calls, "
          f"{sum(e.self_cpu_time_total for e in launch) / 1e3:.3f} ms "
          f"[{name_card}]")
    for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  host: {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")


# ------------------------------------------------------------ phase 7, LRN
def lrn_case(name, seed, shape, dtype, n, flush, name_card):
    """The two LRN kernels on one NHWC shape, as [N·H·W, C].  x is wide
    enough (std 30) that the window term moves s by a fifth at alpha
    1e-4."""
    b, h, w, c = shape
    m = b * h * w
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(m, c, generator=g, device="cuda") * 30).to(dtype)
    gy = torch.randn(m, c, generator=g, device="cuda").to(dtype)
    prm = dict(LRN, n=n)
    y = lrn.lrn_fwd_2d(x, **prm)
    dx = lrn.lrn_bwd_2d(x, gy, **prm)
    ry = lrn.lrn_fwd_plain(x, **prm)
    rdx = lrn.lrn_bwd_plain(x, gy, **prm)
    torch.cuda.synchronize()
    errs = {"fwd": _scaled_err(y, ry), "bwd": _scaled_err(dx, rdx)}
    abs_errs = {"fwd": _abs_err(y, ry), "bwd": _abs_err(dx, rdx)}
    for k, err in errs.items():
        check(err <= TOL[dtype], f"lrn[{name}] {k}: kernel vs plain {err} > "
                                 f"{TOL[dtype]}")
    del y, dx, rdx
    calls = {
        "fwd": (lambda: lrn.lrn_fwd_2d(x, **prm),
                lambda: lrn.lrn_fwd_plain(x, **prm)),
        "bwd": (lambda: lrn.lrn_bwd_2d(x, gy, **prm),
                lambda: lrn.lrn_bwd_plain(x, gy, **prm)),
    }
    ms = {k: time_ms(kern, flush) for k, (kern, _) in calls.items()}
    plain_ms = {k: time_ms(plain, flush, iters=KERNEL_ITERS)
                for k, (_, plain) in calls.items()}

    # yardstick the port never calls: F.local_response_norm on the NCHW
    # tensor (its own layout), alpha times n (it divides by the window);
    # its window is asymmetric for an even n, so odd n only
    lib_ms, lib_err = {"fwd": None, "bwd": None}, None
    if n % 2:
        x4 = x.view(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        g4 = gy.view(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        xl = x4.requires_grad_()
        lib = lambda: F.local_response_norm(
            xl, n, alpha=prm["alpha"] * n, beta=prm["beta"], k=prm["k"])
        out = lib()
        lib_err = _scaled_err(out.permute(0, 2, 3, 1).reshape(m, c), ry)
        lib_ms = {"fwd": time_ms(lib, flush),
                  "bwd": time_ms(lambda: torch.autograd.grad(
                      out, xl, g4, retain_graph=True), flush)}
        del out, xl, x4, g4
    del ry
    torch.cuda.empty_cache()

    # least time: each tensor read or written once, or the kernels'
    # float32 operations (the window's 2n+1 products and sums, the power
    # and the scaling: 2(2h+1) + 6 forward, 3(2h+1) + 14 backward) at the
    # float32 rate whatever x's type, whichever is larger
    esz, win = x.element_size(), 2 * (n // 2) + 1
    bounds = {"fwd": _bound(2 * m * c * esz, m * c * (2 * win + 6),
                            torch.float32),
              "bwd": _bound(3 * m * c * esz, m * c * (3 * win + 14),
                            torch.float32)}
    lib_txt = ("n/a (even n)" if lib_err is None else f"{lib_err:.3e}")
    print(f"lrn[{name}] [{m}, {c}] {str(dtype)[6:]} n={n}: err fwd "
          f"{errs['fwd']:.3e}, bwd {errs['bwd']:.3e} (scaled by max abs; "
          f"tol {TOL[dtype]:g}); F.local_response_norm fwd err {lib_txt} "
          f"[{name_card}]")
    print(f"lrn[{name}] " + "; ".join(
        f"{k} {ms[k]:.4f} ms (bound {bounds[k][0]:.5f} ms, {bounds[k][1]}; "
        f"plain {plain_ms[k]:.4f} ms, F.local_response_norm "
        + ("n/a" if lib_ms[k] is None else f"{lib_ms[k]:.4f} ms") + ")"
        for k in ("fwd", "bwd")) + f" [{name_card}]")
    return {k: dict(err=abs_errs[k], ms=ms[k], plain_ms=plain_ms[k],
                    lib_ms=lib_ms[k], bound=bounds[k]) for k in ms}


def lrn_kernel_phase(flush, name_card):
    return {name: lrn_case(name, 500 + 10 * i, shape, dtype, n, flush,
                           name_card)
            for i, (name, shape, dtype, n) in enumerate(LRN_CASES)}


# -------------------------------------------------- phase 8, AlexNet
def _sequential_flops(net, batch) -> int:
    """Multiply-adds x 2 of every convolution and dense layer of the
    forward, from the shapes the config infers."""
    t, total = net.conf.input_type, 0
    for i, layer in enumerate(net.layers):
        if i in net.conf.preprocessors:
            t = net.conf.preprocessors[i].output_type(t)
        out = layer.output_type(t)
        if isinstance(layer, ConvolutionLayer):
            kh, kw = layer.kernel_size
            total += (2 * out.height * out.width * out.channels * kh * kw
                      * layer.n_in)
        elif isinstance(layer, DenseLayer):
            total += 2 * layer.n_in * layer.n_out
        t = out
    return total * batch


def _lrn_counts():
    return (lrn.fwd_counts, lrn.bwd_counts)


def alexnet_phase(name_card):
    net = alexnet(device="cuda", **ALEXNET)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(ALEXNET_BATCH, 224, 224, 3).astype(
        np.float32), device="cuda")
    y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
        rs.randint(0, 1000, ALEXNET_BATCH)], device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(net.params))
    print(f"alexnet: {n_params} params, {ALEXNET_LRN_LAYERS} LRN layers, "
          f"batch {ALEXNET_BATCH}x224x224x3 bf16")
    check(n_params == 50844008, f"alexnet params {n_params}")

    # output() through the forward kernel
    for c in _lrn_counts():
        c.reset()
    probs = net.output(x)
    torch.cuda.synchronize()
    out_launches = [c.launches for c in _lrn_counts()]
    plain = [c.plain_calls for c in _lrn_counts()]
    print(f"alexnet output: LRN launches (forward, backward) {out_launches},"
          f" plain-version calls {plain}")
    check(out_launches == [ALEXNET_LRN_LAYERS, 0],
          f"output launches {out_launches}")
    check(plain == [0, 0], f"output plain-version calls {plain}")
    check(tuple(probs.shape) == (ALEXNET_BATCH, 1000)
          and bool(torch.isfinite(probs).all())
          and (probs.sum(-1) - 1).abs().max().item() < 1e-3,
          "output: finite probabilities of shape [128, 1000]")

    def logits(helpers_on):
        helpers.enable_helpers(helpers_on)
        try:
            with torch.no_grad():
                pre, _, _ = net._forward(net.params, x)
        finally:
            helpers.enable_helpers(True)
        return pre.float()

    # bfloat16: at initialisation the logits are small (max about 0.2)
    # and close together, and the built-in path rounds every LRN step to
    # bfloat16 (2 + alpha * sum loses the window term), so an image whose
    # top two logits lie within the paths' difference may flip: such a
    # near-tie is counted apart.  float32 compute holds the argmax itself.
    k_logits, b_logits = logits(True), logits(False)
    err = _scaled_err(k_logits, b_logits)
    diff = (k_logits - b_logits).abs().max().item()
    kcls, bcls = k_logits.argmax(-1), b_logits.argmax(-1)
    agree = (kcls == bcls).sum().item()
    gap = b_logits.max(-1).values - b_logits.gather(1, kcls[:, None])[:, 0]
    ties = ((kcls != bcls) & (gap <= diff)).sum().item()
    bf16_conf = net.conf
    net.conf = dataclasses.replace(bf16_conf, compute_dtype=None)
    try:
        k32, b32 = logits(True), logits(False)
    finally:
        net.conf = bf16_conf
    err32 = _scaled_err(k32, b32)
    agree32 = (k32.argmax(-1) == b32.argmax(-1)).sum().item()
    print(f"alexnet logits, kernels vs built-in path: bfloat16 max abs err "
          f"{diff:.3e} over max |logit| {b_logits.abs().max().item():.3f} = "
          f"{err:.3e} (tol {ALEXNET_LOGITS_TOL}), argmax agrees on "
          f"{agree}/{ALEXNET_BATCH} and {ties} more are near-ties (top-two "
          f"gap <= {diff:.3e}); float32 {err32:.3e} (tol "
          f"{TOL[torch.float32]:g}), argmax agrees on {agree32}/"
          f"{ALEXNET_BATCH} (at least "
          f"{ALEXNET_BATCH - ALEXNET_ARGMAX_MISSES} each); bfloat16 against "
          f"float32: kernels {_scaled_err(k_logits, k32):.3e}, built-in "
          f"{_scaled_err(b_logits, b32):.3e}")
    check(err <= ALEXNET_LOGITS_TOL, f"alexnet logits {err}")
    check(agree + ties >= ALEXNET_BATCH - ALEXNET_ARGMAX_MISSES,
          f"alexnet bf16 argmax agrees on {agree}/{ALEXNET_BATCH}, {ties} "
          "near-ties")
    check(err32 <= TOL[torch.float32], f"alexnet float32 logits {err32}")
    check(agree32 >= ALEXNET_BATCH - ALEXNET_ARGMAX_MISSES,
          f"alexnet float32 argmax agrees on {agree32}/{ALEXNET_BATCH}")
    del k_logits, b_logits, k32, b32, probs

    # one dropout key for both paths: its masks are drawn from the key's
    # seed on the card, and LRN draws nothing, so the paths drop the same
    # units
    key = torch.Generator().manual_seed(2024)

    def loss_of(params):
        return net._loss_fn(params, x, y, key)

    with torch.no_grad():
        k_loss = float(loss_of(net.params)[0])
        helpers.enable_helpers(False)
        try:
            b_loss = float(loss_of(net.params)[0])
        finally:
            helpers.enable_helpers(True)
    loss_rel = abs(k_loss - b_loss) / abs(b_loss)
    print(f"alexnet: first-step loss in bfloat16, kernels {k_loss:.6f} vs "
          f"built-in {b_loss:.6f} (rel {loss_rel:.3e}, tol {LOSS_RTOL})")
    check(loss_rel <= LOSS_RTOL, f"alexnet bf16 first-step loss {loss_rel}")
    net.conf = dataclasses.replace(bf16_conf, compute_dtype=None)
    try:
        first_step_check("alexnet (float32)", net, loss_of, floor=True)
    finally:
        net.conf = bf16_conf

    fwd_flops = _sequential_flops(net, ALEXNET_BATCH)
    lrn_elems = [ALEXNET_BATCH * 54 * 54 * 96, ALEXNET_BATCH * 26 * 26 * 256]
    lrn_bytes = 5 * sum(lrn_elems) * 2
    print(f"alexnet LRN: {sum(lrn_elems)} input elements over the 2 layers; "
          f"least bytes a train step {lrn_bytes / 1e9:.3f} GB = "
          f"{lrn_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s")

    steps = WARM_STEPS + TIMED_STEPS
    for c in _lrn_counts():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        losses.append(net.score_value)      # reads the loss: waits for it
        step_s.append(time.perf_counter() - t0)
    launches = [c.launches for c in _lrn_counts()]
    plain = [c.plain_calls for c in _lrn_counts()]
    want = [ALEXNET_LRN_LAYERS * steps] * 2
    print(f"alexnet train: LRN launches over {steps} steps (forward, "
          f"backward) {launches}, expected {want}; plain-version calls "
          f"{plain}")
    check(launches == want, f"launches {launches} == {want}")
    check(plain == [0, 0], f"plain-version calls {plain} == 0")
    check(all(np.isfinite(losses)), f"losses finite {losses}")
    med = float(np.median(step_s[WARM_STEPS:]))
    util = 3.0 * fwd_flops / med / PEAK_OPS[torch.bfloat16]
    print(f"alexnet train: losses {[round(v, 6) for v in losses]}")
    print(f"alexnet train: step median {med * 1e3:.3f} ms over "
          f"{TIMED_STEPS} steps (after {WARM_STEPS} warm-up); "
          f"{ALEXNET_BATCH / med:.1f} images/s; analytic-FLOP utilisation "
          f"{util:.4f} of 989 TFLOP/s ({3 * fwd_flops / 1e12:.3f} TFLOP a "
          f"step, 3 x forward); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{name_card}]")
    step_profile("alexnet", net, x, y, r"\blrn_(fwd|bwd)_kernel", "LRN",
                 name_card)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    name_card = card()
    print(name_card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    pin_fp32_precision()
    t0 = time.perf_counter()
    build_kernels()
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = kernel_phase(flush, name_card)
    flash, prologue = train_kernel_phase(flush, name_card)
    bn_rows = bn_kernel_phase(flush, name_card)
    lrn_rows = lrn_kernel_phase(flush, name_card)
    del flush
    torch.cuda.empty_cache()
    launches = engine_phase(name_card)
    torch.cuda.empty_cache()
    train_launches = train_phase(name_card)
    torch.cuda.empty_cache()
    bn_launches = resnet_phase(name_card)
    torch.cuda.empty_cache()
    lrn_launches = alexnet_phase(name_card)
    d = rows["decode"]
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/helpers/csrc/paged_attention.cu",
        "replaces": "deeplearning4j_tpu/helpers/paged_attention.py:191",
        "launches": launches, "max_abs_err": d["err"], "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["lib_ms"]}]
    flash_src = "deeplearning4j_tpu_torch/helpers/csrc/flash_attention.cu"
    for (name, row, replaces), n in zip([
            ("flash_attention_fwd", flash["fwd"], "flash_attention.py:125"),
            ("flash_attention_dq", flash["dq"], "flash_attention.py:244"),
            ("flash_attention_dkv", flash["dkv"], "flash_attention.py:271"),
            ("dropout_residual_norm", prologue, "fused_epilogue.py:62")],
            train_launches):
        kernels.append({
            "name": name, "route": "cuda",
            "source": (flash_src if name.startswith("flash") else
                       "deeplearning4j_tpu_torch/helpers/csrc/"
                       "fused_epilogue.cu"),
            "replaces": f"deeplearning4j_tpu/helpers/{replaces}",
            "launches": n, "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["lib_ms"]})
    stem = bn_rows["stem_bf16"]
    for (name, key, line), n in zip([
            ("batch_norm_inference", "inf", 131),
            ("batch_norm_train_fwd", "fwd", 188),
            ("batch_norm_train_bwd", "bwd", 204)], bn_launches):
        row = stem[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/helpers/csrc/batch_norm.cu",
            "replaces": f"deeplearning4j_tpu/helpers/pallas_ops.py:{line}",
            "launches": n, "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["lib_ms"]})
    lrn1 = lrn_rows["lrn1_bf16"]
    for (name, key, line), n in zip([("lrn_fwd", "fwd", 65),
                                     ("lrn_bwd", "bwd", 72)], lrn_launches):
        row = lrn1[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/helpers/csrc/lrn.cu",
            "replaces": f"deeplearning4j_tpu/helpers/pallas_ops.py:{line}",
            "launches": n, "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["lib_ms"]})
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

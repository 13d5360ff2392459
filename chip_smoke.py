"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught):

1. Build every CUDA kernel of the serving and training paths from the
   sources in this checkout (``nvcc``, one process per source, all
   started together), and print each kernel's registers and shared
   memory as ``ptxas`` reports them; the float32 flash forward, paged
   decode, BatchNorm's two reductions and LRN's vector kernels must spill
   nothing.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, and time the kernel, the plain version and a
   library yardstick (which the port never calls: ``gather_pages`` +
   ``scaled_dot_product_attention`` for paged decode, SDPA forward and
   backward for flash attention (bfloat16, float16 and float32 cases),
   ``F.layer_norm`` for the prologue (bfloat16, float32, float16),
   ``F.batch_norm`` for BatchNorm),
   beside the least time the card could take (the bytes the call must
   move at 3.35 TB/s, or its operations at the peak rate for their type,
   whichever is larger).  Each flash case prints the kernels its calls
   take (``fa.kernel_path``); a bfloat16 or float16 case at D = 64 or 128
   must take wgmma for the forward, dQ and dK/dV, a float32 one tf32x3
   for all three (bounded at a third of the TF32 rate, with the CUDA
   cores' bound printed beside it), and the delta its dQ hands to dK/dV
   must match the torch reduction ``_row_delta``.  Paged decode runs at
   the engine's shapes and at contexts up to 4096 keys, where its split
   over the key range has the most blocks to merge.
3. Serve the transformer char-LM at full width (vocab 128, d_model 1024,
   8 heads, 8 layers, bfloat16, seeded random weights) through the port's
   ``GenerationEngine`` (16 slots, pages of 16, context 512): 16
   concurrent greedy requests of 64 new tokens from 4 client threads,
   then the same 16 sampled (temperature 0.8, top_k 20, a fixed seed
   each).  Twice: through the captured CUDA graphs the engine runs by
   default (one for decode, one per prefill bucket, captured at start and
   never again: the capture count is checked after the warm-up and after
   serving), and through ``GenerationPrograms(capture=False)``, the same
   programs run eagerly.  Greedy and sampled tokens must be identical
   between the two.  The captured engine serves the greedy requests once
   more, the counts at 0, under ``torch.profiler``, whose
   ``paged_decode_kernel`` launches must be layers x calls (the wrapper's
   count ticks where a launch is recorded into a graph, not on replay):
   that count is the kernels line's.  Each mode prints its
   decode-step median, TTFT p50/p99, tokens/s, and a profiled window of
   full-batch decode steps: host wall, device busy, idle share and
   device operations a step.  The first prefill's logits are then checked
   against the gather oracle.
   Then ``generate`` at the same width (batch 16, prompt 64, 448 steps:
   64 + 448 - 1 = 511 positions of the linear cache's 512): greedy ids of
   the captured loop must equal ``sample_sequence``'s (the host loop over
   ``rnn_time_step``), a second call must capture nothing, and the first
   replayed step's log-probabilities are held against the loop's; then
   the rolling cache (2 kv heads, window 128, wrapped three times) the
   same way.  Sampled ``generate`` (float32, where the top logits do not
   tie) gives the same ids for the same seed, others for another, the
   greedy ids at top_k=1, and ``sample_sequence``'s ids with the same
   seed (step i of both reads noise slice i) in at least 15 of 16 rows:
   a row may part where two perturbed scores lie within the rounding of
   log-probabilities against logits; a wrong noise slice parts every
   row.
4. Train the same model at full width (batch 8, T = 2048, Adam at 1e-3,
   ``bench.py``'s batch: random ids from ``RandomState(0)``, labels the
   one-hot of the ids rolled by one).  The first step's loss and
   per-layer gradients are held against the built-in path
   (``enable_helpers(False)``).  Then 2 warm-up and 5 timed ``fit`` steps
   in each mode from one state (``fit_modes``): eagerly (the nets'
   internal switch ``_capture`` off), eagerly again, and through the
   captured CUDA graph that ``fit`` replays by default.  Eager, the
   wrappers count 8 forward, 8 dQ, 8 dK/dV and 16 prologue launches a
   step; captured, one step's worth at the warm-up and one at the
   capture (the counts tick where a launch is recorded, not on replay),
   the graph holds one step's, and there is one capture from the first
   step on.  If the two eager runs agree bit for bit, the captured run
   must equal them bit for bit (losses, params, updater state, running
   stats); else the leaves that differ are named and the three runs are
   repeated with ``cudnn.deterministic``, and if the eager runs still
   differ the captured one is held to twice their largest difference.
   Each mode prints its step median, tokens/s, analytic-FLOP
   utilisation and the spread of its timed steps, then two steps under
   ``torch.profiler`` (host wall, busy, idle share; the flash kernels
   must be the routes' own, ``flash_dq_wgmma`` and the like, 8 a step
   each and 16 prologue: those profiled launches of the captured mode
   are the kernels line's) and one with the host traced (no
   ``_row_delta`` reduction: delta comes from the dQ kernel).  Then the
   same in float32, the zoo default (no ``compute_dtype``), whose
   profiled steps must run ``flash_fwd_tf32``, ``flash_dq_tf32`` and
   ``flash_dkv_tf32``.
5. Hold the three BatchNorm kernels (training forward, training
   backward, inference) against their plain versions at ResNet-50's
   shapes (bfloat16; a float32 and a float16 case, ragged C, and gamma
   and beta in bfloat16 as the layer passes them), and time them beside
   ``F.batch_norm`` (cuDNN, on channels_last views) and their bound.
6. ResNet-50 as a ComputationGraph at full width (224x224x3, 1000
   classes, batch 128, bfloat16, Nesterov at 0.1, ``bench.py``'s batch:
   ``RandomState(0)`` images in [0, 1) and one-hot labels; seeded random
   weights).  ``output`` eagerly (the inference kernel once per
   BatchNorm layer, 53) and captured (two calls: a warm-up and capture,
   then a replay, both equal to the eager probabilities bit for bit),
   each mode profiled over two calls (53 inference kernels a call); the
   logits are held against the built-in path (``enable_helpers(False)``:
   the logits and their argmax); the first step's loss (bfloat16) and
   per-node gradients (float32 compute, where they are not rounding) are
   held against the built-in path; then ``fit_modes`` as in 4 (53
   training-forward and 53 training-backward wrapper launches a step,
   finite losses, running stats that moved) and each mode's two profiled
   steps, which must launch two BatchNorm kernels for each of those calls
   (212 a step: the reduction and the elementwise pass), split by pass
   (moments, grad sums, apply, dx).
7. Hold the two LRN kernels (forward, backward) against their plain
   versions at AlexNet's shapes (``[373248, 96]`` and ``[86528, 256]``
   in bfloat16; a float32, a float16, a ragged C = 130, a C = 3 < n and
   an n = 7 case), each on the route it must take (``lrn.route``: the
   vector kernels for AlexNet's shapes, the staged ones for C = 130 and
   C = 3), and time them beside ``F.local_response_norm`` (odd n only,
   its alpha times n: cuDNN's convention divides alpha by the window)
   and their bound.
8. AlexNet as a MultiLayerNetwork at full width (zoo ``alexnet``:
   224x224x3, 1000 classes, batch 128, bfloat16, Nesterov at 0.01 with
   l2 5e-4; ``RandomState(0)`` images in [0, 1) and one-hot labels;
   seeded random weights).  ``output`` eagerly (two LRN forward
   launches) and captured, equal bit for bit; the logits are held
   against the built-in path (logits and argmax); the first step's loss
   (bfloat16) and per-layer gradients (float32 compute) are held against
   the built-in path with the same dropout key; the two dropout masks of
   a step are drawn in a captured graph from the device keys of the
   net's next two steps and held against the eager draws from host keys
   of the same seeds (equal; the two steps' differ), and the draw is
   timed; then ``fit_modes`` (2 forward and 2 backward LRN launches a
   step) and each mode's profiled steps, which must run the vector
   route's kernels 4 times a step (``lrn_fwd_vec``, ``lrn_bwd_vec``),
   with their time by layer.
9. LeNet (zoo ``lenet``, MNIST-shaped: 784 inputs, 10 classes, float32,
   batch 128, ``RandomState(0)`` host batches): ``fit_modes`` over 7
   batches; then three passes over 24 batches by eager ``fit``, captured
   ``fit`` and ``fit_scanned(scan_steps=8)`` from one state, the third
   pass timed (ms a step each); ``fit_scanned`` must equal captured
   ``fit`` bit for bit (under ``cudnn.deterministic`` if ``fit_modes``
   found the eager runs apart) with one capture.
10. The GravesLSTM char-LM (zoo ``graves_lstm_char_lm``,
   ``BASELINE.md:31``: 2x200, vocab 77, RMSProp at 0.1, TBPTT 50,
   float32; batch 128, T 50, ``bench.py``'s batch: ``RandomState(0)``
   characters, one-hot, the next character as label).  It reaches no
   kernel of the port: its matmuls are cuBLAS's, the rest elementwise.
   The first step's loss and per-layer gradients against the CPU's on
   the same weights (full float32 matmuls on both); ``fit_modes`` (no
   wrapper launches; captured equal to eager bit for bit); both modes
   profiled over two steps and host-traced (``cudaLaunchKernel`` a step
   eager against one ``cudaGraphLaunch``).  Two batches of T 210 (TBPTT
   windows 50, 50, 50, 50, 10) captured and eager from one state: five
   iterations a batch, two programs captured, bit for bit.  ``generate``
   over 16 streams (prompt 16, 112 steps), greedy and sampled: the
   captured loop (the LSTMs' (h, c) its graph state) equal to the eager
   decode function, and to ``sample_sequence`` in at least 15 of 16
   rows; ms a token each; ``rnn_time_step`` fed in chunks (16, 1, 47,
   64 steps) against one ``output`` over the 128, on the zoo's fresh
   weights (the trained ones' differences printed by timestep: the
   recurrence carries a rounding difference of cuBLAS's shapes from
   step to step).  Then the same
   layers as a ``ComputationGraph`` whose head reads the last step
   (``LastTimeStepVertex``): two ``fit`` steps captured and eager, bit
   for bit.
11. Print the kernels line, then ``{"ok": true, "device": ...}`` last.

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
from deeplearning4j_tpu_torch.generation.programs import GenerationPrograms
from deeplearning4j_tpu_torch.helpers import batch_norm as bn
from deeplearning4j_tpu_torch.helpers import flash_attention as fa
from deeplearning4j_tpu_torch.helpers import fused_epilogue as fe
from deeplearning4j_tpu_torch.helpers import lrn
from deeplearning4j_tpu_torch.helpers import paged_attention as pa
from deeplearning4j_tpu_torch.models.common import seed_stream_caches
from deeplearning4j_tpu_torch.models.decode import (
    build_decode_fn, generate, named_layers_of,
)
from deeplearning4j_tpu_torch.models.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.interop import params_from_numpy
from deeplearning4j_tpu_torch.models.sequential import tree_leaves
from deeplearning4j_tpu_torch.models.vertices import LastTimeStepVertex
from deeplearning4j_tpu_torch.models.zoo import (
    alexnet, graves_lstm_char_lm, lenet, resnet50, transformer_char_lm,
)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers.attention import gather_pages
from deeplearning4j_tpu_torch.nn.layers.convolution import ConvolutionLayer
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.dense import (
    DenseLayer, EmbeddingLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTM
from deeplearning4j_tpu_torch.utils.sampling import (
    sample_sequence, step_noise,
)

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
# float32 products on the tensor cores in 3xTF32: three TF32 products (495
# TFLOP/s dense) per float32 one; the rate of the tf32x3 flash route only
TF32X3_OPS = 495e12 / 3
TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
LOGITS_TOL = 0.1    # bf16 logits, kernel vs gather oracle, 8 layers
MODEL = dict(vocab_size=128, d_model=1024, n_heads=8, layers=8,
             max_cache=512, compute_dtype="bfloat16", seed=12345)
ENGINE = dict(slots=16, page_size=16, max_context=512, prefill_buckets=(16,))
PS, MAXP, PAGES = 16, 32, 16 * 32 + 1
# the long-context decode case's own table: 256 pages of 16, 4096 keys
LONG_PS, LONG_MAXP = 16, 256
LONG_PAGES = 16 * LONG_MAXP + 1
CLIENTS, PER_CLIENT, NEW_TOKENS = 4, 4, 64
SAMPLED = dict(temperature=0.8, top_k=20)    # the sampled requests
# generate: batch, prompt, steps (64 + 448 - 1 = 511 <= max_cache 512);
# the rolling cache's window wraps three times over the 448 steps
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 16, 64, 448
GEN_ROLLING = dict(n_kv_heads=2, window=128)
SPIN_CYCLES = 2_000_000     # about 1 ms of GPU clock: outlasts any enqueue
PROFILED_STEPS = 10
TRAIN_MODEL = dict(vocab_size=128, d_model=1024, n_heads=8, layers=8,
                   compute_dtype="bfloat16", seed=12345)
# the zoo default: no compute_dtype, float32 throughout
TRAIN_MODEL_F32 = {k: v for k, v in TRAIN_MODEL.items()
                   if k != "compute_dtype"}
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
LRN_CASES = [  # name, NHWC shape, dtype, n, the route it takes
    ("lrn1_bf16", (128, 54, 54, 96), torch.bfloat16, 5, "vector"),
    ("lrn2_bf16", (128, 26, 26, 256), torch.bfloat16, 5, "vector"),
    ("lrn1_f32", (128, 54, 54, 96), torch.float32, 5, "vector"),
    ("lrn2_f16", (128, 26, 26, 256), torch.float16, 5, "vector"),
    ("ragged130_bf16", (13, 77, 101, 130), torch.bfloat16, 5, "staged"),
    ("c3_bf16", (64, 55, 55, 3), torch.bfloat16, 5, "staged"),
    ("n7_bf16", (128, 26, 26, 256), torch.bfloat16, 7, "vector"),
]
# the LRN kernels of AlexNet's step (the vector route's), by name
LRN_STEP_KERNEL_RE = r"\blrn_(fwd|bwd)_vec\b"
ALEXNET = dict(compute_dtype="bfloat16", seed=12345)  # 224x224x3, 1000
ALEXNET_BATCH, ALEXNET_LRN_LAYERS = 128, 2
# logits, kernels vs built-in path: bf16 error over max |logit|, and
# images whose argmax may differ (bf16 near-ties counted apart)
ALEXNET_LOGITS_TOL, ALEXNET_ARGMAX_MISSES = 2e-2, 2
# LeNet-MNIST (BASELINE.md:29): batch, host batches, fit_scanned's window
LENET_BATCH, LENET_BATCHES, LENET_SCAN = 128, 24, 8
# the GravesLSTM char-LM (BASELINE.md:31): 2x200, vocab 77, float32,
# TBPTT windows of 50; batch 128 at T 50, and one batch of T 210 (four
# windows of 50 and one of 10)
LSTM_MODEL = dict(vocab_size=77, hidden=200, tbptt=50)
LSTM_BATCH, LSTM_T, LSTM_T_LONG = 128, 50, 210
# streaming and generate: streams, prompt, steps
LSTM_STREAMS, LSTM_PROMPT, LSTM_STEPS = 16, 16, 112
# the card's first step against the CPU's on the same weights, float32
# with full float32 matmuls on both: loss and per-layer gradients
LSTM_LOSS_RTOL, LSTM_GRAD_RTOL = 1e-5, 1e-4
# chunked rnn_time_step against one output, probabilities (float32)
LSTM_STREAM_TOL = 1e-5


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
    usage = {}      # kernel -> [registers, spill bytes], from ptxas
    for m, b in zip(modules, built):
        print(f"build {m.SOURCE.name}: {b.build_s:.1f} s -> {b.path.name}")
        entry = "?"
        for ln in b.log.splitlines():
            if "Compiling entry function" in ln:
                # the kernel's name and template arguments, from the
                # mangled symbol
                found = re.search(r"((?:flash_[a-z]+|drn|paged_decode|"
                                  r"lrn_[a-z]+)_(?:kernel|mma|wgmma|tf32|"
                                  r"vec))"
                                  r"(I\w*?E)?E"
                                  r"|(bn_[a-z_]+)(I\w*?E)?", ln)
                entry = "".join(x for x in found.groups() if x) \
                    if found else ln
            elif "Used" in ln or "spill" in ln:
                print(f"  ptxas {entry}: {ln.split(':', 1)[-1].strip()}")
                use = usage.setdefault(entry, [0, 0])
                regs = re.search(r"Used (\d+) registers", ln)
                if regs:
                    use[0] = int(regs.group(1))
                use[1] += sum(int(n) for n in
                              re.findall(r"(\d+) bytes spill", ln))
            elif "warning" in ln.lower() or "Performance Loss" in ln:
                print(f"  {ln.strip()[:200]}")
    # the float32 flash forward, paged decode, BatchNorm's two reductions
    # and LRN's vector route: registers, and no spills (a library found
    # already built has no ptxas report)
    watched = (("flash_attention.cu", "flash_fwd_tf32"),
               ("paged_attention.cu", "paged_decode_kernel"),
               ("batch_norm.cu", "bn_moments_kernel"),
               ("batch_norm.cu", "bn_grad_sums_kernel"),
               ("lrn.cu", "lrn_fwd_vec"),
               ("lrn.cu", "lrn_bwd_vec"))
    new = {k: v for k, v in usage.items()
           if k.startswith(tuple(kernel for _, kernel in watched))}
    print("build, float32 flash forward, paged decode, BatchNorm "
          "reduction and LRN vector kernels (registers, spill bytes): "
          + "; ".join(
              f"{k} {r}, {sp}" for k, (r, sp) in sorted(new.items())))
    compiled = {m.SOURCE.name for m, b in zip(modules, built) if b.log}
    for source, kernel in watched:
        check(source not in compiled
              or any(k.startswith(kernel) for k in new),
              f"ptxas reported {kernel}: {sorted(new)}")
    check(all(sp == 0 for _, sp in new.values()),
          f"those kernels spill nothing: {new}")


# ------------------------------------------------------------------ phase 2
def paged_case(seed, b, t, hq, hkv, d, dtype, start=None, ps=PS,
               maxp=MAXP, pages=PAGES):
    """Engine-shaped inputs: trash page 0; row 0 an idle slot (all-trash
    block row at position 0); the other rows at mixed positions ending in
    partly filled pages (or, with ``start``, one prompt written from
    there)."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    pk = torch.randn(pages * ps, hkv, d, generator=g)
    pv = torch.randn(pages * ps, hkv, d, generator=g)
    q = torch.randn(b, t, hq, d, generator=g)
    block = rng.permutation(np.arange(1, pages))[:b * maxp].reshape(b, maxp)
    if start is None:
        last = rng.integers(t - 1, maxp * ps, size=(b,))
        last[0] = t - 1
        block[0] = 0
    else:
        last = np.full((b,), start + t - 1)
    for i in range(b):
        block[i, int(last[i]) // ps + 1:] = 0
    qpos = (last - (t - 1))[:, None] + np.arange(t)
    return ([x.to("cuda", dtype) for x in (q, pk, pv)]
            + [torch.as_tensor(block, dtype=torch.int32, device="cuda"),
               torch.as_tensor(qpos, dtype=torch.int32, device="cuda")])


def bound_ms(q, pk, block, qpos, ps=PS):
    """Least time: the live K/V the call must read (keys up to each row's
    highest position), q, positions and block table read once, the output
    written once — or the 4*D flops per (query, key) pair at the peak rate
    of the input type — whichever is larger."""
    esz = q.element_size()
    b, t, hq, d = q.shape
    hkv = pk.shape[1]
    cap = block.shape[1] * ps
    keys = torch.clamp(qpos.max(dim=1).values + 1, max=cap)
    nbytes = (int(keys.sum()) * hkv * d * esz * 2 + 2 * q.numel() * esz
              + (block.numel() + qpos.numel()) * 4)
    pairs = int(torch.clamp(qpos + 1, max=cap).sum()) * hq
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


def library_call(q, pk, pv, block, qpos, ps=PS):
    """Yardstick: gather the paged view, then one SDPA with a boolean
    causal-by-position mask."""
    gk = gather_pages(pk, block, ps).transpose(1, 2)
    gv = gather_pages(pv, block, ps).transpose(1, 2)
    kpos = torch.arange(gk.shape[2], device=q.device)
    mask = (qpos[:, None, :, None] >= kpos)               # [B, 1, T, L]
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), gk, gv, attn_mask=mask,
        enable_gqa=q.shape[2] != pk.shape[1])
    return o.transpose(1, 2)


def kernel_phase(flush, name_card):
    long_table = dict(ps=LONG_PS, maxp=LONG_MAXP, pages=LONG_PAGES)
    cases = [
        ("decode", dict(b=16, t=1, hq=8, hkv=8, d=128), torch.bfloat16, None),
        ("prefill", dict(b=1, t=16, hq=8, hkv=8, d=128), torch.bfloat16, 0),
        ("decode_f32", dict(b=16, t=1, hq=8, hkv=8, d=128), torch.float32,
         None),
        ("decode_gqa", dict(b=16, t=1, hq=8, hkv=2, d=128), torch.bfloat16,
         None),
        ("decode_long", dict(b=16, t=1, hq=8, hkv=8, d=128, **long_table),
         torch.bfloat16, None),
    ]
    rows = {}
    for i, (name, shape, dtype, start) in enumerate(cases):
        args = paged_case(100 + i, dtype=dtype, start=start, **shape)
        ps = shape.get("ps", PS)
        out = pa.paged_decode_attention(*args, page_size=ps)
        again = pa.paged_decode_attention(*args, page_size=ps)
        ref = pa.paged_attention_plain(*args, ps)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.equal(out, again), f"{name}: two calls give the same "
                                       "bits")
        call = lambda: pa.paged_decode_attention(*args, page_size=ps)
        ms = time_ms(call, flush)
        enqueue_ms = host_ms(call)
        plain_ms = time_ms(lambda: pa.paged_attention_plain(*args, ps), flush)
        lib = library_call(*args, ps)
        lib_err = (lib.float() - ref.float()).abs().max().item()
        lib_ms = time_ms(lambda: library_call(*args, ps), flush)
        bms, by = bound_ms(args[0], args[1], args[3], args[4], ps)
        keys = int(args[4].max()) + 1
        rows[name] = dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                          bound_ms=bms, bound_by=by)
        print(f"paged_decode_attention[{name}] q{list(args[0].shape)} "
              f"{str(dtype)[6:]}, longest context {keys} keys: max_abs_err "
              f"{err:.3e} (tol {TOL[dtype]:g}), repeat bitwise equal; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms (err {lib_err:.2e}), bound {bms:.5f} ms "
              f"({by}); host enqueue {enqueue_ms:.4f} ms [{name_card}]")
        check(err <= TOL[dtype], f"{name}: kernel vs plain {err} > "
                                 f"{TOL[dtype]}")
        del args, out, again, ref, lib
    return rows


# ------------------------------------------------------------------ phase 3
def serve(eng, prompts, sampled=False):
    """The requests from ``CLIENTS`` threads, ``PER_CLIENT`` each (greedy,
    or ``SAMPLED`` with a fixed seed a request); (token lists, handles,
    wall seconds from the first submit to the last result)."""
    results = [None] * len(prompts)
    handles = [None] * len(prompts)
    errors = []
    kw = SAMPLED if sampled else {}

    def client(c):
        try:
            mine = range(c * PER_CLIENT, (c + 1) * PER_CLIENT)
            for i in mine:
                handles[i] = eng.submit(prompts[i], NEW_TOKENS,
                                        seed=100 + i, **kw)
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
    check(not errors and not any(th.is_alive() for th in threads),
          f"client errors {errors!r}")
    check(all(r is not None and len(r) == NEW_TOKENS for r in results),
          "every request returns 64 tokens")
    return results, handles, wall


def paged_profile(fn):
    """``fn()`` under ``torch.profiler``; (its result, the paged kernel's
    launches on the device, the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if "paged_decode_kernel" in e.key)
    return out, n


def engine_mode(net, capture, prompts, name_card):
    """Serve the requests greedy (timed), then sampled, through captured
    programs (the engine's default) or ``capture=False``; with capture
    also once more greedy, the counts at 0, under the profiler, whose
    paged-kernel launches must be layers x calls.  The mode's launches
    are that profiled count (captured) or the wrapper's over warm-up and
    the timed serve (eager).  Returns the mode's tokens and numbers."""
    label = "captured" if capture else "eager"
    layers = MODEL["layers"]
    pa.counts.reset()
    eng = GenerationEngine(net, **ENGINE)
    if not capture:
        p = eng.programs
        eng.programs = GenerationPrograms(
            net, slots=p.slots, pages_per_slot=p.pages_per_slot,
            page_size=p.page_size, num_pages=p.num_pages,
            prefill_buckets=p.prefill_buckets, capture=False)
    progs = eng.programs
    t_build = time.perf_counter()
    eng.start()
    print(f"engine [{label}] start (warm-up and captures included): "
          f"{time.perf_counter() - t_build:.2f} s; captures "
          f"{progs.captures}, paged launches a graph "
          f"{progs.graph_launches()}")
    programs = len(progs.prefill_buckets) + 1
    check(progs.captures == (programs if capture else 0),
          f"{label}: captures after warm-up {progs.captures}")
    check(all(n == layers for n in progs.graph_launches().values()),
          f"every graph holds {layers} paged launches")
    calls0 = progs.prefill_calls + progs.decode_calls
    greedy, handles, wall = serve(eng, prompts)
    calls = progs.prefill_calls + progs.decode_calls - calls0
    plain = pa.counts.plain_calls
    steps = sorted(eng.decode_step_s)
    ttft = np.asarray([h.ttft_s for h in handles]) * 1e3
    row = dict(tokens=greedy, tok_s=sum(len(r) for r in greedy) / wall,
               step_ms=float(np.median(steps)) * 1e3,
               ttft50=float(np.percentile(ttft, 50)),
               ttft99=float(np.percentile(ttft, 99)))
    check(plain == 0, f"plain-version calls {plain} == 0")
    print(f"engine [{label}]: {len(greedy)} requests x {NEW_TOKENS} tokens "
          f"in {wall:.3f} s; {calls} calls ({progs.decode_calls} decode "
          f"steps in all); plain calls {plain}; {row['tok_s']:.1f} "
          f"tokens/s; TTFT p50 {row['ttft50']:.2f} ms, p99 "
          f"{row['ttft99']:.2f} ms; decode step median {row['step_ms']:.3f} "
          f"ms over {len(steps)} steps [{name_card}]")
    if capture:
        # the wrapper counts a launch where it is recorded into a graph,
        # not where a replay runs it: the served requests once more, with
        # the counts at 0, and the launches counted by the profiler
        pa.counts.reset()
        calls0 = progs.prefill_calls + progs.decode_calls
        (again, _, _), launches = paged_profile(lambda: serve(eng, prompts))
        calls = progs.prefill_calls + progs.decode_calls - calls0
        print(f"engine [{label}], profiled serve: {calls} replays, "
              f"paged_decode_kernel launches {launches} (layers x calls "
              f"{layers * calls}), wrapper launches {pa.counts.launches}")
        check(pa.counts.launches == 0 and pa.counts.plain_calls == 0,
              "the profiled serve runs replays only")
        check(launches == layers * calls, f"profiled launches {launches} "
                                          f"== {layers} x {calls}")
        check(again == greedy, "the profiled serve's tokens")
    else:
        # warm-up and the timed serve, by the wrapper's count
        launches = pa.counts.launches
        print(f"engine [{label}]: paged launches {launches} (layers x "
              f"calls {layers * (calls0 + calls)})")
        check(launches == layers * (calls0 + calls),
              f"eager launches {launches} == layers x calls")
    check(launches > 0, f"{label}: the paged kernel ran")
    row["launches"] = launches
    row["sampled"], _, _ = serve(eng, prompts, sampled=True)
    eng.stop()
    check(progs.captures == (programs if capture else 0),
          f"{label}: no capture while serving ({progs.captures})")
    print(f"engine [{label}]: captures {progs.captures}, replays "
          f"{progs.replays}, stats {eng.stats()['captures']}/"
          f"{eng.stats()['replays']}")
    row.update(decode_profile(progs, label, name_card))
    return row, progs


def engine_phase(name_card):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"],
                            int(rng.integers(4, 13))).tolist()
               for _ in range(CLIENTS * PER_CLIENT)]
    net = transformer_char_lm(device="cuda", **MODEL)
    captured, progs = engine_mode(net, True, prompts, name_card)
    eager, _ = engine_mode(net, False, prompts, name_card)
    check(captured["tokens"] == eager["tokens"],
          "greedy tokens, captured == eager programs")
    check(captured["sampled"] == eager["sampled"],
          "sampled tokens (temperature 0.8, top_k 20), captured == eager")
    differ = sum(a != b for a, b in zip(captured["sampled"],
                                        captured["tokens"]))
    print(f"engine: greedy and sampled tokens identical between captured "
          f"and eager programs ({differ} of {len(prompts)} sampled "
          f"requests differ from greedy)")
    for what, key in (("decode step median ms", "step_ms"),
                      ("tokens/s", "tok_s"), ("TTFT p50 ms", "ttft50"),
                      ("TTFT p99 ms", "ttft99"),
                      ("profiled step wall ms", "wall_ms"),
                      ("profiled step busy ms", "busy_ms"),
                      ("profiled idle share", "idle"),
                      ("device operations a step", "ops"),
                      ("unprofiled step wall ms", "plain_wall"),
                      ("unprofiled step device span ms", "span_ms")):
        print(f"engine {what}: captured {captured[key]:.4f}, eager "
              f"{eager[key]:.4f} [{name_card}]")

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
    return captured["launches"]


def decode_profile(progs, label, name_card):
    """Where a decode step's time goes: ``PROFILED_STEPS`` full-batch
    calls (every slot live, at the positions the served requests reach)
    under ``torch.profiler``, the device's busy time per step against
    the host wall per step.  A captured step must launch the paged
    kernel once per layer."""
    from torch.profiler import ProfilerActivity, profile

    s, maxp = progs.slots, progs.pages_per_slot
    block = (1 + np.arange(s * maxp, dtype=np.int32)).reshape(s, maxp)
    pos = np.random.default_rng(1).integers(8, 72, s).astype(np.int32)
    zi, zf = np.zeros(s, np.int32), np.zeros(s, np.float32)
    keys = np.zeros((s, 2), np.uint32)

    def step():
        progs.decode(block, pos, zi, keys, zi, zf, zi,
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
    attn = [e for e in ev if "paged_decode_kernel" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3 \
        / PROFILED_STEPS
    attn_n = sum(e.count for e in attn)
    # the feed-forward blocks' LayerNorm opens with the fused prologue
    drn_n = sum(e.count for e in ev if "drn_kernel" in e.key)
    ops = sum(e.count for e in ev
              if e.self_device_time_total > 0) / PROFILED_STEPS
    check(attn_ms > 0, "the profiled decode steps ran the kernel")
    check(attn_n == MODEL["layers"] * PROFILED_STEPS,
          f"{label}: paged launches {attn_n} over {PROFILED_STEPS} steps")
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"decode step [{label}] top device time a step: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3 / PROFILED_STEPS:.4f}"
        f" ms x{e.count // PROFILED_STEPS}" for e in top))
    # unprofiled: the host wall of a call, and its device span (CUDA
    # events around the staging copies, the program and the read-back)
    t0 = time.perf_counter()
    for _ in range(PROFILED_STEPS):
        step()
    plain_wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    spans = []
    for _ in range(PROFILED_STEPS):
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        s_ev.record()
        step()
        e_ev.record()
        e_ev.synchronize()
        spans.append(s_ev.elapsed_time(e_ev))
    span_ms = float(np.median(spans))
    print(f"decode step [{label}] unprofiled: host wall {plain_wall:.3f} ms "
          f"a call, device span {span_ms:.3f} ms (events; busy "
          f"{busy_ms:.3f} of it in kernels) [{name_card}]")
    idle = 1 - busy_ms / wall_ms
    print(f"decode step [{label}] (profiled, {PROFILED_STEPS} steps, {s} "
          f"live slots): host wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms (idle share {idle:.3f}) in {ops:.0f} device "
          f"operations, paged attention kernel {attn_ms:.4f} ms in "
          f"{attn_n / PROFILED_STEPS:.0f} launches, fused prologue "
          f"{drn_n / PROFILED_STEPS:.0f} launches [{name_card}]")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle=idle, ops=ops,
                plain_wall=plain_wall, span_ms=span_ms)


# ---------------------------------------------------------------- phase 3b
def generate_phase(name_card, what, **model_kw):
    """``generate`` (the captured loop) against ``sample_sequence`` (the
    host loop over ``rnn_time_step``) at full width: greedy ids equal,
    ms a generated token, the first replayed step's log-probabilities
    against the loop's; a second call captures nothing."""
    b, t, steps = GEN_BATCH, GEN_PROMPT, GEN_STEPS
    net = transformer_char_lm(device="cuda", **{**MODEL, **model_kw})
    prompt = np.random.default_rng(5).integers(0, MODEL["vocab_size"],
                                                (b, t))
    t0 = time.perf_counter()
    got = generate(net, prompt, steps, temperature=0.0)
    first_s = time.perf_counter() - t0
    (gen,) = net._graph_cache.values()
    t0 = time.perf_counter()
    again = generate(net, prompt, steps, temperature=0.0)
    gen_s = time.perf_counter() - t0
    check(gen.captures == 1 and np.array_equal(again, got),
          f"{what}: a second call replays the same graph "
          f"(captures {gen.captures})")
    t0 = time.perf_counter()
    ref = sample_sequence(net, prompt, steps, temperature=0.0)
    loop_s = time.perf_counter() - t0
    same = int((got == ref).all(axis=1).sum())
    print(f"generate [{what}] batch {b}, prompt {t}, {steps} steps: "
          f"captured {gen_s * 1e3 / steps:.4f} ms a token (first call, "
          f"capture included, {first_s:.2f} s), eager loop "
          f"{loop_s * 1e3 / steps:.4f} ms a token; {same} of {b} rows "
          f"identical; replays {gen.replays} [{name_card}]")
    check(np.array_equal(got, ref), f"{what}: greedy generate == "
                                    "sample_sequence")
    # the first replayed step's log-probabilities against the loop's
    generate(net, prompt, 2, temperature=0.0)
    two = [g for k, g in net._graph_cache.items() if k[1] == 2][0]
    lp = torch.log_softmax(two.step_logits, dim=-1)
    net.rnn_clear_previous_state()
    net.rnn_time_step(prompt)
    probs = net.rnn_time_step(got[:, 0])
    diff = (lp - torch.log(probs.clamp_min(1e-30))).abs().max().item()
    print(f"generate [{what}]: first replayed step, log-probabilities vs "
          f"the loop's: max_abs_diff {diff:.3e}")
    check(np.isfinite(diff) and diff <= LOGITS_TOL,
          f"{what}: first-step log-probabilities {diff}")


def generate_phases(name_card):
    generate_phase(name_card, "linear")
    torch.cuda.empty_cache()
    generate_phase(name_card, "rolling", **GEN_ROLLING)
    torch.cuda.empty_cache()
    # sampled: in float32 (the zoo default), where the top two logits of
    # a step do not tie; in bfloat16 they do, and top_k=1 then keeps both
    # (the reference's kept set), so it need not be the argmax
    f32 = {k: v for k, v in MODEL.items() if k != "compute_dtype"}
    net = transformer_char_lm(device="cuda", **f32)
    prompt = np.random.default_rng(5).integers(
        0, MODEL["vocab_size"], (GEN_BATCH, GEN_PROMPT))
    greedy = generate(net, prompt, GEN_STEPS, temperature=0.0)
    kw = dict(temperature=0.8, top_k=20, rng=11)
    t0 = time.perf_counter()
    a = generate(net, prompt, GEN_STEPS, **kw)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = generate(net, prompt, GEN_STEPS, **kw)
    ms = (time.perf_counter() - t0) * 1e3 / GEN_STEPS
    c = generate(net, prompt, GEN_STEPS, **{**kw, "rng": 12})
    top1 = generate(net, prompt, GEN_STEPS, **{**kw, "top_k": 1})
    loop = sample_sequence(net, prompt, GEN_STEPS, **kw)
    rows = int((loop == a).all(axis=1).sum())
    parted = [int(np.argmax(r)) for r in (loop != a) if r.any()]
    print(f"generate [sampled, float32] vs sample_sequence, same seed: "
          f"{rows} of {GEN_BATCH} rows identical, rows parting at steps "
          f"{parted}, {int((loop == a).sum())} of {a.size} ids equal")
    check(rows >= GEN_BATCH - 1, f"sampled generate == sample_sequence in "
                                 f"{rows} of {GEN_BATCH} rows")
    print(f"generate [sampled, float32] temperature 0.8, top_k 20: "
          f"{ms:.4f} ms a token (first call {first_s:.2f} s); same seed "
          f"same ids {np.array_equal(a, b)}, another seed differs in "
          f"{int((a != c).sum())} of {a.size} ids, top_k=1 == greedy "
          f"{np.array_equal(top1, greedy)}; {len(net._graph_cache)} "
          f"captured loops [{name_card}]")
    check(a.shape == greedy.shape and np.array_equal(a, b),
          "sampled generate: the same seed gives the same ids")
    check(not np.array_equal(a, c), "another seed gives other ids")
    check(np.array_equal(top1, greedy), "top_k=1 == greedy")


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


def _bound(nbytes, ops, dtype, peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (peak or PEAK_OPS[dtype])
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
    if dtype == torch.float32 and d in (64, 128):
        check(paths == {"fwd": "tf32x3", "dq": "tf32x3", "dkv": "tf32x3"},
              f"flash[{name}] takes tf32x3 for the forward, dQ and dK/dV: "
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

    # the delta dQ hands to dK/dV (the kernel's own on the wgmma and
    # tf32x3 routes)
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
    if dtype == torch.float32:
        # which kernels SDPA's float32 backward runs (the yardstick's
        # route, read off the profiler)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, (qs, ks, vs), gdo, retain_graph=True)
            torch.cuda.synchronize()
        names = sorted({e.key[:120] for e in prof.key_averages()
                        if e.self_device_time_total > 0})
        print(f"flash[{name}] SDPA bwd kernels: {names}")
    del out, qs, ks, vs

    esz = q.element_size()
    pairs = _live_pairs(t, causal, window) * b * h
    tensor_bytes = q.numel() * esz
    row_bytes = b * h * t * 4                         # lse or delta, f32
    # q, k, v, dO and O read, dq written; lse read, delta written
    work = {"fwd": (4 * tensor_bytes + row_bytes, 4 * d * pairs),
            "dq": (6 * tensor_bytes + 2 * row_bytes,
                   6 * d * pairs + 2 * d * b * h * t),
            "dkv": (6 * tensor_bytes + 2 * row_bytes, 8 * d * pairs)}
    # at the rate of the route's products: 3xTF32 on tf32x3
    bounds = {kn: _bound(*work[kn], dtype,
                         TF32X3_OPS if paths[kn] == "tf32x3" else None)
              for kn in work}
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
    if "tf32x3" in paths.values():
        cores = {kn: _bound(*work[kn], dtype)[0] for kn in work}
        print(f"flash[{name}] tf32x3 bounds at {TF32X3_OPS / 1e12:.0f} "
              f"TFLOP/s: fwd {bounds['fwd'][0]:.5f} ms, dQ "
              f"{bounds['dq'][0]:.5f} ms, dK/dV {bounds['dkv'][0]:.5f} ms; "
              f"at the CUDA cores' {PEAK_OPS[torch.float32] / 1e12:.0f} "
              f"TFLOP/s: fwd {cores['fwd']:.5f} ms, dQ {cores['dq']:.5f} "
              f"ms, dK/dV {cores['dkv']:.5f} ms; fwd {fwd_ms:.4f} ms, "
              f"{fwd_ms / lib_fwd_ms:.3f} x SDPA fwd; dQ + dK/dV "
              f"{dq_ms + dkv_ms:.4f} ms, "
              f"{(dq_ms + dkv_ms) / lib_bwd_ms:.3f} x SDPA bwd [{name_card}]")
    return {
        "fwd": dict(err=errs["o"], ms=fwd_ms, plain_ms=pfwd_ms,
                    lib_ms=lib_fwd_ms, bound=bounds["fwd"],
                    path=paths["fwd"]),
        "dq": dict(err=abs_errs["dq"], ms=dq_ms, plain_ms=pbwd_ms,
                   lib_ms=lib_bwd_ms, bound=bounds["dq"], path=paths["dq"]),
        "dkv": dict(err=max(abs_errs["dk"], abs_errs["dv"]), ms=dkv_ms,
                    plain_ms=pbwd_ms, lib_ms=lib_bwd_ms,
                    bound=bounds["dkv"], path=paths["dkv"]),
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
             True, None),
            ("full_f32", full, torch.float32, False, None),
            ("window256_f32", full, torch.float32, True, 256),
            ("ragged1000_f32", (TRAIN_BATCH, 1000, 8, 128), torch.float32,
             True, None),
            ("causal_f32_d64", (TRAIN_BATCH, TRAIN_T, 8, 64), torch.float32,
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
    return flash["causal_bf16"], flash["causal_f32"], prologue["prologue_bf16"]


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


# ------------------------------------- captured against eager training
def twin(net, capture):
    """A copy of ``net`` (params, updater and layer state, iteration, and
    its key stream's position, which ``clone`` starts afresh) whose
    ``fit`` replays captured graphs (``capture``) or runs eagerly."""
    t = net.clone()
    t._keys._gen.set_state(net._keys._gen.get_state())
    t._capture = capture
    return t


def named_state(net):
    """(name, tensor) of every param, updater-state and layer-state
    leaf."""
    out = []

    def walk(tree, name):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{name}/{k}")
        else:
            out.append((name, tree))

    for part in ("params", "updater_state", "net_state"):
        walk(getattr(net, part), part)
    return out


def state_gaps(a, b):
    """{leaf: max |a - b|} over the leaves where two nets differ."""
    return {n: (x.float() - y.float()).abs().max().item()
            for (n, x), (_, y) in zip(named_state(a), named_state(b))
            if not torch.equal(x, y)}


def fit_steps(net, batches, steps):
    """``steps`` ``fit`` calls over ``batches`` in turn, each timed on the
    host to the loss read: (losses, seconds, captures after each)."""
    losses, secs, caps = [], [], []
    for i in range(steps):
        x, y = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        losses.append(net.score_value)      # reads the loss: waits for it
        secs.append(time.perf_counter() - t0)
        graphs = net._step_graphs
        caps.append(graphs.captures if graphs is not None else 0)
    return losses, secs, caps


def _loss_gap(a, b):
    return max(abs(x - y) for x, y in zip(a, b))


def modes_agree(what, runs, rerun):
    """Captured against eager training: ``runs`` is [(net, losses)] of two
    eager runs and a captured one over the same steps from one state.  If
    the eager runs agree bit for bit, the captured run must equal them
    bit for bit.  If not, the leaves that differ are named and all three
    run again with ``cudnn.deterministic`` (``rerun()`` gives the new
    triple): bit for bit if the eager runs then agree, else the captured
    run held to twice their largest difference.  Returns the verdict."""
    (e1, l1), (e2, l2), (c, lc) = runs
    gaps = state_gaps(e1, e2)
    if not gaps and l1 == l2:
        got = state_gaps(c, e1)
        print(f"{what}: two eager runs agree bit for bit; captured against "
              f"eager: {len(got)} of {len(named_state(c))} leaves differ, "
              f"losses {'equal' if lc == l1 else 'differ'}")
        check(not got and lc == l1, f"{what}: captured == eager bit for "
                                    f"bit ({sorted(got)[:4]})")
        return "bit for bit"
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
    print(f"{what}: two eager runs differ in {len(gaps)} of "
          f"{len(named_state(e1))} leaves (largest {top}), losses by "
          f"{_loss_gap(l1, l2):.3e}; again with cudnn.deterministic")
    torch.backends.cudnn.deterministic = True
    try:
        (e1, l1), (e2, l2), (c, lc) = rerun()
    finally:
        torch.backends.cudnn.deterministic = False
    gaps, got = state_gaps(e1, e2), state_gaps(c, e1)
    if not gaps and l1 == l2:
        print(f"{what}: under cudnn.deterministic two eager runs agree bit "
              f"for bit; captured against eager: {len(got)} leaves differ")
        check(not got and lc == l1, f"{what}: captured == eager bit for "
                                    f"bit, deterministic ({sorted(got)[:4]})")
        return "bit for bit under cudnn.deterministic"
    bound = 2 * max(gaps.values(), default=0.0)
    worst = max(got.values(), default=0.0)
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
    print(f"{what}: under cudnn.deterministic two eager runs still differ "
          f"in {len(gaps)} leaves (largest {top}); captured against eager "
          f"{worst:.3e} (bound {bound:.3e}), losses "
          f"{_loss_gap(lc, l1):.3e} (bound {2 * _loss_gap(l1, l2):.3e})")
    check(worst <= bound and _loss_gap(lc, l1) <= 2 * _loss_gap(l1, l2),
          f"{what}: captured within twice the eager spread")
    return f"within twice the eager spread ({worst:.3e} <= {bound:.3e})"


def _launch_counts():
    return {n: (c.launches, c.plain_calls)
            for n, c in helpers.kernel_counts().items()}


def fit_modes(what, net, batches, per_step, name_card, items=None,
              flops=None, peak=None, unit="images"):
    """The phase's 2 warm-up and 5 timed ``fit`` steps twice from one
    state: eagerly (``_capture`` off; run twice, for the comparison) and
    through the captured graph (``net`` itself, the default).  Eager, the
    wrappers count ``per_step`` launches a step; captured, they count
    one step's worth at the warm-up and one at the capture, the graph
    holds ``per_step``, and there is one capture from the first step on.
    The modes agree as ``modes_agree`` says.  Prints each mode's median,
    ``items``/s, analytic-FLOP utilisation and the spread of its timed
    steps.  Returns (eager net, {mode: numbers})."""
    steps = WARM_STEPS + TIMED_STEPS
    init = twin(net, False)
    eager, eager2 = twin(net, False), twin(net, False)
    net._capture = True
    # an output graph the phase captured before counts apart
    caps0 = net._step_graphs.captures if net._step_graphs else 0
    runs, out = [], {}
    for label, n in (("eager", eager), ("eager again", eager2),
                     ("captured", net)):
        for c in helpers.kernel_counts().values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, caps = fit_steps(n, batches, steps)
        counts = _launch_counts()
        runs.append((n, losses))
        check(all(np.isfinite(losses)), f"{what} [{label}] losses finite")
        check(all(p == 0 for _, p in counts.values()),
              f"{what} [{label}]: plain-version calls {counts}")
        if label == "eager again":
            continue
        factor = steps if label == "eager" else 2
        got = {k: l for k, (l, _) in counts.items() if l}
        want = {k: factor * v for k, v in per_step.items()}
        print(f"{what} [{label}]: wrapper launches over {steps} steps "
              f"{got}, expected {want}; captures after each step {caps}")
        check(got == want, f"{what} [{label}] launches {got} == {want}")
        if label == "captured":
            held = [v for k, v in net._step_graphs.graph_launches().items()
                    if k[0] == "train"]
            print(f"{what} [captured]: the graph holds {held}; "
                  f"{net._step_graphs.replays} replays")
            check(caps == [caps0 + 1] * steps,
                  f"{what}: one capture, at the first step ({caps})")
            check(held == [per_step], f"{what}: graph launches {held}")
        timed = secs[WARM_STEPS:]
        med = float(np.median(timed))
        row = dict(ms=med * 1e3, spread=(min(timed) * 1e3,
                                         max(timed) * 1e3),
                   losses=losses,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        line = (f"{what} [{label}]: step median {med * 1e3:.3f} ms over "
                f"{TIMED_STEPS} steps (after {WARM_STEPS} warm-up), timed "
                f"steps {row['spread'][0]:.3f}-{row['spread'][1]:.3f} ms")
        if items is not None:
            line += f"; {items / med:.1f} {unit}/s"
        if flops is not None:
            row["util"] = flops / med / peak
            line += (f"; analytic-FLOP utilisation {row['util']:.4f} of "
                     f"{peak / 1e12:.0f} TFLOP/s ({flops / 1e12:.3f} TFLOP "
                     f"a step)")
        print(line + f"; peak memory {row['peak_gb']:.2f} GB [{name_card}]")
        print(f"{what} [{label}]: losses {[round(v, 6) for v in losses]}")
        out[label] = row

    def rerun():
        nets = [twin(init, False), twin(init, False), twin(init, True)]
        return [(n, fit_steps(n, batches, steps)[0]) for n in nets]

    out["agree"] = modes_agree(what, runs, rerun)
    print(f"{what}: captured against eager: {out['agree']}; median "
          f"{out['captured']['ms']:.3f} vs {out['eager']['ms']:.3f} ms "
          f"[{name_card}]")
    del init, eager2, runs
    torch.cuda.empty_cache()
    return eager, out


def train_phase(name_card, model=TRAIN_MODEL, what="train"):
    """``fit`` on the char-LM at full width, captured and eager; ``model``
    without a compute_dtype trains in float32, whose flash kernels must
    run on tf32x3."""
    net = transformer_char_lm(device="cuda", **model)
    vocab = model["vocab_size"]
    ids = np.random.RandomState(0).randint(0, vocab, (TRAIN_BATCH, TRAIN_T))
    x = torch.as_tensor(ids, device="cuda")
    y = torch.as_tensor(np.eye(vocab, dtype=np.float32)[np.roll(ids, -1, 1)],
                        device="cuda")

    # the first step through the kernels against the built-in path
    first_step_check(what, net,
                     lambda params: net._loss_fn(params, x, y, None))

    layers = model["layers"]
    tokens = TRAIN_BATCH * TRAIN_T
    heads, d_model = model["n_heads"], model["d_model"]
    flops = (6.0 * _matmul_params(net) * tokens
             + 12.0 * layers * heads * TRAIN_T * TRAIN_T
             * (d_model // heads) * TRAIN_BATCH * 0.5)
    dtype = getattr(torch, model.get("compute_dtype") or "float32")
    per_step = {"flash_fwd": layers, "flash_dq": layers,
                "flash_dkv": layers, "prologue": 2 * layers}
    eager, rows = fit_modes(what, net, [(x, y)], per_step, name_card,
                            items=tokens, flops=flops,
                            peak=PEAK_OPS[dtype], unit="tokens")
    check(rows["captured"]["losses"][-1] < rows["captured"]["losses"][0],
          f"loss falls: {rows['captured']['losses']}")
    paths = {kn: fa.kernel_path(kn, dtype, d_model // heads)
             for kn in ("fwd", "dq", "dkv")}
    train_profile(eager, x, y, name_card, f"{what} [eager]", paths, layers)
    launches = train_profile(net, x, y, name_card, f"{what} [captured]",
                             paths, layers)
    return launches


PROFILED_FIT_STEPS = 2      # fit steps under the profiler, each mode


def _profile_fit(net, x, y, steps=PROFILED_FIT_STEPS):
    """``steps`` fit calls under the CUDA profiler: (events with device
    time, host wall ms a step, device busy ms a step)."""
    from torch.profiler import ProfilerActivity, profile

    net.fit(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            net.fit(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / steps
    check(busy_ms > 0, "the profiler saw device time")
    return ev, wall_ms, busy_ms, prof


def _host_trace(what, net, x, y, name_card):
    """One more step with the host's operations traced (the tracing adds
    its own cost to the host time it reports); the events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(x, y)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    host_ms = sum(e.self_cpu_time_total for e in ev) / 1e3
    launch = [e for e in ev if e.key == "cudaLaunchKernel"]
    graphs = sum(e.count for e in ev if e.key == "cudaGraphLaunch")
    print(f"{what} step host side (traced): self host time {host_ms:.3f} "
          f"ms; cudaLaunchKernel {sum(e.count for e in launch)} calls, "
          f"{sum(e.self_cpu_time_total for e in launch) / 1e3:.3f} ms; "
          f"cudaGraphLaunch {graphs} [{name_card}]")
    return ev


def train_profile(net, x, y, name_card, what, paths, layers):
    """Where a train step's time goes, over ``PROFILED_FIT_STEPS`` steps:
    the device's busy time by kernel against the step's host wall.  Each
    flash kernel must run on its route in ``paths`` (``flash_dq_tf32``
    and the like), ``layers`` times a step, and the prologue twice that.
    Returns the profiled launches (fwd, dQ, dK/dV, prologue)."""
    n = PROFILED_FIT_STEPS
    ev, wall_ms, busy_ms, _ = _profile_fit(net, x, y, n)
    ours = {"flash fwd": "flash_fwd_", "flash dQ": "flash_dq_",
            "flash dK/dV": "flash_dkv_", "prologue": "drn_kernel"}
    share = {k: sum(e.self_device_time_total for e in ev if pat in e.key)
             / 1e3 / n for k, pat in ours.items()}
    counts = {k: sum(e.count for e in ev if pat in e.key)
              for k, pat in ours.items()}
    # each flash kernel's time is all on its route's kernel
    suffix = {"wgmma": "wgmma", "tf32x3": "tf32", "mma_sync": "mma",
              "cuda_cores": "kernel"}
    for kn, label in (("fwd", "flash fwd"), ("dq", "flash dQ"),
                      ("dkv", "flash dK/dV")):
        name = f"flash_{kn}_{suffix[paths[kn]]}"
        on_route = sum(e.self_device_time_total for e in ev
                       if name in e.key) / 1e3 / n
        check(on_route > 0 and on_route == share[label],
              f"{what}: the step's {label} ran {name} only ({on_route} of "
              f"{share[label]} ms)")
    want = {"flash fwd": layers * n, "flash dQ": layers * n,
            "flash dK/dV": layers * n, "prologue": 2 * layers * n}
    check(counts == want, f"{what}: profiled launches {counts} == {want}")
    print(f"{what} step (profiled, {n} steps): host wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}) in "
          f"{sum(e.count for e in ev) / n:.0f} device operations a step; "
          f"launches {counts} [{name_card}]")
    print(f"{what} step kernels ({paths['fwd']} fwd, {paths['dq']} dQ, "
          f"{paths['dkv']} dK/dV): " + ", ".join(
              f"{k} {v:.3f} ms ({v / busy_ms:.3f})" for k, v in share.items())
          + f"; the four together {sum(share.values()) / busy_ms:.3f} of "
          f"busy; flash {sum(share.values()) - share['prologue']:.3f} ms "
          f"({(sum(share.values()) - share['prologue']) / busy_ms:.3f})")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  top: {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"x{e.count // n:<5d} {e.key[:90]}")

    # the host's side: its launches, and no delta reduction
    # (``_row_delta`` labels itself flash_row_delta)
    hev = _host_trace(what, net, x, y, name_card)
    row_delta = sum(e.count for e in hev if e.key == "flash_row_delta")
    print(f"{what} step: _row_delta reductions {row_delta}")
    check(row_delta == 0, f"the {what} step ran {row_delta} _row_delta "
                          "reductions")
    return [counts[k] for k in ours]


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


# BatchNorm's CUDA kernels a training call launches: the reduction (moments
# or grad sums, the merge folded in) and the elementwise pass
BN_KERNELS_PER_TRAIN_CALL = 2
BN_KERNEL_RE = r"\bbn_[a-z_]+(kernel|finalize)"
# the elementwise pass's mode (its last template argument) by name
BN_MODES = {"0": "apply", "1": "dx", "2": "inference"}


def bn_pass(key: str) -> str:
    """The BatchNorm pass of a profiled kernel name."""
    if "finalize" in key:
        return "finalize"
    if "bn_moments" in key:
        return "moments"
    if "bn_grad_sums" in key:
        return "grad sums"
    mode = re.search(r"bn_elementwise_kernel<[^<>]*?(\d+)>", key)
    return BN_MODES.get(mode.group(1), "elementwise") if mode else key


def bn_passes(events):
    """{pass: (device ms, launches)} of the profiled BatchNorm kernels among
    ``events`` (``torch.profiler`` key averages)."""
    split = {}
    for e in events:
        if e.self_device_time_total > 0 and re.search(BN_KERNEL_RE, e.key):
            ms, n = split.get(bn_pass(e.key), (0.0, 0))
            split[bn_pass(e.key)] = (ms + e.self_device_time_total / 1e3,
                                     n + e.count)
    return split


def bn_pass_split(events, label="BatchNorm", prof=None):
    """Print profiled BatchNorm kernels' device ms and launches by pass, a
    step (``PROFILED_FIT_STEPS`` profiled); returns the totals."""
    split = bn_passes(events)
    n = PROFILED_FIT_STEPS
    print(f"  {label} by pass, a step: " + "; ".join(
        f"{k} {ms / n:.3f} ms in {c // n} launches"
        for k, (ms, c) in sorted(split.items(), key=lambda kv: -kv[1][0])))
    return split


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

    # output() through the inference kernel: eagerly, then captured (the
    # default): the first call warms and captures, later ones replay
    eager = twin(net, False)
    for c in _bn_counts():
        c.reset()
    probs = eager.output(x)
    torch.cuda.synchronize()
    seen = [c.launches for c in _bn_counts()]
    plain = [c.plain_calls for c in _bn_counts()]
    print(f"resnet50 output [eager]: BatchNorm launches (inference, train "
          f"fwd, train bwd) {seen}, plain-version calls {plain}")
    check(seen == [RESNET_BN_LAYERS, 0, 0], f"output launches {seen}")
    check(plain == [0, 0, 0], f"output plain-version calls {plain}")
    check(tuple(probs.shape) == (RESNET_BATCH, 1000)
          and bool(torch.isfinite(probs).all())
          and (probs.sum(-1) - 1).abs().max().item() < 1e-3,
          "output: finite probabilities of shape [128, 1000]")
    for c in _bn_counts():
        c.reset()
    cap_probs = [net.output(x), net.output(x)]
    graphs = net._step_graphs
    seen = [c.launches for c in _bn_counts()]
    print(f"resnet50 output [captured]: wrapper launches {seen} (warm-up "
          f"and capture), captures {graphs.captures}, replays "
          f"{graphs.replays}, the graph holds "
          f"{list(graphs.graph_launches().values())}")
    check(seen == [2 * RESNET_BN_LAYERS, 0, 0] and graphs.captures == 1
          and graphs.replays == 1, "captured output: one capture")
    check(all(torch.equal(p, probs) for p in cap_probs),
          "resnet50 output: captured == eager bit for bit")
    output_profile("resnet50 [eager]", lambda: eager.output(x),
                   BN_KERNEL_RE, "BatchNorm", name_card, RESNET_BN_LAYERS)
    inf_launches = output_profile(
        "resnet50 [captured]", lambda: net.output(x), BN_KERNEL_RE,
        "BatchNorm", name_card, RESNET_BN_LAYERS)
    del eager, cap_probs

    def logits():
        with torch.no_grad():
            acts, _, _ = net._forward(net.params, net.net_state,
                                      {"input": x})
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

    start = {k: {s: v.clone() for s, v in st.items()}
             for k, st in net.net_state.items()}
    per_step = {"bn_train_fwd": RESNET_BN_LAYERS,
                "bn_train_bwd": RESNET_BN_LAYERS}
    eager, rows = fit_modes("resnet50 train", net, [(x, y)], per_step,
                            name_card, items=RESNET_BATCH,
                            flops=3.0 * fwd_flops,
                            peak=PEAK_OPS[torch.bfloat16])
    stats = [(k, s, v) for k, st in net.net_state.items()
             for s, v in st.items()]
    check(all(bool(torch.isfinite(v).all()) for _, _, v in stats),
          "running stats finite")
    check(all(not torch.equal(v, start[k][s]) for k, s, v in stats),
          "every running stat moved")
    kernels = 2 * BN_KERNELS_PER_TRAIN_CALL * RESNET_BN_LAYERS
    step_profile("resnet50 [eager]", eager, x, y, BN_KERNEL_RE,
                 "BatchNorm", name_card, split=bn_pass_split,
                 launches=kernels)
    split = step_profile("resnet50 [captured]", net, x, y, BN_KERNEL_RE,
                         "BatchNorm", name_card, split=bn_pass_split,
                         launches=kernels)
    # a training call launches one reduction (moments, grad sums) each
    return inf_launches, split["moments"][1], split["grad sums"][1]


def output_profile(what, call, kernel_re, label, name_card, per_call):
    """Where ``output``'s time goes, over ``PROFILED_FIT_STEPS`` calls:
    device busy against host wall, and the share of the kernels whose
    names match ``kernel_re``, which must launch ``per_call`` times a
    call.  Returns their launches."""
    from torch.profiler import ProfilerActivity, profile

    n = PROFILED_FIT_STEPS
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / n
    ours = [e for e in ev if re.search(kernel_re, e.key)]
    ours_ms = sum(e.self_device_time_total for e in ours) / 1e3 / n
    launches = sum(e.count for e in ours)
    check(ours_ms > 0, f"the profiled {what} output ran the {label} kernels")
    check(launches == per_call * n, f"{what} output: {launches} {label} "
                                    f"launches == {per_call} x {n}")
    print(f"{what} output (profiled, {n} calls): host wall {wall_ms:.3f} "
          f"ms, device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}) in "
          f"{sum(e.count for e in ev) / n:.0f} device operations a call; "
          f"{label} kernels {ours_ms:.3f} ms ({ours_ms / busy_ms:.3f} of "
          f"busy) in {launches} launches [{name_card}]")
    return launches


def step_profile(what, net, x, y, kernel_re, label, name_card, split=None,
                 launches=None):
    """Where a train step's time goes, over ``PROFILED_FIT_STEPS`` steps:
    device busy against host wall, the share of the kernels whose names
    match ``kernel_re`` (``launches`` of them a step where given; split by
    ``split(events, label, prof)`` where given, whose result is
    returned), copy kernels, then the host's operations in a traced
    step."""
    n = PROFILED_FIT_STEPS
    ev, wall_ms, busy_ms, prof = _profile_fit(net, x, y, n)
    ours = [e for e in ev if re.search(kernel_re, e.key)]
    ours_ms = sum(e.self_device_time_total for e in ours) / 1e3 / n
    copies = [e for e in ev if "copy" in e.key.lower()]
    print(f"{what} step (profiled, {n} steps): host wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}) in "
          f"{sum(e.count for e in ev) / n:.0f} device operations a step; "
          f"{label} kernels {ours_ms:.3f} ms ({ours_ms / busy_ms:.3f} of "
          f"busy) in {sum(e.count for e in ours) / n:.0f} launches a step; "
          f"copy kernels "
          f"{sum(e.self_device_time_total for e in copies) / 1e3 / n:.3f} "
          f"ms in {sum(e.count for e in copies) / n:.0f} launches "
          f"[{name_card}]")
    check(ours_ms > 0, f"the profiled {what} step ran the {label} kernels")
    n_ours = sum(e.count for e in ours)
    check(launches is None or n_ours == launches * n,
          f"the profiled {what} steps launched {n_ours} {label} kernels, "
          f"expected {launches} x {n}")
    for e in sorted(ours, key=lambda e: -e.self_device_time_total):
        print(f"  {label}: {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"x{e.count // n:<5d} {e.key[:100]}")
    out = split(ours, label, prof) if split is not None else None
    for e in sorted(copies, key=lambda e: -e.self_device_time_total)[:4]:
        print(f"  copy: {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"x{e.count // n:<5d} {e.key[:100]}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  top: {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"x{e.count // n:<5d} {e.key[:100]}")
    hev = _host_trace(what, net, x, y, name_card)
    for e in sorted(hev, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  host: {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<5d} {e.key[:90]}")
    return out


# ------------------------------------------------------------ phase 7, LRN
def lrn_bounds(m, c, esz, n):
    """Least ms of the LRN forward and backward on [m, C] with elements of
    ``esz`` bytes: each tensor read or written once, or the kernels'
    float32 operations (the window's 2n+1 products and sums, the power
    and the scaling: 2(2h+1) + 6 forward, 3(2h+1) + 14 backward) at the
    float32 rate whatever x's type, whichever is larger."""
    win = 2 * (n // 2) + 1
    return {"fwd": _bound(2 * m * c * esz, m * c * (2 * win + 6),
                          torch.float32),
            "bwd": _bound(3 * m * c * esz, m * c * (3 * win + 14),
                          torch.float32)}


def lrn_library(x, gy, shape, prm, ry, flush, iters=30):
    """The yardstick the port never calls: ({"fwd", "bwd"} ms, error of
    its forward against ``ry``) of ``F.local_response_norm`` on the NCHW
    tensor (its own layout), alpha times n (it divides by the window);
    its window is asymmetric for an even n, so (None, None) there."""
    n, (b, h, w, c) = prm["n"], shape
    if n % 2 == 0:
        return {"fwd": None, "bwd": None}, None
    x4 = x.view(b, h, w, c).permute(0, 3, 1, 2).contiguous()
    g4 = gy.view(b, h, w, c).permute(0, 3, 1, 2).contiguous()
    xl = x4.requires_grad_()
    lib = lambda: F.local_response_norm(
        xl, n, alpha=prm["alpha"] * n, beta=prm["beta"], k=prm["k"])
    out = lib()
    err = _scaled_err(out.permute(0, 2, 3, 1).reshape(-1, c), ry)
    return {"fwd": time_ms(lib, flush, iters=iters),
            "bwd": time_ms(lambda: torch.autograd.grad(
                out, xl, g4, retain_graph=True), flush, iters=iters)}, err


def lrn_case(name, seed, shape, dtype, n, want_route, flush, name_card):
    """The two LRN kernels on one NHWC shape, as [N·H·W, C], on the route
    the case names.  x is wide enough (std 30) that the window term moves
    s by a fifth at alpha 1e-4."""
    b, h, w, c = shape
    m = b * h * w
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(m, c, generator=g, device="cuda") * 30).to(dtype)
    gy = torch.randn(m, c, generator=g, device="cuda").to(dtype)
    prm = dict(LRN, n=n)
    route = lrn.route(x, n, gy)
    check(route == want_route, f"lrn[{name}] takes the {route} route, "
                               f"expected {want_route}")
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

    lib_ms, lib_err = lrn_library(x, gy, shape, prm, ry, flush)
    del ry
    torch.cuda.empty_cache()

    bounds = lrn_bounds(m, c, x.element_size(), n)
    lib_txt = ("n/a (even n)" if lib_err is None else f"{lib_err:.3e}")
    print(f"lrn[{name}] [{m}, {c}] {str(dtype)[6:]} n={n}, {route} route: "
          f"err fwd "
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
    return {name: lrn_case(name, 500 + 10 * i, shape, dtype, n, route,
                           flush, name_card)
            for i, (name, shape, dtype, n, route) in enumerate(LRN_CASES)}


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


def lrn_layer_split(events, label, prof):
    """Print the first profiled AlexNet step's LRN kernels by layer, from
    the trace's launch order: the forward runs lrn1 then lrn2, the
    backward lrn2 then lrn1.  Returns the launches (forward, backward)
    over the profiled steps."""
    runs = sorted((e for e in prof.events() if e.self_device_time_total > 0
                   and re.search(LRN_STEP_KERNEL_RE, e.name)),
                  key=lambda e: e.time_range.start)
    fwd = [e.self_device_time_total / 1e3 for e in runs if "fwd" in e.name]
    bwd = [e.self_device_time_total / 1e3 for e in runs if "bwd" in e.name]
    want = ALEXNET_LRN_LAYERS * PROFILED_FIT_STEPS
    check(len(fwd) == len(bwd) == want,
          f"{label} launches by direction {len(fwd)}, {len(bwd)} == {want}")
    print(f"  {label} by layer: " + "; ".join(
        f"lrn{i + 1} fwd {fwd[i]:.4f} ms, bwd "
        f"{bwd[ALEXNET_LRN_LAYERS - 1 - i]:.4f} ms"
        for i in range(ALEXNET_LRN_LAYERS)))
    return len(fwd), len(bwd)


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

    # output() through the forward kernel: eagerly, then captured
    eager = twin(net, False)
    for c in _lrn_counts():
        c.reset()
    probs = eager.output(x)
    torch.cuda.synchronize()
    out_launches = [c.launches for c in _lrn_counts()]
    plain = [c.plain_calls for c in _lrn_counts()]
    print(f"alexnet output [eager]: LRN launches (forward, backward) "
          f"{out_launches}, plain-version calls {plain}")
    check(out_launches == [ALEXNET_LRN_LAYERS, 0],
          f"output launches {out_launches}")
    check(plain == [0, 0], f"output plain-version calls {plain}")
    check(tuple(probs.shape) == (ALEXNET_BATCH, 1000)
          and bool(torch.isfinite(probs).all())
          and (probs.sum(-1) - 1).abs().max().item() < 1e-3,
          "output: finite probabilities of shape [128, 1000]")
    cap_probs = [net.output(x), net.output(x)]
    check(all(torch.equal(p, probs) for p in cap_probs)
          and net._step_graphs.captures == 1,
          "alexnet output: captured == eager bit for bit, one capture")
    output_profile("alexnet [eager]", lambda: eager.output(x),
                   r"\blrn_fwd_vec\b", "LRN", name_card, ALEXNET_LRN_LAYERS)
    output_profile("alexnet [captured]", lambda: net.output(x),
                   r"\blrn_fwd_vec\b", "LRN", name_card, ALEXNET_LRN_LAYERS)
    del eager, cap_probs

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

    dropout_masks(net, name_card)
    per_step = {"lrn_fwd": ALEXNET_LRN_LAYERS, "lrn_bwd": ALEXNET_LRN_LAYERS}
    eager, rows = fit_modes("alexnet train", net, [(x, y)], per_step,
                            name_card, items=ALEXNET_BATCH,
                            flops=3.0 * fwd_flops,
                            peak=PEAK_OPS[torch.bfloat16])
    step_profile("alexnet [eager]", eager, x, y, LRN_STEP_KERNEL_RE, "LRN",
                 name_card, split=lrn_layer_split,
                 launches=2 * ALEXNET_LRN_LAYERS)
    return step_profile("alexnet [captured]", net, x, y, LRN_STEP_KERNEL_RE,
                        "LRN", name_card, split=lrn_layer_split,
                        launches=2 * ALEXNET_LRN_LAYERS)


def dropout_masks(net, name_card):
    """AlexNet's two dropout masks as a train step draws them: the layer
    keys split from the step's device key, each mask counter-based on
    the card.  Drawn in a captured graph that reads a static key, as the
    train graph does: for two steps' keys from the net's key stream, the
    replayed masks equal the eager draws from host keys of the same
    seeds, and the two steps' masks differ.  Prints what the draw costs
    a step on the card (CUDA events)."""
    from deeplearning4j_tpu_torch.backend import rng as rng_mod
    from deeplearning4j_tpu_torch.backend.device import (
        capture_graph, warm_on_side_stream,
    )

    drops = [(i, l) for i, l in enumerate(net.layers) if l.dropout > 0.0]
    n = len(net.layers)
    key = torch.zeros((), dtype=torch.int64, device="cuda")

    def draw():
        keys = rng_mod.split(key, n)
        return [rng_mod.bernoulli(keys[i], 1.0 - l.dropout,
                                  (ALEXNET_BATCH, l.n_in), "cuda")
                for i, l in drops]

    warm_on_side_stream(draw, torch.device("cuda"))
    graph, masks = capture_graph(draw)
    stream = twin(net, False)._keys      # the net's next step keys
    seeds = [rng_mod.seed_of(stream.next()) for _ in range(2)]
    drawn = []
    for seed in seeds:
        key.fill_(seed)
        graph.replay()
        host = rng_mod.split(torch.Generator().manual_seed(seed), n)
        want = [rng_mod.bernoulli(host[i], 1.0 - l.dropout,
                                  (ALEXNET_BATCH, l.n_in), "cuda")
                for i, l in drops]
        check(all(torch.equal(m, w) for m, w in zip(masks, want)),
              "alexnet: the captured masks equal the eager ones")
        drawn.append([m.clone() for m in masks])
    check(all(not torch.equal(a, b) for a, b in zip(*drawn)),
          "alexnet: two steps' masks differ")
    keep = [m.float().mean().item() for m in drawn[0]]
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    graph.replay()
    s.record()
    for _ in range(KERNEL_ITERS):
        graph.replay()
    e.record()
    e.synchronize()
    ms = s.elapsed_time(e) / KERNEL_ITERS
    print(f"alexnet dropout: masks {[(ALEXNET_BATCH, l.n_in) for _, l in drops]}"
          f" of step keys {seeds}: captured == eager, the two steps differ; "
          f"keep rates {[round(k, 4) for k in keep]}; the counter-based "
          f"draw of both masks (key split included) {ms:.4f} ms a step "
          f"[{name_card}]")
    del graph, masks, drawn


def lenet_phase(name_card):
    """LeNet (zoo ``lenet``: MNIST-shaped 784 inputs, 10 classes, float32,
    Nesterov at 0.01, l2 5e-4) at batch 128 on ``RandomState(0)`` host
    batches, the dispatch-bound configuration the reference's
    ``fit_scanned`` was written for: 7 ``fit`` steps captured and eager
    (``fit_modes``); then three passes over 24 batches by eager ``fit``,
    captured ``fit`` and ``fit_scanned(scan_steps=8)`` from one state,
    the third pass timed: ms a step for each, and ``fit_scanned``'s
    params, updater state and loss equal captured ``fit``'s bit for
    bit."""
    net = lenet(device="cuda")
    rs = np.random.RandomState(0)
    batches = [(rs.rand(LENET_BATCH, 784).astype(np.float32),
                np.eye(10, dtype=np.float32)[rs.randint(0, 10, LENET_BATCH)])
               for _ in range(LENET_BATCHES)]
    flops = 3.0 * _sequential_flops(net, LENET_BATCH)
    print(f"lenet: {net.num_params()} params, batch {LENET_BATCH}x784 "
          f"float32, {LENET_BATCHES} host batches")
    base = twin(net, True)
    _, rows = fit_modes("lenet train", net, batches, {}, name_card,
                        items=LENET_BATCH, flops=flops,
                        peak=PEAK_OPS[torch.float32])
    # where cuDNN's choices differ run to run, the comparison of
    # fit_scanned with fit runs deterministic, as fit_modes' did
    exact = rows["agree"] == "bit for bit"
    torch.backends.cudnn.deterministic = not exact
    eager, fitted, scanned = (twin(base, False), twin(base, True),
                              twin(base, True))
    del base

    def per_batch(n):
        for x, y in batches:
            n.fit(x, y)

    runs = {"eager fit": (eager, lambda: per_batch(eager)),
            "captured fit": (fitted, lambda: per_batch(fitted)),
            "fit_scanned": (scanned, lambda: scanned.fit_scanned(
                batches, scan_steps=LENET_SCAN))}
    ms, passes = {}, 3
    try:
        for label, (n, run) in runs.items():
            # two passes first: the capture, and every slot of the pinned
            # ring allocated
            for _ in range(passes - 1):
                run()
            float(n.score_value)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            float(n.score_value)
            ms[label] = (time.perf_counter() - t0) * 1e3 / LENET_BATCHES
    finally:
        torch.backends.cudnn.deterministic = False
    gaps = state_gaps(scanned, fitted)
    print(f"lenet: ms a step over {LENET_BATCHES} batches (third pass"
          f"{'' if exact else ', cudnn.deterministic'}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; fit_scanned against captured fit: {len(gaps)} leaves "
          f"differ, losses {scanned.score_value} vs {fitted.score_value}; "
          f"captures {scanned._step_graphs.captures}, replays "
          f"{scanned._step_graphs.replays} [{name_card}]")
    check(scanned.iteration == fitted.iteration == passes * LENET_BATCHES,
          "lenet: iterations")
    check(not gaps and scanned.score_value == fitted.score_value,
          f"lenet: fit_scanned == fit bit for bit ({sorted(gaps)[:4]})")
    check(scanned._step_graphs.captures == 1, "lenet: one capture")
    return ms


def _lstm_batch(rs, t):
    """``bench.py:379-382``'s batch: random characters, one-hot, labels
    the next character (the sequence rolled by one), on the card."""
    vocab = LSTM_MODEL["vocab_size"]
    ids = rs.randint(0, vocab, (LSTM_BATCH, t))
    eye = np.eye(vocab, dtype=np.float32)
    return (torch.as_tensor(eye[ids], device="cuda"),
            torch.as_tensor(eye[np.roll(ids, -1, 1)], device="cuda"))


def _cpu_twin(net):
    """``net``'s weights in a CPU network of the same configuration."""
    return params_from_numpy(
        net.conf, {k: {n: p.cpu().numpy() for n, p in v.items()}
                   for k, v in net.params.items()}, device="cpu")


def lstm_first_step(net, x, y):
    """The first step's loss and per-layer gradients on the card against
    the CPU's plain path on the same weights and batch (float32, full
    float32 matmuls on both)."""
    cpu = _cpu_twin(net)
    c_loss, c_grads = _loss_and_grads(
        net, lambda params: net._loss_fn(params, x, y, None))
    h_loss, h_grads = _loss_and_grads(
        cpu, lambda params: cpu._loss_fn(params, x.cpu(), y.cpu(), None))
    loss_rel = abs(c_loss - h_loss) / abs(h_loss)
    grad_rel = _rel_l2({k: g.cpu() for k, g in c_grads.items()}, h_grads)
    print(f"lstm: first-step loss card {c_loss:.7f} vs CPU {h_loss:.7f} "
          f"(rel {loss_rel:.3e}, tol {LSTM_LOSS_RTOL}); per-layer gradient "
          f"rel L2 {', '.join(f'{k} {v:.3e}' for k, v in grad_rel.items())}"
          f" (tol {LSTM_GRAD_RTOL})")
    check(loss_rel <= LSTM_LOSS_RTOL, f"lstm first-step loss rel {loss_rel}")
    check(all(r <= LSTM_GRAD_RTOL for r in grad_rel.values()),
          f"lstm per-layer gradient rel L2 {grad_rel}")


def lstm_profile(what, net, x, y, name_card):
    """Two profiled steps (host wall, device busy, idle share) and a
    host-traced one (``cudaLaunchKernel`` and ``cudaGraphLaunch``)."""
    ev, wall_ms, busy_ms, _ = _profile_fit(net, x, y)
    print(f"{what} step (profiled, {PROFILED_FIT_STEPS} steps): host wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}) in "
          f"{sum(e.count for e in ev) / PROFILED_FIT_STEPS:.0f} device "
          f"operations a step [{name_card}]")
    n = PROFILED_FIT_STEPS
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  top: {e.self_device_time_total / 1e3 / n:9.3f} ms  "
              f"x{e.count // n:<5d} {e.key[:90]}")
    hev = _host_trace(what, net, x, y, name_card)
    return dict(launches=sum(e.count for e in hev
                             if e.key == "cudaLaunchKernel"),
                graphs=sum(e.count for e in hev
                           if e.key == "cudaGraphLaunch"))


def lstm_tbptt(net, name_card):
    """Two batches of T 210 (windows 50, 50, 50, 50, 10) captured and
    eager from one state: five iterations a batch, two programs (one a
    window length) captured once, equal bit for bit; ms a batch."""
    rs = np.random.RandomState(1)
    batches = [_lstm_batch(rs, LSTM_T_LONG) for _ in range(2)]
    cap, eag = twin(net, True), twin(net, False)
    it0 = cap.iteration
    ms = {}
    for label, n in (("captured", cap), ("eager", eag)):
        for i, (x, y) in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n.fit(x, y)
            float(n.score_value)
            ms[(label, i)] = (time.perf_counter() - t0) * 1e3
            check(n.iteration == it0 + 5 * (i + 1),
                  f"lstm tbptt [{label}]: iteration {n.iteration} after "
                  f"batch {i}")
    graphs = cap._step_graphs
    gaps = state_gaps(cap, eag)
    print(f"lstm tbptt: 2 batches of {LSTM_BATCH}x{LSTM_T_LONG}, windows "
          f"of {LSTM_MODEL['tbptt']}: iteration {it0} -> {cap.iteration}; "
          f"captures {graphs.captures}, replays {graphs.replays}; "
          f"captured against eager: {len(gaps)} leaves differ, losses "
          f"{cap.score_value} vs {eag.score_value}; second batch captured "
          f"{ms[('captured', 1)]:.3f} ms, eager {ms[('eager', 1)]:.3f} ms "
          f"(first, with the captures, {ms[('captured', 0)]:.3f}) "
          f"[{name_card}]")
    check(graphs.captures == 2, f"lstm tbptt: two programs captured "
                                f"({graphs.captures})")
    check(not gaps and cap.score_value == eag.score_value,
          f"lstm tbptt: captured == eager bit for bit ({sorted(gaps)[:4]})")


def lstm_stream(net, name_card):
    """``generate`` (the captured loop, (h, c) as graph state) against the
    eager decode function on the card, greedy and sampled, and against
    ``sample_sequence`` (the host loop over ``rnn_time_step``); ms a
    token.  Returns the prompt followed by the greedy ids."""
    b, t, steps = LSTM_STREAMS, LSTM_PROMPT, LSTM_STEPS
    vocab = LSTM_MODEL["vocab_size"]
    prompt = np.random.default_rng(7).integers(0, vocab, (b, t))
    for policy, kw in (("greedy", dict(temperature=0.0)),
                       ("sampled", dict(temperature=0.8, top_k=20,
                                        rng=11))):
        got = generate(net, prompt, steps, **kw)       # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = generate(net, prompt, steps, **kw)
        cap_ms = (time.perf_counter() - t0) * 1e3 / steps
        fn = build_decode_fn(net, steps, one_hot=True, vocab_size=vocab,
                             **{k: v for k, v in kw.items() if k != "rng"})
        noise = (step_noise(kw["rng"], steps, b, vocab, "cuda")
                 if "rng" in kw else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            carries = seed_stream_caches(named_layers_of(net), {}, b, None,
                                         "cuda")
            ids, _ = fn(net.compute_params(), carries,
                        torch.as_tensor(prompt, device="cuda"), noise)
            eager = ids.cpu().numpy()
        eager_ms = (time.perf_counter() - t0) * 1e3 / steps
        loop = sample_sequence(net, prompt, steps, **kw)
        rows = int((loop == got).all(axis=1).sum())
        gen = net._graph_cache[("decode", steps, kw["temperature"],
                                kw.get("top_k"), None, True, vocab, b, t)]
        print(f"lstm generate [{policy}] {b} streams, prompt {t}, {steps} "
              f"steps: captured {cap_ms:.4f} ms a token, eager "
              f"{eager_ms:.4f} ms a token; captured == eager "
              f"{np.array_equal(got, eager)}, == again "
              f"{np.array_equal(got, again)}; sample_sequence: {rows} of "
              f"{b} rows identical; captures {gen.captures}, replays "
              f"{gen.replays} [{name_card}]")
        check(np.array_equal(got, eager) and np.array_equal(got, again),
              f"lstm generate [{policy}]: captured == eager")
        check(gen.captures == 1, f"lstm generate [{policy}]: one capture")
        check(rows >= b - 1, f"lstm generate [{policy}] == sample_sequence "
                             f"in {rows} of {b} rows")
        if policy == "greedy":
            seq = np.concatenate([prompt, got], axis=1)
    return seq


def chunked_against_output(net, ids):
    """``rnn_time_step`` fed ``ids`` (one-hot) in chunks of 16, 1, 47 and
    the rest, against one ``output`` over all of them: the largest
    difference of the probabilities at each timestep."""
    x = np.eye(LSTM_MODEL["vocab_size"], dtype=np.float32)[ids]
    full = net.output(x)
    net.rnn_clear_previous_state()
    parts, at = [], 0
    for n in (16, 1, 47, ids.shape[1] - 64):
        chunk = x[:, at] if n == 1 else x[:, at:at + n]
        o = net.rnn_time_step(chunk)
        parts.append(o[:, None] if o.ndim == 2 else o)
        at += n
    return (torch.cat(parts, 1) - full).abs().amax(dim=(0, 2)).cpu().numpy()


def lstm_graph(name_card):
    """The same model as a ``ComputationGraph`` whose head reads the last
    step (``LastTimeStepVertex``): two ``fit`` steps captured (a capture
    and a replay) and eager, equal bit for bit."""
    vocab, hid = LSTM_MODEL["vocab_size"], LSTM_MODEL["hidden"]
    conf = (NeuralNetConfiguration.builder().seed(12345)
            .updater("rmsprop", learning_rate=0.1).graph().add_inputs("in")
            .add_layer("l0", GravesLSTM(n_in=vocab, n_out=hid), "in")
            .add_layer("l1", GravesLSTM(n_in=hid, n_out=hid), "l0")
            .add_vertex("last", LastTimeStepVertex(), "l1")
            .add_layer("out", OutputLayer(n_in=hid, n_out=vocab), "last")
            .set_outputs("out").build())
    net = ComputationGraph(conf).init(device="cuda")
    x, y = _lstm_batch(np.random.RandomState(2), LSTM_T)
    y = y[:, -1]
    cap, eag = twin(net, True), twin(net, False)
    for _ in range(2):
        cap.fit(x, y)
        eag.fit(x, y)
    gaps = state_gaps(cap, eag)
    print(f"lstm graph (LastTimeStepVertex head): 2 fit steps, captures "
          f"{cap._step_graphs.captures}, replays {cap._step_graphs.replays}"
          f"; captured against eager: {len(gaps)} leaves differ, losses "
          f"{cap.score_value} vs {eag.score_value} [{name_card}]")
    check(cap._step_graphs.captures == 1 and not gaps
          and cap.score_value == eag.score_value,
          f"lstm graph: captured == eager bit for bit ({sorted(gaps)[:4]})")


def lstm_phase(name_card):
    """The GravesLSTM char-LM (``BASELINE.md:31``; zoo
    ``graves_lstm_char_lm``: 2x200, vocab 77, RMSProp at 0.1, TBPTT 50,
    float32) at batch 128, T 50, on ``bench.py``'s batch: the first step
    against the CPU, ``fit_modes``, profiles, TBPTT over T 210,
    streaming and ``generate``, and the graph facade."""
    t0 = time.perf_counter()
    net = graves_lstm_char_lm(device="cuda", **LSTM_MODEL)
    x, y = _lstm_batch(np.random.RandomState(0), LSTM_T)
    chars = LSTM_BATCH * LSTM_T
    print(f"lstm: {net.num_params()} params, batch {LSTM_BATCH}x{LSTM_T} "
          f"one-hot of {LSTM_MODEL['vocab_size']}, float32, TBPTT "
          f"{LSTM_MODEL['tbptt']}")
    lstm_first_step(net, x, y)
    eager, _ = fit_modes("lstm train", net, [(x, y)], {}, name_card,
                         items=chars, unit="chars",
                         flops=6.0 * _matmul_params(net) * chars,
                         peak=PEAK_OPS[torch.float32])
    prof = {label: lstm_profile(f"lstm train [{label}]", n, x, y, name_card)
            for label, n in (("eager", eager), ("captured", net))}
    print(f"lstm train: cudaLaunchKernel a step, eager "
          f"{prof['eager']['launches']} against captured "
          f"{prof['captured']['launches']} and "
          f"{prof['captured']['graphs']} cudaGraphLaunch [{name_card}]")
    check(prof["captured"]["graphs"] == 1, "lstm: one graph launch a step")
    del eager
    lstm_tbptt(net, name_card)
    ids = lstm_stream(net, name_card)
    # chunked streaming against one output: on the zoo's fresh weights
    # (the same seed) within the tolerance; on the weights trained above
    # (RMSProp at 0.1 drove the loss from 217 to over 1000) printed by
    # timestep, to show how far the recurrence carries a difference
    fresh = graves_lstm_char_lm(device="cuda", **LSTM_MODEL)
    diff = chunked_against_output(fresh, ids)
    trained = chunked_against_output(net, ids)
    steps = [0, 15, 16, 17, 63, 64, 127]
    print(f"lstm rnn_time_step in chunks of 16, 1, 47, {ids.shape[1] - 64} "
          f"against one output over {ids.shape[1]} steps: fresh weights "
          f"max_abs_diff {diff.max():.3e} (tol {LSTM_STREAM_TOL}); trained "
          f"weights by step " + ", ".join(f"{i}: {trained[i]:.3e}"
                                          for i in steps))
    check(diff.max() <= LSTM_STREAM_TOL,
          f"lstm chunked rnn_time_step {diff.max()}")
    del net, fresh
    torch.cuda.empty_cache()
    lstm_graph(name_card)
    print(f"lstm phase: {time.perf_counter() - t0:.1f} s")


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
    flash, flash_f32, prologue = train_kernel_phase(flush, name_card)
    bn_rows = bn_kernel_phase(flush, name_card)
    lrn_rows = lrn_kernel_phase(flush, name_card)
    del flush
    torch.cuda.empty_cache()
    launches = engine_phase(name_card)
    torch.cuda.empty_cache()
    generate_phases(name_card)
    torch.cuda.empty_cache()
    train_launches = train_phase(name_card)
    torch.cuda.empty_cache()
    f32_launches = train_phase(name_card, TRAIN_MODEL_F32, "train_f32")
    torch.cuda.empty_cache()
    bn_launches = resnet_phase(name_card)
    torch.cuda.empty_cache()
    lrn_launches = alexnet_phase(name_card)
    torch.cuda.empty_cache()
    lenet_phase(name_card)
    torch.cuda.empty_cache()
    lstm_phase(name_card)
    d = rows["decode"]
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/helpers/csrc/paged_attention.cu",
        "replaces": "deeplearning4j_tpu/helpers/paged_attention.py:191",
        "launches": launches, "max_abs_err": d["err"], "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["lib_ms"]}]
    flash_src = "deeplearning4j_tpu_torch/helpers/csrc/flash_attention.cu"
    # the bfloat16 char-LM's kernels, then the float32 char-LM's (the
    # launches of the float32 fit phase, all three on tf32x3)
    for (name, row, replaces), n in zip([
            ("flash_attention_fwd", flash["fwd"], "flash_attention.py:125"),
            ("flash_attention_dq", flash["dq"], "flash_attention.py:244"),
            ("flash_attention_dkv", flash["dkv"], "flash_attention.py:271"),
            ("dropout_residual_norm", prologue, "fused_epilogue.py:62"),
            ("flash_attention_fwd_f32", flash_f32["fwd"],
             "flash_attention.py:125"),
            ("flash_attention_dq_f32", flash_f32["dq"],
             "flash_attention.py:244"),
            ("flash_attention_dkv_f32", flash_f32["dkv"],
             "flash_attention.py:271")],
            list(train_launches) + list(f32_launches[:3])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": (flash_src if name.startswith("flash") else
                       "deeplearning4j_tpu_torch/helpers/csrc/"
                       "fused_epilogue.cu"),
            "replaces": f"deeplearning4j_tpu/helpers/{replaces}",
            "launches": n, "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["lib_ms"],
            **({"path": row["path"]} if "path" in row else {})})
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

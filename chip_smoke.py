"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught):

1. Build every CUDA kernel of the serving path from the sources in this
   checkout (``nvcc``, one process per source, all started together).
2. Hold each kernel against its plain PyTorch version on the card at the
   engine's own shapes, and time the kernel, the plain version and a
   library yardstick (``gather_pages`` + ``scaled_dot_product_attention``,
   which the port never calls), beside the least time the card could
   take (the bytes the call must move at 3.35 TB/s, or its operations at
   the peak rate for their type, whichever is larger).
3. Serve the transformer char-LM at full width (vocab 128, d_model 1024,
   8 heads, 8 layers, bfloat16, seeded random weights) through the port's
   ``GenerationEngine`` (16 slots, pages of 16, context 512): 16
   concurrent greedy requests of 64 new tokens from 4 client threads.
   The kernel launch counts are reset just before and read just after;
   every attention call of the run must have launched the kernel.  The
   first prefill's logits are then checked against the gather oracle, and
   a few full-batch decode steps run under ``torch.profiler`` to split
   the step's host wall from the device's busy time.
4. Print the kernels line, then ``{"ok": true, "device": ...}`` last.

Exits non-zero without printing a result when no CUDA device is
available or the port's package is not beside this script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.generation import GenerationEngine
from deeplearning4j_tpu_torch.helpers import paged_attention as pa
from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm
from deeplearning4j_tpu_torch.nn.layers.attention import gather_pages

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LOGITS_TOL = 0.1    # bf16 logits, kernel vs gather oracle, 8 layers
MODEL = dict(vocab_size=128, d_model=1024, n_heads=8, layers=8,
             max_cache=512, compute_dtype="bfloat16", seed=12345)
ENGINE = dict(slots=16, page_size=16, max_context=512, prefill_buckets=(16,))
PS, MAXP, PAGES = 16, 32, 16 * 32 + 1
CLIENTS, PER_CLIENT, NEW_TOKENS = 4, 4, 64
SPIN_CYCLES = 2_000_000     # about 1 ms of GPU clock: outlasts any enqueue
PROFILED_STEPS = 10


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
    modules = [pa]
    with ThreadPoolExecutor(len(modules)) as ex:
        built = list(ex.map(lambda m: m.build(), modules))
    for m, b in zip(modules, built):
        regs = [ln.split(":", 1)[1].strip() for ln in b.log.splitlines()
                if "Used" in ln]
        print(f"build {m.SOURCE.name}: {b.build_s:.1f} s -> {b.path.name}")
        for r in regs:
            print(f"  ptxas: {r}")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    name_card = card()
    print(name_card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_kernels()
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    rows = kernel_phase(flush, name_card)
    del flush
    launches = engine_phase(name_card)
    d = rows["decode"]
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/helpers/csrc/paged_attention.cu",
        "replaces": "deeplearning4j_tpu/helpers/paged_attention.py:191",
        "launches": launches, "max_abs_err": d["err"], "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["lib_ms"]}]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

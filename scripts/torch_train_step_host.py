"""Host against device time of the port's char-LM (or AlexNet) train step,
on one CUDA card, for the package in this checkout:

    python3 scripts/torch_train_step_host.py [--steps 20] [--tag NAME]
                                             [--float32 | --alexnet]

The model and batch are ``chip_smoke.py``'s train phase at full width
(vocab 128, d_model 1024, 8 heads, 8 layers, bfloat16, batch 8,
T = 2048, Adam at 1e-3, ``bench.py``'s batch); ``--float32`` trains it
in float32, the zoo default (no ``compute_dtype``); ``--alexnet`` trains
``chip_smoke.py``'s AlexNet instead (zoo ``alexnet``, 224x224x3, 1000
classes, batch 128, bfloat16, ``RandomState(0)`` images and one-hot
labels).  After 3 warm-up
steps it prints the median and the least of ``--steps`` timed ``fit``
steps (each ending in the loss read), then traces one more step on host
and device and prints its wall, the host's self time and the device's
busy time, and the host's operations by self time; then one step traced
on the device alone, for its busy time and the flash (or LRN) kernels'
share of it (the device's own rows, which the host trace counts twice).
The script uses only the public API (``transformer_char_lm``,
``alexnet``, ``fit``, ``score_value``), so a copy
of it measures another commit's checkout in the same way; run two
commits in turns, in fresh processes, to compare them.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from deeplearning4j_tpu_torch.models.zoo import (  # noqa: E402
    alexnet, transformer_char_lm,
)

MODEL = dict(vocab_size=128, d_model=1024, n_heads=8, layers=8,
             compute_dtype="bfloat16", seed=12345)
BATCH, T, WARM = 8, 2048, 3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tag", default="step")
    ap.add_argument("--float32", action="store_true",
                    help="train in float32 (no compute_dtype)")
    ap.add_argument("--alexnet", action="store_true",
                    help="train AlexNet at batch 128 in bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    if args.alexnet:
        net = alexnet(device="cuda", compute_dtype="bfloat16", seed=12345)
        rs = np.random.RandomState(0)
        x = torch.as_tensor(rs.rand(128, 224, 224, 3).astype(np.float32),
                            device="cuda")
        y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
            rs.randint(0, 1000, 128)], device="cuda")
        kernels = {"LRN fwd": "lrn_fwd", "LRN bwd": "lrn_bwd"}
    else:
        model = dict(MODEL)
        if args.float32:
            del model["compute_dtype"]
        net = transformer_char_lm(device="cuda", **model)
        vocab = MODEL["vocab_size"]
        ids = np.random.RandomState(0).randint(0, vocab, (BATCH, T))
        x = torch.as_tensor(ids, device="cuda")
        y = torch.as_tensor(np.eye(vocab, dtype=np.float32)[
            np.roll(ids, -1, 1)], device="cuda")
        kernels = {"flash fwd": "flash_fwd_", "dQ": "flash_dq_",
                   "dK/dV": "flash_dkv_"}
    step_s = []
    for _ in range(WARM + args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        net.score_value                     # reads the loss: waits for it
        step_s.append(time.perf_counter() - t0)
    timed = step_s[WARM:]

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    host_ms = sum(e.self_cpu_time_total for e in ev) / 1e3
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    print(torch.cuda.get_device_name(0))
    print(f"{args.tag}: step median {np.median(timed) * 1e3:.3f} ms, least "
          f"{min(timed) * 1e3:.3f} ms over {args.steps} steps; traced step "
          f"wall {wall_ms:.3f} ms, host self {host_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, {sum(e.count for e in ev)} operations")
    for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:25]:
        print(f"{args.tag} host: {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:80]}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        net.fit(x, y)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    ms = {k: sum(e.self_device_time_total for e in ev if name in e.key) / 1e3
          for k, name in kernels.items()}
    print(f"{args.tag}: device-only traced step: busy {busy_ms:.3f} ms; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f" ({sum(ms.values()) / busy_ms:.3f} of busy)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

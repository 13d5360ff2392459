"""Host against device time of the port's char-LM train step, on one CUDA
card, for the package in this checkout:

    python3 scripts/torch_train_step_host.py [--steps 20] [--tag NAME]

The model and batch are ``chip_smoke.py``'s train phase at full width
(vocab 128, d_model 1024, 8 heads, 8 layers, bfloat16, batch 8,
T = 2048, Adam at 1e-3, ``bench.py``'s batch).  After 3 warm-up steps it
prints the median and the least of ``--steps`` timed ``fit`` steps (each
ending in the loss read), then traces one more step on host and device
and prints its wall, the host's self time and the device's busy time,
and the host's operations by self time.  The script uses only the
public API (``transformer_char_lm``, ``fit``, ``score_value``), so a copy
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

from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm  # noqa: E402

MODEL = dict(vocab_size=128, d_model=1024, n_heads=8, layers=8,
             compute_dtype="bfloat16", seed=12345)
BATCH, T, WARM = 8, 2048, 3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--tag", default="step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    net = transformer_char_lm(device="cuda", **MODEL)
    vocab = MODEL["vocab_size"]
    ids = np.random.RandomState(0).randint(0, vocab, (BATCH, T))
    x = torch.as_tensor(ids, device="cuda")
    y = torch.as_tensor(np.eye(vocab, dtype=np.float32)[np.roll(ids, -1, 1)],
                        device="cuda")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device time of the BatchNorm inference kernel on one CUDA card against
the two constants that size its grid (``batch_norm.elementwise_grid``):
the threads to aim for on each SM and the least rows a thread walks.

    python3 scripts/torch_bn_grid_sweep.py

At each of ResNet-50's BatchNorm widths at batch 128 in bfloat16 (the
stem ``[1605632, 64]``, then ``[401408, 256]``, ``[25088, 1024]`` and
``[6272, 2048]``, all in blocks of 256 threads) and at a ragged C = 130
(the scalar path, blocks of 130) it times ``bn_inference_2d`` with every
pair of threads per SM in {1024, 2048, 4096} and least rows in {4, 8,
16, 32}: the mean of 30 calls from CUDA events, the L2 cache flushed and
the card kept busy by a spin kernel ahead of each call, as
``chip_smoke.py`` times kernels.  It prints the card's name and power
limit first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from deeplearning4j_tpu_torch.helpers import batch_norm as bn  # noqa: E402

SHAPES = ((1605632, 64), (401408, 256), (25088, 1024), (6272, 2048),
          (101101, 130))
PER_SM = (1024, 2048, 4096)
MIN_ROWS = (4, 8, 16, 32)


def time_ms(fn, flush, iters=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bn_grid_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    flush = torch.empty(32 * 1024 * 1024, device="cuda")
    kept = (bn._EW_THREADS_PER_SM, bn._EW_MIN_ROWS)
    try:
        for m, c in SHAPES:
            x = torch.randn(m, c, device="cuda").bfloat16()
            mean = torch.randn(c, device="cuda")
            var = torch.rand(c, device="cuda") + 0.5
            gamma, beta = (torch.randn(c, device="cuda").bfloat16()
                           for _ in range(2))
            row = []
            for per_sm in PER_SM:
                for min_rows in MIN_ROWS:
                    bn._EW_THREADS_PER_SM, bn._EW_MIN_ROWS = (per_sm,
                                                              min_rows)
                    ms = time_ms(lambda: bn.bn_inference_2d(
                        x, mean, var, gamma, beta, 1e-5), flush)
                    row.append(f"{per_sm}/{min_rows} {ms:.4f}")
            print(f"inference [{m}, {c}] bf16, ms by threads per SM / "
                  f"least rows: " + ", ".join(row))
    finally:
        bn._EW_THREADS_PER_SM, bn._EW_MIN_ROWS = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())

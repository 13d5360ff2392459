"""Where BatchNorm's reduction kernels spend their fixed time: variants of
``helpers/csrc/batch_norm.cu`` timed side by side on one CUDA card.

    python3 scripts/torch_bn_reduction_probe.py [--other PATH]

Each variant is this checkout's source with a few lines replaced (the
replacements are listed in ``VARIANTS``; a variant whose lines are not
found stops the run), built beside the others and run through this
checkout's wrapper, so a variant may compute wrong sums: it is timed,
never checked, except ``as_is``.  ``--other`` adds another checkout's
own kernels and wrapper as a row (an older commit unpacked with ``git
archive``).  It prints the card's name and power limit, each variant's
resident blocks an SM and registers, then at each shape, for every
variant, the device ms a call of the moments and grad-sums kernels, and
of the finalize and elementwise kernels where a variant has them
(``torch.profiler``, 20 calls, L2 flushed before each, and again with no
flush), beside the bytes bound (moments read x, grad sums x and g, at
3.35 TB/s).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.helpers import batch_norm as bn  # noqa: E402
from deeplearning4j_tpu_torch.helpers import cuda_build  # noqa: E402
from scripts.torch_kernel_compare import (  # noqa: E402
    BN_WRAPPER, bn_reduction_ms, load_module,
)

SHAPES = [(1605632, 64), (401408, 64), (401408, 256), (25088, 256),
          (6272, 512), (512, 64)]
FOLD = "  if (!last_to_arrive(arrivals + blockIdx.x, n_chunks)) return;"
VARIANTS = {  # name: ([(old, new), ...], wrapper constants)
    "as_is": ([], {}),
    "no_fold": ([(FOLD, "  if (n_chunks > 0) return;")], {}),
    "no_fold_no_merge": ([(FOLD, "  if (n_chunks > 0) return;"),
                          ("  block_merge(a, sm, bx);\n", "")], {}),
    "two_blocks_an_sm": ([("__launch_bounds__(kRedThreads, 1)",
                           "__launch_bounds__(kRedThreads, 2)")],
                         {"_RED_BLOCKS_PER_SM": 2}),
    "rows_in_flight_halved": ([("U = V * sizeof(T) == 16 ? 8 : 16;",
                                "U = V * sizeof(T) == 16 ? 4 : 8;"),
                               ("U = V * sizeof(T) == 16 ? 4 : 8;\n  "
                                "__shared__ float sm[Sums",
                                "U = V * sizeof(T) == 16 ? 2 : 4;\n  "
                                "__shared__ float sm[Sums")], {}),
    "min_rows_32": ([], {"_RED_MIN_ROWS": 32}),
}


# appended to every variant: resident blocks an SM of the bf16 vector
# reductions at their block size, from the occupancy calculator
OCCUPANCY = """
extern "C" int dl4j_bn_probe_occupancy(int grad) {
  int n = -1;
  if (grad)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bn_grad_sums_kernel<__nv_bfloat16, 8>, kRedThreads, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bn_moments_kernel<__nv_bfloat16, 8>, kRedThreads, 0);
  return n;
}
"""


def variant_source(name, edits) -> Path:
    text = bn.SOURCE.read_text()
    for old, new in edits:
        if text.count(old) < 1:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    text += OCCUPANCY
    out = cuda_build.BUILD_DIR / "probe" / name / "batch_norm.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    name_card = cs.card()
    print(name_card)
    mods = {}
    for i, (name, (edits, consts)) in enumerate(VARIANTS.items()):
        mods[name] = load_module(ROOT / BN_WRAPPER, f"probe_{i}")
        mods[name].SOURCE = variant_source(name, edits)
        for k, v in consts.items():
            setattr(mods[name], k, v)
    if args.other is not None:
        mods["other"] = load_module(args.other.resolve() / BN_WRAPPER,
                                    "probe_other")
    with ThreadPoolExecutor(len(mods)) as ex:
        built = dict(zip(mods, ex.map(lambda m: m.build(), mods.values())))
    for name, b in built.items():
        if name == "other":
            continue
        occ = b.lib.dl4j_bn_probe_occupancy
        occ.argtypes, occ.restype = [ctypes.c_int], ctypes.c_int
        regs = re.findall(r"Used (\d+) registers", b.log)
        print(f"{name}: resident blocks an SM (bf16 vector moments, grad "
              f"sums) {occ(0)}, {occ(1)}; registers of the entries "
              f"{sorted(set(map(int, regs)))}")
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for m, c in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(m + c)
        x = (torch.randn(m, c, generator=g, device="cuda") * 2 + 0.5).to(
            torch.bfloat16)
        gy = torch.randn(m, c, generator=g, device="cuda").to(torch.bfloat16)
        gamma = torch.randn(c, generator=g, device="cuda") + 1
        beta = torch.randn(c, generator=g, device="cuda")
        ry, rmean, _, _ = bn.bn_train_fwd_plain(x, gamma, beta, 1e-5)
        y, mean, _, _ = mods["as_is"].bn_train_fwd_2d(x, gamma, beta, 1e-5)
        cs.check(cs._scaled_err(mean, rmean) <= 1e-5, f"as_is [{m}, {c}]")
        bound_m = cs._bound(m * c * 2, 0, torch.bfloat16)[0]
        print(f"[{m}, {c}] bf16: bounds moments {bound_m:.5f} ms, grad sums "
              f"{2 * bound_m:.5f} ms; device ms a call (L2 flushed / warm) "
              f"[{name_card}]")
        for name, mod in mods.items():
            cold = bn_reduction_ms(mod, x, gy, gamma, beta, flush)
            warm = bn_reduction_ms(mod, x, gy, gamma, beta)
            print(f"  {name:21s} " + "; ".join(
                f"{k} {cold.get(k, (0, 0))[0]:.4f} / "
                f"{warm.get(k, (0, 0))[0]:.4f}"
                for k in ("moments", "grad sums", "finalize", "apply",
                          "dx")), flush=True)
        del x, gy, y, ry
    return 0


if __name__ == "__main__":
    sys.exit(main())

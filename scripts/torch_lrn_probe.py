"""Where the LRN vector kernels' time goes: variants of
``helpers/csrc/lrn.cu`` timed side by side on one CUDA card.

    python3 scripts/torch_lrn_probe.py [--other PATH] [--iters 30]

Each variant is this checkout's source with a few lines replaced (the
replacements are listed in ``VARIANTS``; a variant whose lines are not
found stops the run), built beside the others and run through this
checkout's wrapper, so a variant may compute a slightly different result:
it is timed, never checked, except ``as_is``.  ``--other`` adds another
checkout's own kernels and wrapper as a row (an older commit unpacked
with ``git archive``).  It prints the card's name and power limit, each
variant's resident blocks an SM and registers (bf16, n = 5), then at
AlexNet's two LRN shapes in bfloat16 and the first in float32, for every
variant, the forward's and backward's device ms a call (CUDA events, L2
flushed before each call, the least of two passes over the variants in
the order a..z, z..a) beside the bytes bound at 3.35 TB/s.
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
from deeplearning4j_tpu_torch.helpers import cuda_build  # noqa: E402
from deeplearning4j_tpu_torch.helpers import lrn  # noqa: E402
from scripts.torch_kernel_compare import (  # noqa: E402
    LRN_WRAPPER, load_module,
)

SHAPES = [(373248, 96, torch.bfloat16), (86528, 256, torch.bfloat16),
          (373248, 96, torch.float32)]
POW = """__device__ __forceinline__ float pow_neg(float s, float beta) {
  return exp2f(-beta * __log2f(s));
}"""
POW_FTZ = """__device__ __forceinline__ float ex2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float lg2_ftz(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float pow_neg(float s, float beta) {
  return ex2_ftz(-beta * lg2_ftz(s));
}"""
VARIANTS = {  # name: [(old, new), ...]
    "as_is": [],
    "fwd_tiles_2": [("kFwdTiles = 1;", "kFwdTiles = 2;")],
    "fwd_tiles_4": [("kFwdTiles = 1;", "kFwdTiles = 4;")],
    "bwd_tiles_2": [("kBwdTiles = 1;", "kBwdTiles = 2;")],
    "bwd_tiles_4": [("kBwdTiles = 1;", "kBwdTiles = 4;")],
    "threads_128": [("kVecThreads = 256;", "kVecThreads = 128;")],
    "threads_512": [("kVecThreads = 256;", "kVecThreads = 512;")],
    "streaming_stores": [("yv[e] = pack_all<T>(out);",
                          "__stcs(yv + e, pack_all<T>(out));"),
                         ("dv[e] = pack_all<T>(out);",
                          "__stcs(dv + e, pack_all<T>(out));")],
    "ftz_mufu": [(POW, POW_FTZ),
                 ("const float lg = __log2f(", "const float lg = lg2_ftz("),
                 ("pw[i] = exp2f(", "pw[i] = ex2_ftz("),
                 ("* exp2f((-p.beta - 1.f) * lg)",
                  "* ex2_ftz((-p.beta - 1.f) * lg)")],
}

# appended to every variant: resident blocks an SM of the bf16 n = 5
# vector kernels, from the occupancy calculator
OCCUPANCY = """
extern "C" int dl4j_lrn_probe_occupancy(int bwd) {
  int n = -1;
  if (bwd)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, lrn_bwd_vec<__nv_bfloat16, 2>, kVecThreads, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, lrn_fwd_vec<__nv_bfloat16, 2>, kVecThreads, 0);
  return n;
}
"""


def variant_source(name, edits) -> Path:
    text = lrn.SOURCE.read_text()
    for old, new in edits:
        if text.count(old) < 1:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        text = text.replace(old, new)
    text += OCCUPANCY
    out = cuda_build.BUILD_DIR / "probe" / name / "lrn.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    name_card = cs.card()
    print(name_card)
    mods = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        mods[name] = load_module(ROOT / LRN_WRAPPER, f"probe_{i}")
        mods[name].SOURCE = variant_source(name, edits)
    if args.other is not None:
        mods["other"] = load_module(args.other.resolve() / LRN_WRAPPER,
                                    "probe_other")
    with ThreadPoolExecutor(len(mods)) as ex:
        built = dict(zip(mods, ex.map(lambda m: m.build(), mods.values())))
    for name, b in built.items():
        if name == "other":
            continue
        occ = b.lib.dl4j_lrn_probe_occupancy
        occ.argtypes, occ.restype = [ctypes.c_int], ctypes.c_int
        regs = {}
        entry = None
        for ln in b.log.splitlines():
            found = re.search(r"lrn_(fwd|bwd)_vecI13__nv_bfloat16Li2E", ln)
            if "Compiling entry function" in ln:
                entry = found.group(1) if found else None
            elif entry and "Used" in ln:
                regs[entry] = int(re.search(r"Used (\d+) registers",
                                            ln).group(1))
        print(f"{name}: resident blocks an SM (bf16 n = 5 forward, "
              f"backward) {occ(0)}, {occ(1)}; registers {regs}")
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    prm = dict(cs.LRN)
    for m, c, dtype in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(m + c)
        x = (torch.randn(m, c, generator=g, device="cuda") * 30).to(dtype)
        gy = torch.randn(m, c, generator=g, device="cuda").to(dtype)
        ry = lrn.lrn_fwd_plain(x, **prm)
        rdx = lrn.lrn_bwd_plain(x, gy, **prm)
        y, dx = (mods["as_is"].lrn_fwd_2d(x, **prm),
                 mods["as_is"].lrn_bwd_2d(x, gy, **prm))
        torch.cuda.synchronize()
        err = max(cs._scaled_err(y, ry), cs._scaled_err(dx, rdx))
        cs.check(err <= cs.TOL[dtype], f"as_is [{m}, {c}]: {err}")
        del y, dx, ry, rdx
        bounds = cs.lrn_bounds(m, c, x.element_size(), prm["n"])
        best = {}
        order = list(mods) + list(reversed(list(mods)))
        for name in order:
            mod = mods[name]
            for k, fn in (("fwd", lambda: mod.lrn_fwd_2d(x, **prm)),
                          ("bwd", lambda: mod.lrn_bwd_2d(x, gy, **prm))):
                ms = cs.time_ms(fn, flush, iters=args.iters)
                best[name, k] = min(best.get((name, k), ms), ms)
        print(f"[{m}, {c}] {str(dtype)[6:]} n=5: bounds fwd "
              f"{bounds['fwd'][0]:.5f}, bwd {bounds['bwd'][0]:.5f} ms; "
              f"device ms a call, L2 flushed [{name_card}]")
        for name in mods:
            print(f"  {name:19s} fwd {best[name, 'fwd']:.4f} "
                  f"({bounds['fwd'][0] / best[name, 'fwd']:.3f} of the "
                  f"bound); bwd {best[name, 'bwd']:.4f} "
                  f"({bounds['bwd'][0] / best[name, 'bwd']:.3f})",
                  flush=True)
        del x, gy
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Two checkouts' float32 flash forward and paged decode kernels, timed in
turns on one CUDA card:

    python3 scripts/torch_kernel_compare.py --other PATH [--iters 30]

``PATH`` is the root of another checkout of this repository (an older
commit unpacked with ``git archive``).  Both checkouts' kernel sources
are built, and each case is timed with this checkout's wrappers and
``chip_smoke.py``'s timer (CUDA events, L2 flushed before each call) in
the order other, this, this, other; a case prints both checkouts' least
time, the kernels' route, the least time the card could take, and one
PyTorch call for the same function (SDPA forward; ``gather_pages`` +
SDPA for paged decode).  The cases are ``chip_smoke.py``'s: the float32
char-LM's attention shapes and the serving shapes.
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.helpers import cuda_build  # noqa: E402
from deeplearning4j_tpu_torch.helpers import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.helpers import paged_attention as pa  # noqa: E402

CSRC = Path("deeplearning4j_tpu_torch/helpers/csrc")
FLASH_F32 = [  # name, [B, T, H, D], causal, window
    ("causal", (8, 2048, 8, 128), True, None),
    ("non-causal", (8, 2048, 8, 128), False, None),
    ("window 256", (8, 2048, 8, 128), True, 256),
    ("causal, T 1000", (8, 1000, 8, 128), True, None),
    ("causal, D 64", (8, 2048, 8, 64), True, None),
]
LONG = dict(ps=cs.LONG_PS, maxp=cs.LONG_MAXP, pages=cs.LONG_PAGES)
PAGED = [  # name, shape, dtype, prefill start
    ("decode", dict(b=16, t=1, hq=8, hkv=8, d=128), torch.bfloat16, None),
    ("prefill", dict(b=1, t=16, hq=8, hkv=8, d=128), torch.bfloat16, 0),
    ("decode_f32", dict(b=16, t=1, hq=8, hkv=8, d=128), torch.float32,
     None),
    ("decode_gqa", dict(b=16, t=1, hq=8, hkv=2, d=128), torch.bfloat16,
     None),
    ("decode_long", dict(b=16, t=1, hq=8, hkv=8, d=128, **LONG),
     torch.bfloat16, None),
]


def use(tree: Path) -> None:
    """Point the wrappers at ``tree``'s kernel sources and load them."""
    fa.SOURCE = (tree / CSRC / "flash_attention.cu").resolve()
    pa.SOURCE = (tree / CSRC / "paged_attention.cu").resolve()
    fa._lib = None
    pa._launcher = None
    fa.build()
    pa.build()


def in_turns(trees, fn, flush, iters):
    """{tree: least ms} over the order a, b, b, a."""
    best = {}
    for tree in list(trees) + list(reversed(trees)):
        use(tree)
        ms = cs.time_ms(fn, flush, iters=iters)
        best[tree] = min(best.get(tree, ms), ms)
    return best


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cs.pin_fp32_precision()
    other, this = args.other.resolve(), ROOT
    trees = (other, this)
    sources = [(tree / CSRC / name).resolve() for tree in trees
               for name in ("flash_attention.cu", "paged_attention.cu")]
    with ThreadPoolExecutor(len(sources)) as ex:   # all four builds at once
        list(ex.map(cuda_build.load_library, sources))
    name_card = cs.card()
    print(name_card)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")

    for i, (name, shape, causal, window) in enumerate(FLASH_F32):
        b, t, h, d = shape
        q, k, v = (cs._randn(300 + 3 * i + j, shape, torch.float32)
                   for j in range(3))
        ro, rlse = fa.flash_attention_plain_fwd(q, k, v, causal, window)
        routes, errs = {}, {}
        for tree in trees:
            use(tree)
            o, lse = fa.flash_fwd(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            routes[tree] = fa.kernel_path("fwd", torch.float32, d)
            errs[tree] = max(cs._abs_err(o, ro), cs._abs_err(lse, rlse))
            cs.check(errs[tree] <= cs.TOL[torch.float32],
                     f"{name} ({tree}): kernel vs plain {errs[tree]}")
        del ro, rlse, o, lse
        ms = in_turns(trees, lambda: fa.flash_fwd(
            q, k, v, causal=causal, window=window), flush, args.iters)
        mask = cs._sdpa_mask(t, causal, window)
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None),
            flush, iters=args.iters)
        pairs = cs._live_pairs(t, causal, window) * b * h
        work = (4 * q.numel() * 4 + b * h * t * 4, 4 * d * pairs)
        tc = cs._bound(*work, torch.float32, cs.TF32X3_OPS)[0]
        cores = cs._bound(*work, torch.float32)[0]
        print(f"flash fwd f32 [{name}] {list(shape)}: other "
              f"({routes[other]}) {ms[other]:.4f} ms -> this "
              f"({routes[this]}) {ms[this]:.4f} ms; SDPA fwd "
              f"{sdpa_ms:.4f} ms; bound {tc:.5f} ms at 165 TFLOP/s "
              f"({cores:.5f} at 67); err {errs[other]:.2e} / "
              f"{errs[this]:.2e} [{name_card}]", flush=True)
        del q, k, v, qs, ks, vs

    for i, (name, shape, dtype, start) in enumerate(PAGED):
        args_ = cs.paged_case(100 + i, dtype=dtype, start=start, **shape)
        ps = shape.get("ps", cs.PS)
        ref = pa.paged_attention_plain(*args_, ps)
        errs = {}
        for tree in trees:
            use(tree)
            out = pa.paged_decode_attention(*args_, page_size=ps)
            torch.cuda.synchronize()
            errs[tree] = cs._abs_err(out, ref)
            cs.check(errs[tree] <= cs.TOL[dtype],
                     f"paged {name} ({tree}): kernel vs plain {errs[tree]}")
        ms = in_turns(trees, lambda: pa.paged_decode_attention(
            *args_, page_size=ps), flush, args.iters)
        lib_ms = cs.time_ms(lambda: cs.library_call(*args_, ps), flush,
                            iters=args.iters)
        bms, by = cs.bound_ms(args_[0], args_[1], args_[3], args_[4], ps)
        print(f"paged [{name}] q{list(args_[0].shape)} {str(dtype)[6:]}, "
              f"longest context {int(args_[4].max()) + 1} keys: other "
              f"{ms[other]:.4f} ms -> this {ms[this]:.4f} ms; library "
              f"{lib_ms:.4f} ms; bound {bms:.5f} ms ({by}); err "
              f"{errs[other]:.2e} / {errs[this]:.2e} [{name_card}]",
              flush=True)
        del args_, ref, out
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Two checkouts' float32 flash forward, paged decode, BatchNorm
training and LRN kernels, timed in turns on one CUDA card:

    python3 scripts/torch_kernel_compare.py --other PATH [--iters 30]
        [--only flash|paged|bn|lrn ...]

``PATH`` is the root of another checkout of this repository (an older
commit unpacked with ``git archive``).  Both checkouts' kernel sources
are built, and each case is timed with ``chip_smoke.py``'s timer (CUDA
events, L2 flushed before each call) in the order other, this, this,
other; a case prints both checkouts' least time, the least time the card
could take, and one PyTorch call for the same function (SDPA forward;
``gather_pages`` + SDPA for paged decode; ``F.batch_norm`` on a
channels_last view for BatchNorm).  Flash and paged cases run this
checkout's wrappers on either source; BatchNorm runs each checkout's own
wrapper (the launch arguments differ between them) and also prints its
reductions' device time by kernel from ``torch.profiler`` (moments, grad
sums and, where a checkout has them, their finalize kernels) beside their
byte bounds (moments read x; grad sums read x and g).  The cases are
``chip_smoke.py``'s: the float32 char-LM's attention shapes, the serving
shapes, and ResNet-50's nine BatchNorm shapes at batch 128 in bfloat16
with ``chip_smoke.py``'s float32 and ragged BatchNorm cases.  LRN runs
each checkout's own wrapper (forward and backward) at ``chip_smoke.py``'s
seven LRN cases, and prints this checkout's route, the bounds and
``F.local_response_norm`` (odd n).  ``--only`` picks kernel families
(default: all four).
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.helpers import batch_norm as bn  # noqa: E402
from deeplearning4j_tpu_torch.helpers import cuda_build  # noqa: E402
from deeplearning4j_tpu_torch.helpers import flash_attention as fa  # noqa: E402
from deeplearning4j_tpu_torch.helpers import lrn  # noqa: E402
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

BN_SHAPES = [  # name, [M, C], dtype: ResNet-50's inputs at batch 128
    ("stem", (1605632, 64), torch.bfloat16),
    ("stage1_64", (401408, 64), torch.bfloat16),
    ("stage1_256", (401408, 256), torch.bfloat16),
    ("stage2_128", (100352, 128), torch.bfloat16),
    ("stage2_512", (100352, 512), torch.bfloat16),
    ("stage3_256", (25088, 256), torch.bfloat16),
    ("stage3_1024", (25088, 1024), torch.bfloat16),
    ("stage4_512", (6272, 512), torch.bfloat16),
    ("stage4_2048", (6272, 2048), torch.bfloat16),
] + [(name, (n * h * w, c), dtype)
     for name, (n, h, w, c), dtype, _ in cs.BN_CASES
     if name in ("stage1_f32", "ragged_bf16", "ragged_f16")]
BN_PROFILED_CALLS = 20
BN_WRAPPER = "deeplearning4j_tpu_torch/helpers/batch_norm.py"
LRN_WRAPPER = "deeplearning4j_tpu_torch/helpers/lrn.py"


def load_module(path: Path, name: str):
    """A fresh module from ``path`` (another checkout's BatchNorm wrapper,
    which reads its own kernel source)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def bn_reduction_ms(mod, x, gy, gamma, beta, flush=None):
    """{pass: (device ms a call, launches a call)} of ``mod``'s training
    forward and backward over ``BN_PROFILED_CALLS`` calls each, from
    ``torch.profiler``; L2 flushed before each call where ``flush`` (a
    128 MB tensor) is given."""
    from torch.profiler import ProfilerActivity, profile

    _, mean, _, inv = mod.bn_train_fwd_2d(x, gamma, beta, cs.BN_EPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BN_PROFILED_CALLS):
            if flush is not None:
                flush.zero_()
            mod.bn_train_fwd_2d(x, gamma, beta, cs.BN_EPS)
            if flush is not None:
                flush.zero_()
            mod.bn_train_bwd_2d(x, gy, gamma, mean, inv)
        torch.cuda.synchronize()
    return {k: (ms / BN_PROFILED_CALLS, n / BN_PROFILED_CALLS)
            for k, (ms, n) in cs.bn_passes(prof.key_averages()).items()}


def bn_cases(trees, flush, iters, name_card):
    other, this = trees
    mods = {this: bn, other: load_module(other / BN_WRAPPER,
                                         "other_batch_norm")}
    for mod in mods.values():
        mod.build()
    for i, (name, (m, c), dtype) in enumerate(BN_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(500 + i)
        x = (torch.randn(m, c, generator=g, device="cuda") * 2 + 0.5).to(
            dtype)
        gy = torch.randn(m, c, generator=g, device="cuda").to(dtype)
        gamma = torch.randn(c, generator=g, device="cuda") + 1
        beta = torch.randn(c, generator=g, device="cuda")
        ry, rmean, rvar, rinv = bn.bn_train_fwd_plain(x, gamma, beta,
                                                      cs.BN_EPS)
        rdx, rdg, rdb = bn.bn_train_bwd_plain(x, gy, gamma, rmean, rinv)
        errs = {}
        for tree, mod in mods.items():
            y, mean, var, inv = mod.bn_train_fwd_2d(x, gamma, beta,
                                                    cs.BN_EPS)
            dx, dg, db = mod.bn_train_bwd_2d(x, gy, gamma, mean, inv)
            torch.cuda.synchronize()
            errs[tree] = max(cs._scaled_err(a, r) for a, r in (
                (y, ry), (mean, rmean), (var, rvar), (dx, rdx), (dg, rdg),
                (db, rdb)))
            cs.check(errs[tree] <= cs.TOL[dtype],
                     f"bn {name} ({tree}): kernel vs plain {errs[tree]}")
        del ry, rvar, rdx, rdg, rdb, y, dx
        mean, inv = rmean, rinv
        best = {"fwd": {}, "bwd": {}}
        for tree in list(trees) + list(reversed(trees)):
            mod = mods[tree]
            for k, fn in (("fwd", lambda: mod.bn_train_fwd_2d(
                    x, gamma, beta, cs.BN_EPS)),
                          ("bwd", lambda: mod.bn_train_bwd_2d(
                              x, gy, gamma, mean, inv))):
                ms = cs.time_ms(fn, flush, iters=iters)
                best[k][tree] = min(best[k].get(tree, ms), ms)
        passes = {tree: bn_reduction_ms(mods[tree], x, gy, gamma, beta,
                                        flush) for tree in trees}
        # F.batch_norm on the channels_last [M, C, 1, 1] view of x
        xl = x.view(m, 1, 1, c).permute(0, 3, 1, 2).detach().requires_grad_()
        gyl = gy.view(m, 1, 1, c).permute(0, 3, 1, 2)
        gl, bl = (t.clone().requires_grad_() for t in (gamma, beta))
        lib_fwd = lambda: F.batch_norm(xl, None, None, gl, bl, True, 0.1,
                                       cs.BN_EPS)
        out = lib_fwd()
        lib = {"fwd": cs.time_ms(lib_fwd, flush, iters=iters),
               "bwd": cs.time_ms(lambda: torch.autograd.grad(
                   out, (xl, gl, bl), gyl, retain_graph=True), flush,
                   iters=iters)}
        del out, xl, gl, bl
        esz = x.element_size()
        bound = {"fwd": cs._bound(2 * m * c * esz + 2 * c * 4 + 3 * c * 4, 0,
                                  dtype)[0],
                 "bwd": cs._bound(3 * m * c * esz + c * 4 + 4 * c * 4, 0,
                                  dtype)[0],
                 "moments": cs._bound(m * c * esz, 0, dtype)[0],
                 "grad sums": cs._bound(2 * m * c * esz, 0, dtype)[0]}

        def red(tree, what):
            ms, n = passes[tree].get(what, (0.0, 0))
            return f"{ms:.4f} ms ({n:g} a call)"

        fin = {tree: passes[tree].get("finalize", (0.0, 0)) for tree in trees}
        vec = bn._vec(x, gy)
        grid = bn.chunking(m, c, vec, bn._sm_count(x.device))
        print(f"bn [{name}] [{m}, {c}] {str(dtype)[6:]} (vec {vec}, this "
              f"grid {grid}): "
              f"train fwd other {best['fwd'][other]:.4f} -> this "
              f"{best['fwd'][this]:.4f} ms (bound {bound['fwd']:.5f}, "
              f"F.batch_norm {lib['fwd']:.4f}); train bwd other "
              f"{best['bwd'][other]:.4f} -> this {best['bwd'][this]:.4f} ms "
              f"(bound {bound['bwd']:.5f}, F.batch_norm {lib['bwd']:.4f}); "
              f"err {errs[other]:.2e} / {errs[this]:.2e} [{name_card}]",
              flush=True)
        print(f"bn [{name}] reductions by kernel (profiler, L2 flushed, a "
              f"call): moments other {red(other, 'moments')} -> this "
              f"{red(this, 'moments')} (bound {bound['moments']:.5f}); grad "
              f"sums other {red(other, 'grad sums')} -> this "
              f"{red(this, 'grad sums')} (bound {bound['grad sums']:.5f}); "
              f"finalize other {fin[other][0]:.4f} ms ({fin[other][1]:g}) "
              f"-> this {fin[this][0]:.4f} ms ({fin[this][1]:g}); apply "
              f"other {passes[other].get('apply', (0, 0))[0]:.4f} -> this "
              f"{passes[this].get('apply', (0, 0))[0]:.4f}; dx other "
              f"{passes[other].get('dx', (0, 0))[0]:.4f} -> this "
              f"{passes[this].get('dx', (0, 0))[0]:.4f} ms [{name_card}]",
              flush=True)
        del x, gy, mean, inv
        torch.cuda.empty_cache()


def lrn_cases(trees, flush, iters, name_card):
    other, this = trees
    mods = {this: lrn, other: load_module(other / LRN_WRAPPER, "other_lrn")}
    for mod in mods.values():
        mod.build()
    for i, (name, shape, dtype, n, _) in enumerate(cs.LRN_CASES):
        b, h, w, c = shape
        m = b * h * w
        g = torch.Generator(device="cuda").manual_seed(500 + 10 * i)
        x = (torch.randn(m, c, generator=g, device="cuda") * 30).to(dtype)
        gy = torch.randn(m, c, generator=g, device="cuda").to(dtype)
        prm = dict(cs.LRN, n=n)
        ry = lrn.lrn_fwd_plain(x, **prm)
        rdx = lrn.lrn_bwd_plain(x, gy, **prm)
        errs = {}
        for tree, mod in mods.items():
            y, dx = mod.lrn_fwd_2d(x, **prm), mod.lrn_bwd_2d(x, gy, **prm)
            torch.cuda.synchronize()
            errs[tree] = max(cs._scaled_err(y, ry), cs._scaled_err(dx, rdx))
            cs.check(errs[tree] <= cs.TOL[dtype],
                     f"lrn {name} ({tree}): kernel vs plain {errs[tree]}")
        del y, dx, rdx
        best = {"fwd": {}, "bwd": {}}
        for tree in list(trees) + list(reversed(trees)):
            mod = mods[tree]
            for k, fn in (("fwd", lambda: mod.lrn_fwd_2d(x, **prm)),
                          ("bwd", lambda: mod.lrn_bwd_2d(x, gy, **prm))):
                ms = cs.time_ms(fn, flush, iters=iters)
                best[k][tree] = min(best[k].get(tree, ms), ms)
        lib, _ = cs.lrn_library(x, gy, shape, prm, ry, flush, iters=iters)
        bounds = cs.lrn_bounds(m, c, x.element_size(), n)
        print(f"lrn [{name}] [{m}, {c}] {str(dtype)[6:]} n={n}, this route "
              f"{lrn.route(x, n, gy)}: " + "; ".join(
                  f"{k} other {best[k][other]:.4f} -> this "
                  f"{best[k][this]:.4f} ms (bound {bounds[k][0]:.5f}, "
                  f"{bounds[k][0] / best[k][this]:.3f} of it; "
                  f"F.local_response_norm "
                  + ("n/a" if lib[k] is None else f"{lib[k]:.4f}") + ")"
                  for k in ("fwd", "bwd"))
              + f"; err {errs[other]:.2e} / {errs[this]:.2e} [{name_card}]",
              flush=True)
        del x, gy, ry
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--only", action="append",
                    choices=("flash", "paged", "bn", "lrn"),
                    help="kernel families to time (repeatable; default "
                         "all)")
    args = ap.parse_args()
    only = set(args.only or ("flash", "paged", "bn", "lrn"))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cs.pin_fp32_precision()
    other, this = args.other.resolve(), ROOT
    trees = (other, this)
    names = ([f"{k}_attention.cu" for k in ("flash", "paged") if k in only]
             + (["batch_norm.cu"] if "bn" in only else [])
             + (["lrn.cu"] if "lrn" in only else []))
    sources = [(tree / CSRC / name).resolve() for tree in trees
               for name in names]
    with ThreadPoolExecutor(len(sources)) as ex:   # every build at once
        list(ex.map(cuda_build.load_library, sources))
    name_card = cs.card()
    print(name_card)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    if "bn" in only:
        bn_cases(trees, flush, args.iters, name_card)
    if "lrn" in only:
        lrn_cases(trees, flush, args.iters, name_card)
    if "flash" in only:
        flash_cases(trees, flush, args.iters, name_card)
    if "paged" in only:
        paged_cases(trees, flush, args.iters, name_card)
    return 0


def flash_cases(trees, flush, iters, name_card):
    other, this = trees
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
            q, k, v, causal=causal, window=window), flush, iters)
        mask = cs._sdpa_mask(t, causal, window)
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None),
            flush, iters=iters)
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


def paged_cases(trees, flush, iters, name_card):
    other, this = trees
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
            *args_, page_size=ps), flush, iters)
        lib_ms = cs.time_ms(lambda: cs.library_call(*args_, ps), flush,
                            iters=iters)
        bms, by = cs.bound_ms(args_[0], args_[1], args_[3], args_[4], ps)
        print(f"paged [{name}] q{list(args_[0].shape)} {str(dtype)[6:]}, "
              f"longest context {int(args_[4].max()) + 1} keys: other "
              f"{ms[other]:.4f} ms -> this {ms[this]:.4f} ms; library "
              f"{lib_ms:.4f} ms; bound {bms:.5f} ms ({by}); err "
              f"{errs[other]:.2e} / {errs[this]:.2e} [{name_card}]",
              flush=True)
        del args_, ref, out


if __name__ == "__main__":
    sys.exit(main())

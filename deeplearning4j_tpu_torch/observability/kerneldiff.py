"""Kernel-trust differential harness — port of
``deeplearning4j_tpu/observability/kerneldiff.py`` without jax.

Every forward kernel of the port is run against an independent float64
numpy reference over the reference sweep's shape × dtype × masking grid
(and, from ``chip_smoke.py``, at the shapes its path gives it); each
config records max-abs / max-rel error and the ULP distribution in the
output dtype, and each kernel gets a divergence class:

- ``within_tolerance`` — every config's max rel error is inside the
  dtype's budget; the kernel is trusted;
- ``tolerance_only`` — some configs exceed the budget but stay within a
  small multiple of it (an accumulation-order artifact);
- ``shape_dependent`` — the SAME dtype passes on some shapes and fails
  on others: a tiling/padding/masking seam, treat as a bug until
  explained;
- ``kernel_divergence`` — every config of a dtype is out of budget.

The ``KERNELS`` registry holds the port's kernel wrappers: on CUDA
tensors (``device="cuda"``, the default) they launch the hand-written
kernels; on CPU tensors (``device="cpu"``) they run their plain
versions.  Any error propagates on every device: a kernel that fails to
build or launch fails the sweep, it is never filed as a class.  As in the reference, the sweep
covers forward passes; the backward kernels are held against their
plain versions (``chip_smoke.py``, ``tests/test_torch_cuda.py``).  The
port's results are not written into ``kernel_trust.json`` (the JAX
package's trust document, ``scripts/ci_checks.py`` gate 5).

Metric family: ``dl4j_kernel_max_rel_error{kernel}``.

CLI::

    python -m deeplearning4j_tpu_torch.observability.kerneldiff \
        [--device cpu] [--full] [--kernels a,b] [--out PATH] \
        [--baseline PATH]

``--out`` writes the report to a path the caller gives; ``--baseline``
compares the sweep with such a report under
``regression.KERNEL_TRUST_RULES`` (exit 1 on a regression).  Neither
accepts ``kernel_trust.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_KERNEL_ERR = "dl4j_kernel_max_rel_error"

# Per-dtype max-rel-error budgets vs the float64 reference (the
# reference's): float32 absorbs accumulation-order differences, bfloat16
# its 8-bit mantissa.  A config within TOLERANCE_SLACK × budget is
# "tolerance_only", beyond that it is a divergence.
DTYPE_BUDGET = {"float32": 5e-5, "bfloat16": 3e-2}
TOLERANCE_SLACK = 16.0

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# float64 numpy references (independent of the torch implementations)
# ---------------------------------------------------------------------------

def _np_softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    m = x.max(axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def _np_attention(q, k, v, *, causal=False, window=None,
                  q_positions=None) -> np.ndarray:
    """float64 attention over [B, T, H, D] q and [B, L, Hkv, D] k/v with
    GQA head sharing, optional causal/window masking by global position,
    and optional PER-ROW query positions (the paged-decode convention:
    key index IS the global position).  Matrix products through BLAS."""
    q = np.asarray(q, np.float64)
    k = np.asarray(k, np.float64)
    v = np.asarray(v, np.float64)
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, t, hkv, g, d).transpose(0, 2, 3, 1, 4)  # [b,h,g,t,d]
    kt = k.transpose(0, 2, 3, 1)[:, :, None]                   # [b,h,1,d,L]
    scores = np.matmul(qg, kt) / math.sqrt(d)                  # [b,h,g,t,L]
    if causal:
        kpos = np.arange(k.shape[1])
        if q_positions is None:
            qpos = np.broadcast_to(np.arange(t), (b, t))
        else:
            qpos = np.asarray(q_positions)
        cm = qpos[:, :, None] >= kpos[None, None, :]        # [B, T, L]
        if window is not None:
            cm &= kpos[None, None, :] > qpos[:, :, None] - window
        scores = np.where(cm[:, None, None], scores, -1e30)
    w = _np_softmax(scores)
    o = np.matmul(w, v.transpose(0, 2, 1, 3)[:, :, None])      # [b,h,g,t,d]
    return o.transpose(0, 3, 1, 2, 4).reshape(b, t, hq, d)


def _np_gather_pages(pages, block, page_size: int) -> np.ndarray:
    pages = np.asarray(pages, np.float64)
    block = np.asarray(block)
    per = pages.reshape((-1, page_size) + pages.shape[1:])
    out = per[block]                                  # [B, MAXP, ps, ...]
    b, maxp = block.shape
    return out.reshape((b, maxp * page_size) + pages.shape[1:])


def _np_dropout_residual_norm(h, res, gamma, beta, eps, mask,
                              keep) -> np.ndarray:
    """float64 dropout(LayerNorm_affine(res + h)) — the fused epilogue's
    reference (``helpers/fused_epilogue.py``)."""
    x = np.asarray(h, np.float64)
    if res is not None:
        x = x + np.asarray(res, np.float64)
    mu = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    y = ((x - mu) / np.sqrt(var + eps) * np.asarray(gamma, np.float64)
         + np.asarray(beta, np.float64))
    if mask is not None:
        y = np.where(np.asarray(mask), y / keep, 0.0)
    return y


def _np_lrn(x2d, k, n, alpha, beta) -> np.ndarray:
    x = np.asarray(x2d, np.float64)
    half = n // 2
    sq = np.pad(x * x, ((0, 0), (half, half)))
    win = np.zeros_like(x)
    for j in range(n):
        win += sq[:, j:j + x.shape[1]]
    return x / np.power(k + alpha * win, beta)


def _np_bn_inference(x2d, mean, var, gamma, beta, eps) -> np.ndarray:
    x = np.asarray(x2d, np.float64)
    inv = 1.0 / np.sqrt(np.asarray(var, np.float64) + eps)
    return ((x - np.asarray(mean, np.float64)) * inv
            * np.asarray(gamma, np.float64) + np.asarray(beta, np.float64))


def _np_bn_training(x2d, gamma, beta, eps):
    x = np.asarray(x2d, np.float64)
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    y = ((x - mean) / np.sqrt(var + eps) * np.asarray(gamma, np.float64)
         + np.asarray(beta, np.float64))
    return y, mean, var


# ---------------------------------------------------------------------------
# error measurement
# ---------------------------------------------------------------------------

def _host64(a) -> np.ndarray:
    """A tensor or array as a float64 host array (exact for every float
    type the kernels produce)."""
    if torch.is_tensor(a):
        return a.detach().double().cpu().numpy()
    return np.asarray(a, np.float64)


def _bits(a: np.ndarray, dtype: str) -> np.ndarray:
    """Sign-ordered integer ordinals of float values in ``dtype`` (the
    value rounded to it, nearest even) — the space in which
    ``|ord(a) - ord(b)|`` counts representable values between a and b
    (ULP distance)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if dtype == "bfloat16":
        raw = t.to(torch.bfloat16).view(torch.int16).numpy()
        raw = raw.astype(np.int64) & 0xFFFF
        sign = np.int64(1) << 15
    else:
        raw = t.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF
        sign = np.int64(1) << 31
    # negative floats (sign bit set) map below zero: ord(-x) = sign - bits(x)
    return np.where(raw >= sign, sign - raw, raw)


def measure(out, ref64: np.ndarray, dtype: str) -> Dict[str, float]:
    """Error stats of one kernel output vs its float64 reference (the
    reference's definitions): ``max_rel_error`` is the max-abs difference
    over the reference's max-abs value (scale-normalized); the ULP
    distance is against the reference rounded to the output dtype;
    ``ulp_p99`` is the robust summary."""
    o = _host64(out)
    r = np.asarray(ref64, np.float64)
    diff = np.abs(o - r)
    max_ref = float(np.abs(r).max()) if r.size else 0.0
    ulp = np.abs(_bits(o, dtype) - _bits(r, dtype))
    return {
        "max_abs_error": float(diff.max()) if diff.size else 0.0,
        "max_rel_error": (float(diff.max() / (max_ref + 1e-30))
                          if diff.size else 0.0),
        "ulp_max": int(ulp.max()) if ulp.size else 0,
        "ulp_p99": float(np.percentile(ulp, 99)) if ulp.size else 0.0,
        "ref_max_abs": max_ref,
    }


# ---------------------------------------------------------------------------
# the sweep grid: the reference's configurations
# ---------------------------------------------------------------------------

def _rng(*shape, dtype, seed, device):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.as_tensor(x, dtype=_TORCH_DTYPES.get(dtype, dtype),
                           device=device)


def _flash_configs(full: bool):
    shapes = [(1, 128, 2, 32), (2, 128, 2, 64)]
    if full:
        shapes += [(1, 256, 4, 32), (2, 256, 2, 128)]
    for b, t, h, d in shapes:
        for dtype in ("float32", "bfloat16"):
            for causal, window in ((False, None), (True, None), (True, 64)):
                yield {"shape": [b, t, h, d], "dtype": dtype,
                       "causal": causal, "window": window}


def _run_flash(cfg, device):
    """The forward kernel's output; ``ref_rows`` (path shapes) holds the
    float64 reference to the first batch rows."""
    from deeplearning4j_tpu_torch.helpers.flash_attention import flash_fwd

    b, t, h, d = cfg["shape"]
    q, k, v = (_rng(b, t, h, d, dtype=cfg["dtype"], seed=s, device=device)
               for s in (0, 1, 2))
    o, _ = flash_fwd(q, k, v, causal=cfg["causal"], window=cfg["window"])
    rows = cfg.get("ref_rows", b)
    ref = _np_attention(_host64(q[:rows]), _host64(k[:rows]),
                        _host64(v[:rows]), causal=cfg["causal"],
                        window=cfg["window"])
    return o[:rows], ref


def _paged_configs(full: bool):
    # engine-shaped grids (the reference's ``_fused_paged_configs``):
    # page 0 is the trash page, per-row positions are mixed, and row 0
    # is the all-padding row
    grids = [{"pages": 10, "page_size": 8, "maxp": 4, "hq": 4, "hkv": 2,
              "d": 32, "b": 3, "t": 1}]
    if full:
        grids += [
            {"pages": 12, "page_size": 8, "maxp": 4, "hq": 4, "hkv": 4,
             "d": 64, "b": 2, "t": 2},
            {"pages": 8, "page_size": 16, "maxp": 3, "hq": 8, "hkv": 2,
             "d": 48, "b": 4, "t": 1},
        ]
    for g in grids:
        for dtype in ("float32", "bfloat16"):
            yield dict(g, dtype=dtype)


def _run_paged(cfg, device):
    from deeplearning4j_tpu_torch.helpers.paged_attention import (
        paged_decode_attention,
    )

    dt = cfg["dtype"]
    ps, maxp, t = cfg["page_size"], cfg["maxp"], cfg["t"]
    pool_k = _rng(cfg["pages"] * ps, cfg["hkv"], cfg["d"], dtype=dt,
                  seed=20, device=device)
    pool_v = _rng(cfg["pages"] * ps, cfg["hkv"], cfg["d"], dtype=dt,
                  seed=21, device=device)
    q = _rng(cfg["b"], t, cfg["hq"], cfg["d"], dtype=dt, seed=22,
             device=device)
    rng = np.random.default_rng(23)
    block = rng.integers(1, cfg["pages"], size=(cfg["b"], maxp))
    qlast = rng.integers(t - 1, maxp * ps, size=(cfg["b"],))
    qlast[0] = t - 1
    block[0] = 0                                 # all-padding trash row
    for bi in range(cfg["b"]):
        live = int(qlast[bi]) // ps + 1
        block[bi, live:] = 0                     # trash-page-0 padding
    qpos = (qlast - (t - 1))[:, None] + np.arange(t)[None]
    out = paged_decode_attention(
        q, pool_k, pool_v,
        torch.as_tensor(block, dtype=torch.int32, device=device),
        torch.as_tensor(qpos, dtype=torch.int32, device=device),
        page_size=ps)
    gk = _np_gather_pages(_host64(pool_k), block, ps)
    gv = _np_gather_pages(_host64(pool_v), block, ps)
    ref = _np_attention(_host64(q), gk, gv, causal=True, q_positions=qpos)
    return out, ref


def _epilogue_configs(full: bool):
    shapes = [(24, 96)]
    if full:
        shapes += [(64, 128), (17, 40)]
    for m, c in shapes:
        for dtype in ("float32", "bfloat16"):
            for variant in ("residual_dropout", "prologue", "norm_only"):
                yield {"shape": [m, c], "dtype": dtype, "variant": variant}


def _run_epilogue(cfg, device):
    from deeplearning4j_tpu_torch.helpers.fused_epilogue import (
        dropout_residual_norm_2d,
    )

    m, c = cfg["shape"]
    dt = cfg["dtype"]
    h = _rng(m, c, dtype=dt, seed=30, device=device)
    # gamma and beta in h's type, as the layer passes them
    gamma = _rng(c, dtype=dt, seed=32, device=device)
    beta = _rng(c, dtype=dt, seed=33, device=device)
    variant = cfg["variant"]
    res = (_rng(m, c, dtype=dt, seed=31, device=device)
           if variant == "residual_dropout" else None)
    mask, keep = None, 1.0
    if variant != "norm_only":
        keep = 0.75
        mask = torch.as_tensor(
            np.random.default_rng(34).random((m, c)) < keep, device=device)
    out = dropout_residual_norm_2d(h, res, gamma, beta, mask, 1e-5, keep)
    ref = _np_dropout_residual_norm(
        _host64(h), None if res is None else _host64(res), _host64(gamma),
        _host64(beta), 1e-5, None if mask is None else mask.cpu().numpy(),
        keep)
    return out, ref


def _rows2d_configs(full: bool):
    shapes = [(32, 24)]
    if full:
        shapes += [(64, 48), (17, 5)]
    for m, c in shapes:
        yield {"shape": [m, c], "dtype": "float32"}


_LRN = dict(k=2.0, n=5, alpha=1e-4, beta=0.75)


def _run_lrn(cfg, device):
    from deeplearning4j_tpu_torch.helpers.lrn import lrn_fwd_2d

    m, c = cfg["shape"]
    prm = dict(_LRN, **cfg.get("lrn", {}))
    x = _rng(m, c, dtype=cfg["dtype"], seed=6, device=device)
    out = lrn_fwd_2d(x, prm["k"], prm["n"], prm["alpha"], prm["beta"])
    return out, _np_lrn(_host64(x), prm["k"], prm["n"], prm["alpha"],
                        prm["beta"])


def _run_bn_inference(cfg, device):
    from deeplearning4j_tpu_torch.helpers.batch_norm import bn_inference_2d

    m, c = cfg["shape"]
    x = _rng(m, c, dtype=cfg["dtype"], seed=7, device=device)
    mean = _rng(c, dtype="float32", seed=8, device=device)
    var = _rng(c, dtype="float32", seed=9, device=device).abs() + 0.1
    gamma = _rng(c, dtype="float32", seed=10, device=device)
    beta = _rng(c, dtype="float32", seed=11, device=device)
    out = bn_inference_2d(x, mean, var, gamma, beta, 1e-5)
    return out, _np_bn_inference(_host64(x), _host64(mean), _host64(var),
                                 _host64(gamma), _host64(beta), 1e-5)


def _run_bn_training(cfg, device):
    from deeplearning4j_tpu_torch.helpers.batch_norm import bn_train_fwd_2d

    m, c = cfg["shape"]
    x = _rng(m, c, dtype=cfg["dtype"], seed=12, device=device)
    gamma = _rng(c, dtype="float32", seed=13, device=device)
    beta = _rng(c, dtype="float32", seed=14, device=device)
    y, mean, var, _ = bn_train_fwd_2d(x, gamma, beta, 1e-5)
    ry, rm, rv = _np_bn_training(_host64(x), _host64(gamma), _host64(beta),
                                 1e-5)
    # one flat comparison covers the output AND both returned moments
    out = torch.cat([y.double().reshape(-1), mean.double(), var.double()])
    return out, np.concatenate([ry.reshape(-1), rm, rv])


# kernel registry: name (the port kernel's, as ``chip_smoke.py``'s kernels
# line names it) -> (config generator, runner, exact?)
KERNELS: Dict[str, Tuple[Callable, Callable, bool]] = {
    "flash_attention_fwd": (_flash_configs, _run_flash, False),
    "paged_decode_attention": (_paged_configs, _run_paged, False),
    "dropout_residual_norm": (_epilogue_configs, _run_epilogue, False),
    "lrn_fwd": (_rows2d_configs, _run_lrn, False),
    "batch_norm_inference": (_rows2d_configs, _run_bn_inference, False),
    "batch_norm_train_fwd": (_rows2d_configs, _run_bn_training, False),
}


# ---------------------------------------------------------------------------
# classification + report
# ---------------------------------------------------------------------------

def _config_status(stats: Dict[str, float], dtype: str,
                   exact: bool) -> str:
    budget = 0.0 if exact else DTYPE_BUDGET[dtype]
    err = stats["max_rel_error"]
    if err <= budget:
        return "pass"
    if budget and err <= TOLERANCE_SLACK * budget:
        return "tolerance_only"
    return "fail"


def classify(configs: List[Dict[str, Any]]) -> str:
    """Kernel-level divergence class from its per-config results (see
    module docstring for the taxonomy)."""
    statuses = [c["status"] for c in configs]
    if "fail" in statuses:
        by_dtype: Dict[str, set] = {}
        for c in configs:
            by_dtype.setdefault(c.get("dtype", "float32"),
                                set()).add(c["status"])
        for sts in by_dtype.values():
            if "fail" in sts and "pass" in sts:
                return "shape_dependent"
        return "kernel_divergence"
    if "tolerance_only" in statuses:
        return "tolerance_only"
    return "within_tolerance"


def run_sweep(kernels: Optional[Sequence[str]] = None, full: bool = False,
              device="cuda",
              extra: Optional[Dict[str, List[Dict[str, Any]]]] = None
              ) -> Dict[str, Any]:
    """Run the differential grid on ``device`` (``cuda``: the kernels;
    ``cpu``: their plain versions) and build the report; ``extra`` adds
    configs by kernel name (the path's shapes)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the kernel sweep runs on the card and no GPU "
                           "is present; pass device=\"cpu\" for the "
                           "plain versions")
    report: Dict[str, Any] = {"schema": 1, "platform": dev.type,
                              "torch_version": torch.__version__,
                              "dtype_budgets": dict(DTYPE_BUDGET),
                              "kernels": {}, "all": []}
    for name in (kernels or KERNELS):
        gen, run, exact = KERNELS[name]
        entries: List[Dict[str, Any]] = []
        for cfg in list(gen(full)) + list((extra or {}).get(name, [])):
            entry = dict(cfg)
            out, ref = run(cfg, dev)
            entry.update(measure(out, ref, cfg["dtype"]))
            entry["status"] = _config_status(entry, cfg["dtype"], exact)
            entries.append(entry)
        cls = classify(entries)
        worst = (max(entries, key=lambda e: e["max_rel_error"])
                 if entries else None)
        by_dtype = {}
        for e in entries:
            cur = by_dtype.get(e["dtype"])
            if cur is None or e["max_rel_error"] > cur["max_rel_error"]:
                by_dtype[e["dtype"]] = e
        kd = {
            "configs": entries,
            "classification": cls,
            "trusted": cls in ("within_tolerance", "tolerance_only"),
            "max_rel_error": worst["max_rel_error"] if worst else None,
            # the worst config of each dtype: max-abs, max-rel, ULP spread
            "by_dtype": {dt: {k: e[k] for k in (
                "max_abs_error", "max_rel_error", "ulp_max", "ulp_p99")}
                for dt, e in by_dtype.items()},
            "worst_config": ({k: worst[k] for k in
                              ("shape", "dtype", "causal", "window",
                               "variant", "page_size", "pages")
                              if k in worst} if worst else None),
        }
        report["kernels"][name] = kd
        if worst is not None:
            report["all"].append({
                "metric": f"Kernel max rel error ({name})",
                "value": worst["max_rel_error"],
                "unit": "rel", "classification": cls,
                "configs": len(entries),
                "failing_configs": sum(
                    1 for e in entries if e["status"] == "fail"),
            })
    report["summary"] = {
        "kernels": len(report["kernels"]),
        "untrusted": sorted(n for n, k in report["kernels"].items()
                            if not k["trusted"]),
        "failing_configs": sum(
            e.get("failing_configs", 0) for e in report["all"]),
    }
    return report


def publish_metrics(report: Dict[str, Any], registry=None) -> None:
    """Mirror each kernel's worst-config error into the gauge family."""
    if registry is None:
        from deeplearning4j_tpu_torch.observability import get_registry
        registry = get_registry()
    g = registry.gauge(
        _KERNEL_ERR, "Worst-config max relative error of each fused "
        "kernel vs its float64 reference, from the most recent "
        "kernel-trust sweep (observability.kerneldiff)",
        labels=("kernel",))
    for name, k in report["kernels"].items():
        if k["max_rel_error"] is not None:
            g.set(k["max_rel_error"], kernel=name)


def format_report(report: Dict[str, Any]) -> str:
    lines = [f"kernel trust sweep ({report['platform']}, "
             f"torch {report['torch_version']})"]
    for name, k in report["kernels"].items():
        err = (f"{k['max_rel_error']:.3g}"
               if k["max_rel_error"] is not None else "n/a")
        lines.append(
            f"  {'ok ' if k['trusted'] else 'BAD'} {name:<24} "
            f"max_rel={err:<10} {k['classification']} "
            f"({len(k['configs'])} configs)")
        for dt, e in sorted(k.get("by_dtype", {}).items()):
            lines.append(
                f"      {dt:<9} max_abs={e['max_abs_error']:.3g} "
                f"max_rel={e['max_rel_error']:.3g} "
                f"ulp_p99={e['ulp_p99']:g} ulp_max={e['ulp_max']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--full", action="store_true", help="the full grid")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated subset of kernels")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the report as JSON")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="compare against a report written by --out with "
                         "regression.KERNEL_TRUST_RULES")
    args = ap.parse_args(argv)
    for path in (args.out, args.baseline):
        if path and os.path.basename(path) == "kernel_trust.json":
            ap.error("the port's sweep is neither written into nor "
                     "compared with kernel_trust.json")
    names = args.kernels.split(",") if args.kernels else None
    report = run_sweep(kernels=names, full=args.full, device=args.device)
    publish_metrics(report)
    print(format_report(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
    rc = 0
    if args.baseline:
        from deeplearning4j_tpu_torch.observability import regression

        with open(args.baseline) as f:
            base = json.load(f)
        rep = regression.compare(base, report,
                                 regression.KERNEL_TRUST_RULES)
        print(rep.format())
        rc = rep.exit_code
    if report["summary"]["untrusted"]:
        print(f"UNTRUSTED kernels: {report['summary']['untrusted']}",
              file=sys.stderr)
        rc = rc or 1
    return rc


if __name__ == "__main__":
    sys.exit(main())

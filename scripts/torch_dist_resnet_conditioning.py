"""ResNet-50 in float32 under the sync master across two processes,
against the single net in float32 and both against a float64 single
net: how far each float32 run lies from float64, leaf by leaf.

    python3 scripts/torch_dist_resnet_conditioning.py [--steps 2]

On one GPU: builds the kernels, runs ``chip_smoke.py``'s distributed
children (two processes on ``cuda:0`` over gloo, 2 x 2 data slots of 8
images, the phase's (c) run), the single net in float32 (the kernels
on), the one-process sync master over four slots, and the single net
in float32 with the helpers off and in float64 (the helpers off: the
kernels take no float64), all from one seed on the same 32 images, SGD at ``chip_smoke.PARALLEL_SGD_LR``.
Prints the card's name and power limit, then for each float32 run the
leaves farthest from float64: the largest |params - params64| over
the leaf's largest |params64|, and the change's relative error
``||d - d64|| / ||d64||``.  ``--cpu --tiny`` checks the script on the
host at 32 x 32 with one block a stage, without the children.

    python3 scripts/torch_dist_resnet_conditioning.py --faults none drop local_bn

On one GPU: the smoke's (c) readings (``chip_smoke.resnet_oracle``:
its oracle, step 2 no farther from float64 than twice the single
float32 net, and step 1 against the single net at ``SYNC_TOL`` and
``CHANGE_LIMIT``, which the smoke prints) on the same two children
with a fault planted in both, by patching the port's functions in the
children only: ``drop`` sums rank 0's partial
alone in the gradient exchange (rank 1's gradient left out),
``local_bn`` runs BatchNorm on each process's own rows (its statistics
and its parameters' gradient local), ``none`` plants nothing.  Prints
each reading and whether it holds.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch import helpers  # noqa: E402
from deeplearning4j_tpu_torch.models.common import tree_map  # noqa: E402


def _params(net):
    return {n: t.detach().double().cpu() for n, t in cs.named_state(net)
            if n.startswith("params")}


def _report(what, run, ref, p0, top=4):
    """Leaves whose float64 change is below ``RESNET_NOISE`` of the
    largest (the conv biases before a BatchNorm: exact gradient 0) are
    left out, as the smoke's change ratio leaves them."""
    big = max(float((ref[n] - p0[n]).norm()) for n in ref)
    rows = []
    for n in ref:
        if float((ref[n] - p0[n]).norm()) < cs.RESNET_NOISE * big:
            continue
        err = float((run[n] - ref[n]).abs().max())
        scale = float(ref[n].abs().max()) or 1.0
        d, d64 = run[n] - p0[n], ref[n] - p0[n]
        den = float(d64.norm())
        rows.append((err / scale, float((d - d64).norm()) / den
                     if den else 0.0, n, err))
    by_w = sorted(rows, reverse=True)[:top]
    by_d = sorted(rows, key=lambda r: -r[1])[:top]
    print(f"{what}: largest |params - params64| over max |params64| "
          + "; ".join(f"{n} {r:.3e} ({e:.3e})" for r, _, n, e in by_w))
    print(f"{what}: largest change error against float64's change "
          + "; ".join(f"{n} {c:.3e}" for _, c, n, _ in by_d))


def _plant(fault):
    """Patch the port in this child (module docstring's faults)."""
    from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
    from deeplearning4j_tpu_torch.backend import slots

    if fault == "drop":
        mesh_mod.process_sum_many = lambda ts, op="all-reduce": [
            g[0] for g in mesh_mod.process_all_gather_many(ts, op)]
    elif fault == "local_bn":
        slots.gather_rows = lambda x: x
        slots.own_rows = lambda y: y
        slots.coupled_params = lambda p: p
    elif fault != "none":
        raise ValueError(f"unknown fault {fault!r}")


def _faults(faults):
    """Each fault's children and ``chip_smoke.resnet_oracle``'s readings."""
    with tempfile.TemporaryDirectory() as tmp:
        for fault in faults:
            vec = f"{tmp}/{fault}-{{rank}}.npy"
            vec1 = f"{tmp}/{fault}1-{{rank}}.npy"
            _, secs = cs._run_children(2, "gloo", [
                {"name": "resnet", "kind": "resnet", "steps": 2,
                 "vec": vec, "vec1": vec1}], tmp,
                child=[sys.executable, __file__, "--child", fault])
            got = cs.resnet_oracle(np.load(vec1.format(rank=0)),
                                   np.load(vec.format(rank=0)))
            print(f"fault {fault} (children {secs:.1f} s): step 1 params "
                  f"max abs err {got['err1']:.3e} "
                  f"({'holds' if got['ok1'] else 'FAILS'} {cs.SYNC_TOL}), "
                  f"the change's largest relative error {got['rel1']:.3e} "
                  f"({'holds' if got['rel1'] <= cs.CHANGE_LIMIT else 'FAILS'}"
                  f" {cs.CHANGE_LIMIT:g}); step 2 against float64 "
                  f"{got['e2']:.3e}, the single float32 net {got['e1']:.3e}"
                  f" ({'holds' if got['e2'] <= 2 * got['e1'] else 'FAILS'}"
                  f" twice it)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        _plant(argv[1])
        return cs.distributed_child(argv[2])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--faults", nargs="+", default=None)
    args = ap.parse_args(argv)
    dev = "cpu" if args.cpu else "cuda"
    if args.cpu:
        torch.cuda.synchronize = lambda *a, **k: None   # the host's check
    if dev == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device available", file=sys.stderr)
            return 2
        print(cs.card())
        cs.pin_fp32_precision()
        cs.build_kernels()
        if args.faults:
            _faults(args.faults)
            return 0
    kw = dict(height=32, width=32, stem_stride=1,
              blocks=(1, 1, 1, 1)) if args.tiny else {}
    ds = cs._resnet_global(2)
    if args.tiny:
        ds.features = ds.features[:, :32, :32, :]
    base = cs.resnet50(device=dev, updater="sgd", lr=cs.PARALLEL_SGD_LR,
                       seed=12345, **kw)
    base._capture = False
    p0 = _params(base)
    child = None
    if dev == "cuda":
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            kids, _ = cs._run_children(2, "gloo", [
                {"name": "resnet", "kind": "resnet", "steps": args.steps,
                 "vec": f"{tmp}/resnet-{{rank}}.npy"}], tmp)
            vec = np.load(f"{tmp}/resnet-0.npy")
            print(f"children: {time.perf_counter() - t0:.1f} s")
        net = base.clone()
        net.set_params_vector(vec)
        child = _params(net)
    single = base.clone()
    single._capture = False
    for _ in range(args.steps):
        single.fit(ds.features, ds.labels)
    one = base.clone()
    one._capture = False
    cs._dist_fit(one, cs.mesh_mod.default_mesh(data=4, devices=[dev] * 4),
                 [ds] * args.steps)
    off = base.clone()
    off._capture = False
    with helpers.helpers_disabled():
        for _ in range(args.steps):
            off.fit(ds.features, ds.labels)
    f64 = base.clone()
    f64._capture = False
    for part in ("params", "updater_state", "net_state"):
        setattr(f64, part, tree_map(lambda t: t.double(),
                                    getattr(f64, part)))
    with helpers.helpers_disabled():
        for _ in range(args.steps):
            f64.fit(ds.features.astype(np.float64),
                    ds.labels.astype(np.float64))
    ref = _params(f64)
    s32, s1 = _params(single), _params(one)
    print(f"the one-process master equals the single net bit for bit: "
          f"{all(torch.equal(s32[n], s1[n]) for n in s32)}")
    _report("single net float32", s32, ref, p0)
    _report("single net float32, the kernels off", _params(off), ref, p0)
    _report("single net float32, the kernels on against off", s32,
            _params(off), p0)
    runs = [("single net float32", s32),
            ("single net float32, the kernels off", _params(off))]
    if child is not None:
        runs.append(("two processes float32", child))
    for what, run in runs:
        print(f"{what}: the change against float64's over every "
              f"parameter {cs._change_vs(run, ref, p0):.3e}")
    if child is not None:
        _report("two processes float32", child, ref, p0)
        _report("two processes against the single float32 net", child,
                s32, p0)
    return 0


if __name__ == "__main__":
    sys.exit(main())

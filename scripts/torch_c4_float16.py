"""Where the full-width float16 char-LM overflows (ROADMAP C4).

The model is ``chip_smoke.py``'s training char-LM (vocab 128, d_model
1024, 8 heads, 8 layers, ``bench.py``'s batch: ``RandomState(0)`` ids,
labels the ids rolled by one) in float16, under the stability guard with
a STATIC loss scale, and with the numerics ledger collecting every step
exactly (``sample=0``).

``--cpu``: the port (plain kernels) and the JAX package, the port's
weights copied from the JAX net, one row of the batch; prints each
side's loss, non-finite count and the ledger's per-layer float16 flags
and max-abs for gradients and activations.  (The JAX side needs the
JAX package; this mode runs where it is installed.)

default (the card): the port on the GPU at the full batch (8 x 2048),
once through the kernels and once with helpers disabled (the plain
PyTorch versions).  Each pass runs one eager step and prints: the loss,
the ledger's per-layer float16 verdicts, each layer output's forward
max-abs and its gradient's max-abs in backward order, and the first op
(forward or backward, with the layer it belongs to) whose float16
output holds an infinity or a NaN, found with a dispatch mode that
checks every op's output.

    python3 scripts/torch_c4_float16.py [--scale 2 --scale 16] [--cpu]
        [--t 2048] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MODEL = dict(vocab_size=128, d_model=1024, n_heads=8, layers=8,
             seed=12345, compute_dtype="float16")
F16_MAX = 65504.0


def batch(rows, t):
    ids = np.random.RandomState(0).randint(0, MODEL["vocab_size"], (8, t))
    ids = ids[:rows]
    return ids, np.eye(MODEL["vocab_size"],
                       dtype=np.float32)[np.roll(ids, -1, 1)]


def policies(scale):
    return dict(stability=dict(loss_scaling="static", loss_scale=scale),
                numerics=dict(interval=1, sample=0))


def ledger_rows(state, mod, net):
    """(component, layer, max_abs, float16 overflow) rows read straight
    off a ledger's packed vector (``mod``: either package's numerics
    module; the reference's harvest raises on a NaN block)."""
    plan = mod.plan_for(net)
    packed = state["packed"]
    packed = (packed.detach().cpu().numpy() if torch.is_tensor(packed)
              else np.asarray(packed))
    lay = mod._layout(plan)
    out = []
    for comp, key, names in (("activations", "act", plan.act_names),
                             ("gradients", "grad", plan.grad_names)):
        block = packed[lay[key]]
        for i, layer in enumerate(names):
            m = float(block[i * mod.ENTRY])
            out.append((comp, layer, m, not m <= F16_MAX))
    return out


class FirstNonFinite(TorchDispatchMode):
    """Records the first op whose float16 output holds an infinity or a
    NaN, with the phase and layer the caller set."""

    def __init__(self):
        super().__init__()
        self.where = ("forward", None)
        self.first = None
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        # an allocation's output is uninitialised until a kernel fills it
        if self.first is None and "empty" not in str(func):
            for t in tree_flatten(out)[0]:
                if (torch.is_tensor(t) and t.dtype == torch.float16
                        and t.numel()
                        and not bool(torch.isfinite(t).all())):
                    self.first = (str(func), *self.where)
                    break
        return out


def card_pass(scale, t, kernels):
    from deeplearning4j_tpu_torch import helpers
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm
    from deeplearning4j_tpu_torch.observability import numerics

    helpers.enable_helpers(kernels)
    net = transformer_char_lm(device="cuda", **MODEL, **policies(scale))
    net._capture = False
    ids, lab = batch(8, t)
    x = torch.as_tensor(ids, device="cuda")
    y = torch.as_tensor(lab, device="cuda")
    # the ledger's step (guarded: a non-finite step writes no parameter)
    net.fit(x, y)
    rows = ledger_rows(net.updater_state["__numerics__"], numerics, net)
    stab = net.updater_state["__stability__"]
    # the same step by hand, with hooks on each layer's output
    acts, grads = [], []
    mode = FirstNonFinite()
    leaves = [p for p in net.params.values() for p in _leaves(p)]
    for p in leaves:
        p.requires_grad_(True)
    with mode:
        loss, _ = net._loss_fn(net.params, x, y, None, train=True,
                               collect=acts)
        for name, a in acts:
            a.register_hook(lambda g, name=name: (
                grads.append((name, float(g.float().abs().max()),
                              bool(torch.isfinite(g).all()))),
                setattr(mode, "where", ("backward", name)))[0])
        mode.where = ("backward", "loss")
        (loss * scale).backward()
    for p in leaves:
        p.requires_grad_(False)
    fwd = [(name, float(a.detach().float().abs().max())) for name, a in acts]
    return {"kernels": kernels, "loss": float(loss),
            "nonfinite_total": float(stab["nonfinite_total"]),
            "ledger": rows, "forward_max_abs": fwd,
            "backward_grad_max_abs": grads,
            "first_nonfinite_op": mode.first, "ops_checked": mode.ops}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def cpu_compare(scale, t):
    from deeplearning4j_tpu.models.zoo import (
        transformer_char_lm as jax_lm,
    )
    from deeplearning4j_tpu.nn.conf import (
        TrainingNumerics, TrainingStability,
    )
    from deeplearning4j_tpu.observability import numerics as jnum
    from deeplearning4j_tpu_torch.models.zoo import transformer_char_lm
    from deeplearning4j_tpu_torch.observability import numerics

    pol = policies(scale)
    jnet = jax_lm(**MODEL, stability=TrainingStability(**pol["stability"]),
                  numerics=TrainingNumerics(**pol["numerics"]))
    net = transformer_char_lm(device="cpu", **MODEL, **pol)
    net.set_params_vector(np.asarray(jnet.params_to_vector()))
    ids, lab = batch(1, t)
    net.fit(ids, lab)
    jnet.fit(ids, lab)
    out = {}
    for side, n, mod in (("port", net, numerics), ("jax", jnet, jnum)):
        stab = n.updater_state["__stability__"]
        out[side] = {"loss": float(n.score_value),
                     "nonfinite_total": float(np.asarray(
                         stab["nonfinite_total"])),
                     "ledger": ledger_rows(n.updater_state["__numerics__"],
                                           mod, n)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, action="append",
                    help="loss scales to try (repeatable; default 2)")
    ap.add_argument("--t", type=int, default=2048)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    scales = args.scale or [2.0]
    if args.cpu:
        res = {"cpu": {str(sc): cpu_compare(sc, args.t) for sc in scales}}
    else:
        if not torch.cuda.is_available():
            print("needs a CUDA device (or --cpu)", file=sys.stderr)
            return 2
        res = {"card": {str(sc): [card_pass(sc, args.t, k)
                                  for k in (True, False)]
                        for sc in scales}}
    res.update(t=args.t)
    text = json.dumps(res)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How far float32 first-step gradients of ResNet-50 lie from float64, on
the BatchNorm kernels' path and on the built-in path, on one CUDA card.

    python3 scripts/torch_resnet50_grad_precision.py

The port's ResNet-50 (``deeplearning4j_tpu_torch.models.zoo.resnet50``,
seeded random weights) at 224x224, batch 128, on ``bench.py``'s batch.
Prints the loss and, for the nodes farthest from float64, the relative
L2 distance of each node's gradients: kernels (float32) to float64,
built-in path (float32) to float64, and kernels to built-in.  The
float64 run has the helpers disabled (the kernels do not take float64),
so it is the built-in formula in float64.  cuDNN runs deterministically.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from deeplearning4j_tpu_torch import helpers  # noqa: E402
from deeplearning4j_tpu_torch.backend.device import pin_fp32_precision  # noqa: E402
from deeplearning4j_tpu_torch.models.common import cast_tree, tree_leaves  # noqa: E402
from deeplearning4j_tpu_torch.models.zoo import resnet50  # noqa: E402


def node_grads(net, x, y, dtype, kernels: bool):
    """Loss and {node: flat gradient in float64} of one forward/backward
    with every tensor in ``dtype``."""
    helpers.enable_helpers(kernels)
    try:
        params = {k: {n: t.detach().to(dtype).requires_grad_()
                      for n, t in v.items()}
                  for k, v in net._trainable(net.params).items()}
        full = {n.name: params.get(n.name, {}) for n in net.conf.nodes}
        loss, _ = net._loss_fn(full, cast_tree(net.net_state, dtype),
                               x.to(dtype), y.to(dtype), None)
        names = sorted(params)
        flat = [p for n in names for p in tree_leaves(params[n])]
        grads = torch.autograd.grad(loss, flat)
    finally:
        helpers.enable_helpers(True)
    out, i = {}, 0
    for n in names:
        k = len(tree_leaves(params[n]))
        out[n] = torch.cat([g.reshape(-1).double() for g in grads[i:i + k]])
        i += k
    return float(loss.detach()), out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    pin_fp32_precision()
    torch.backends.cudnn.deterministic = True
    net = resnet50(device="cuda")
    net.conf = dataclasses.replace(net.conf, compute_dtype=None)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(128, 224, 224, 3).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
        rs.randint(0, 1000, 128)], device="cuda")
    l64, g64 = node_grads(net, x, y, torch.float64, False)
    lk, gk = node_grads(net, x, y, torch.float32, True)
    lb, gb = node_grads(net, x, y, torch.float32, False)
    print(torch.cuda.get_device_name(0))
    print(f"loss float64 {l64:.9f}, kernels float32 {lk:.9f}, built-in "
          f"float32 {lb:.9f}")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    rk = {n: rel(gk[n], g64[n]) for n in g64}
    rb = {n: rel(gb[n], g64[n]) for n in g64}
    for n in sorted(g64, key=lambda n: -max(rk[n], rb[n]))[:10]:
        print(f"{n:14s} kernels-f32 vs f64 {rk[n]:.3e}, built-in-f32 vs "
              f"f64 {rb[n]:.3e}, kernels vs built-in {rel(gk[n], gb[n]):.3e}")
    print(f"largest: kernels {max(rk.values()):.3e}, built-in "
          f"{max(rb.values()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

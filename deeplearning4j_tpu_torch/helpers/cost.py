"""What a step costs: its matmul and convolution operations and the bytes
its ops read and write, counted once on a step's first eager run — the
step profiler's cost (``observability/profiling.py``), the port's
counterpart of the reference's XLA cost analysis.

``StepCost`` is a ``TorchDispatchMode``: each aten op that passes
through it adds the bytes of its tensor operands and results (views and
allocations move none), and matmuls and convolutions their operations by
``torch.utils.flop_counter``'s formulas.  The kernels are ``ctypes``
launches that the dispatcher never sees, so each wrapper reports its own
analytic operations and bytes through ``kernel_cost`` — the counts the
kernels' bounds in ``chip_smoke.py`` use — and the dispatcher's count
pauses inside it: on the CPU the plain version's aten ops are not
counted a second time.  The autograd engine carries the mode to the
thread that runs a backward on the card, so the backward kernels
report into the same count.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode,
)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# ops that allocate or alias and so move no bytes
_NO_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like,
             _aten.new_empty, _aten.new_empty_strided, _aten.detach,
             _aten.lift_fresh, _aten.alias}


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class StepCost(TorchDispatchMode):
    """Counts the operations and bytes of the aten ops run under it, and
    the kernels' reported ones (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            packet = func.overloadpacket
            formula = flop_registry.get(packet)
            if formula is not None:
                self.flops += float(formula(*args, **kwargs, out_val=out))
            if (not getattr(func, "is_view", False)
                    and packet not in _NO_BYTES):
                self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    @property
    def is_paused(self) -> bool:
        return self._paused > 0

    def add_kernel(self, flops: float, nbytes: float) -> None:
        if not self._paused:
            self.kernel_flops += float(flops)
            self.kernel_bytes += float(nbytes)

    @contextlib.contextmanager
    def paused(self):
        """Nothing is counted inside (a kernel's plain version, a graph
        capture of a body already counted)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def as_dict(self) -> Dict[str, float]:
        """``flops`` and ``bytes_accessed`` (the reference's cost-analysis
        keys), the kernels' share of each beside them."""
        return {"flops": self.flops + self.kernel_flops,
                "bytes_accessed": self.bytes + self.kernel_bytes,
                "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes}


def active() -> Optional[StepCost]:
    """The ``StepCost`` counting on this thread (or carried to it by the
    autograd engine), or None."""
    mode = _get_current_dispatch_mode()
    return mode if isinstance(mode, StepCost) else None


@contextlib.contextmanager
def kernel_cost(work: Callable[[], Tuple[float, float]]):
    """A kernel call's analytic cost, ``work() -> (operations, bytes)``
    (called only where a ``StepCost`` is counting, never while it is
    paused — inside a graph capture — so a count that depends on the
    data may read it); the aten ops inside (a plain version's, an
    output's allocation) are not counted."""
    mode = active()
    if mode is None or mode.is_paused:
        yield
        return
    with mode.paused():
        flops, nbytes = work()
    mode.add_kernel(flops, nbytes)
    with mode.paused():
        yield


@contextlib.contextmanager
def paused():
    """Pause the counting ``StepCost``, if any, inside the block."""
    mode = active()
    if mode is None:
        yield
        return
    with mode.paused():
        yield


def live_pairs(t: int, causal: bool, window: Optional[int],
               s: Optional[int] = None) -> int:
    """(query, key) pairs inside the mask of one (batch, head) of a
    T-query attention over S (= T) keys."""
    s = t if s is None else s
    if not causal:
        return t * s
    if window is None:
        return t * (t + 1) // 2
    w = min(window, t)
    return w * (w + 1) // 2 + (t - w) * w

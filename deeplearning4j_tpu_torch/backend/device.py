"""Device and dtype policy — counterpart of ``deeplearning4j_tpu/backend/device.py``.

The JAX package lets XLA place arrays; here every tensor lives on an
explicit ``torch.device``.  The port's entry points resolve their
device through ``resolve_device``: ``cuda`` by default, the CPU only
when the caller asks for it by name.  With no GPU and no explicit
``device="cpu"`` they raise — a run that silently fell back to the host
would report host numbers under the card's name.

``DTypePolicy`` is the reference's mixed-precision policy record with
torch dtypes in place of jnp's; the process-wide default comes from
``DL4J_TPU_DTYPE`` (``float32`` or ``bfloat16``), as in the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import threading
from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def pin_fp32_precision() -> None:
    """Full float32 in matmuls and convolutions on the card.  PyTorch's
    default runs float32 convolutions in TF32 (about three decimal
    digits), which would make a float32 parity run disagree with the
    reference for reasons that are not the port's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); anything else is taken
    as given, and a CUDA device without a GPU raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default — pass device='cpu' to run on the host explicitly")
        pin_fp32_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    return dev


def compute_dtype(name: Optional[str]) -> torch.dtype:
    """Config dtype name (``MultiLayerConfiguration.compute_dtype``) ->
    torch dtype; ``None`` means float32."""
    if name is None:
        return torch.float32
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported dtype '{name}'; known: {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy (reference ``backend/device.py:161``):
    params and optimizer state in ``param_dtype`` (float32 master
    weights), activations cast to ``compute_dtype``, accumulation in
    ``accum_dtype``; the float32 policy is the reference's exact one."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    def cast_input(self, x):
        """``x`` (a tensor, or dicts, lists and tuples of them) with every
        floating tensor cast to ``compute_dtype``."""
        if isinstance(x, dict):
            return {k: self.cast_input(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self.cast_input(v) for v in x)
        if torch.is_tensor(x) and x.is_floating_point():
            return x.to(self.compute_dtype)
        return x


_POLICIES = {
    "float32": DTypePolicy(),
    "bfloat16": DTypePolicy(compute_dtype=torch.bfloat16),
}
_current_policy = _POLICIES[os.environ.get("DL4J_TPU_DTYPE", "float32")]


def dtype_policy() -> DTypePolicy:
    return _current_policy


def set_dtype_policy(name: str) -> DTypePolicy:
    global _current_policy
    _current_policy = _POLICIES[name]
    return _current_policy


_side_streams: Dict[int, "torch.cuda.Stream"] = {}


class _Capture(threading.local):
    """Per thread: a capture lets other threads run on (its error mode is
    ``thread_local``), so only the capturing thread sees its scratch."""

    scratch: Optional[dict] = None     # the scratch of the capture under way


_capture = _Capture()


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per device, made at first use: warm-ups reuse it,
    so per-stream caches (BatchNorm's arrival counters) stay bounded."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stream = _side_streams.get(index)
    if stream is None:
        stream = _side_streams[index] = torch.cuda.Stream(index)
    return stream


def warm_on_side_stream(fn, device: torch.device):
    """Run ``fn()`` once on the device's side stream and join it back:
    the call before a capture, so that library handles and workspaces
    come up outside the captured region.  Returns what ``fn`` returned."""
    side = side_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


def capture_scratch(key, make, fits=None) -> Optional[torch.Tensor]:
    """Inside a ``capture_graph``: the capture's scratch tensor ``key``,
    made by ``make()`` at its first use in the capture (so that its
    initialisation is a node of the graph, run at every replay) and made
    again when ``fits(tensor)`` is false; every one made is kept alive as
    long as the graph.  Outside a capture on this thread: None."""
    scratch = _capture.scratch
    if scratch is None:
        return None
    t = scratch.get(key)
    if t is None or (fits is not None and not fits(t)):
        t = scratch[key] = make()
        scratch.setdefault(None, []).append(t)
    return t


def capture_graph(fn, pool=None):
    """Capture ``fn()`` into a CUDA graph, into the graph memory ``pool``
    when given; the caller warms ``fn`` first (``warm_on_side_stream``).
    ``fn`` runs exactly once, inside the capture.  Returns (the graph,
    what the captured call returned: the tensors every replay rewrites).
    The graph keeps the capture's scratch tensors (``capture_scratch``)
    as ``graph.scratch``.  A capture that fails raises.

    The garbage collector is held off for the capture: a dropped net
    lives on in a reference cycle with its captured graphs and pinned
    staging buffers, and releasing them while a capture is under way
    invalidates the capture (``tests/test_torch_cuda.py``,
    ``test_a_collected_cycle_does_not_break_a_capture``)."""
    graph = torch.cuda.CUDAGraph()
    _capture.scratch = scratch = {}
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = fn()
    finally:
        if collecting:
            gc.enable()
        graph.scratch, _capture.scratch = scratch.get(None, []), None
    return graph, out


class PinnedRing:
    """A ring of pinned host staging slots for copies that run ahead of
    the host: a slot is handed out again only after the event recorded
    behind its last copies has completed, so a queued host-to-device
    copy never reads a buffer the host has already rewritten.  A slot
    holds one pinned tensor per name, remade when the shape or type
    changes.  ``event`` makes the events (``torch.cuda.Event``; a test
    passes a fake)."""

    def __init__(self, depth: int = 4, event=None):
        self._slots = [{} for _ in range(depth)]
        self._events = [None] * depth
        self._next = 0
        self._event = event

    def acquire(self) -> int:
        """The next slot, once its last copies are done."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        ev = self._events[i]
        if ev is not None and not ev.query():
            ev.synchronize()
        self._events[i] = None
        return i

    def buffer(self, slot: int, name, shape, dtype) -> torch.Tensor:
        """Slot ``slot``'s pinned tensor ``name`` of ``shape``/``dtype``."""
        bufs = self._slots[slot]
        t = bufs.get(name)
        if t is None or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            t = bufs[name] = torch.empty(tuple(shape), dtype=dtype,
                                         pin_memory=True)
        return t

    def release(self, slot: int) -> None:
        """Record an event behind the copies just queued from ``slot``."""
        ev = (self._event or torch.cuda.Event)()
        ev.record()
        self._events[slot] = ev

"""Device and dtype policy — counterpart of ``deeplearning4j_tpu/backend/device.py``.

The JAX package lets XLA place arrays; here every tensor lives on an
explicit ``torch.device``.  The port's entry points resolve their
device through ``resolve_device``: ``cuda`` by default, the CPU only
when the caller asks for it by name.  With no GPU and no explicit
``device="cpu"`` they raise — a run that silently fell back to the host
would report host numbers under the card's name.
"""

from __future__ import annotations

from typing import Optional, Union

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


def warm_on_side_stream(fn, device: torch.device) -> None:
    """Run ``fn()`` once on a side stream of ``device`` and join it back:
    the call before a capture, so that library handles and workspaces
    come up outside the captured region."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)


def capture_graph(fn, pool=None):
    """Capture ``fn()`` into a CUDA graph, into the graph memory ``pool``
    when given; the caller warms ``fn`` first (``warm_on_side_stream``).
    ``fn`` runs exactly once, inside the capture.  Returns (the graph,
    what the captured call returned: the tensors every replay rewrites).
    A capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        out = fn()
    return graph, out

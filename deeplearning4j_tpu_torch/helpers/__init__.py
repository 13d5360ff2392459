"""Accelerated-helper seam — counterpart of ``deeplearning4j_tpu/helpers/__init__.py``.

Layers ask ``get_helper(kind)`` for a kernel-backed implementation and
take their built-in path when it returns ``None`` (helpers disabled).
In the port a helper's kernel is a hand-written CUDA kernel: on a CUDA
tensor it launches or raises, and only a tensor on the CPU goes to the
kernel's plain PyTorch version.

Toggle: ``enable_helpers(False)``, ``with helpers_disabled():`` or env
``DL4J_TORCH_DISABLE_HELPERS=1``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

_enabled = os.environ.get("DL4J_TORCH_DISABLE_HELPERS", "0") != "1"
_registry: Dict[str, object] = {}


def enable_helpers(on: bool = True) -> None:
    """Toggle helper discovery (read at every call: the port has no
    traced programs that would keep an old choice)."""
    global _enabled
    _enabled = on


@contextlib.contextmanager
def helpers_disabled():
    """The built-in paths inside the block (a float64 gradient check on
    the card), then the earlier setting."""
    global _enabled
    was, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = was


def enabled() -> bool:
    """Whether helper discovery is on (a captured program is specialised
    to it)."""
    return _enabled


def kernel_counts() -> Dict[str, object]:
    """Every kernel wrapper's launch and plain-version counts
    (``cuda_build.Counts``), by kernel name."""
    from deeplearning4j_tpu_torch.helpers import (
        batch_norm, flash_attention, fused_epilogue, lrn, paged_attention,
    )

    return {"flash_fwd": flash_attention.fwd_counts,
            "flash_dq": flash_attention.dq_counts,
            "flash_dkv": flash_attention.dkv_counts,
            "prologue": fused_epilogue.counts,
            "paged_decode": paged_attention.counts,
            "bn_inference": batch_norm.inference_counts,
            "bn_train_fwd": batch_norm.train_fwd_counts,
            "bn_train_bwd": batch_norm.train_bwd_counts,
            "lrn_fwd": lrn.fwd_counts,
            "lrn_bwd": lrn.bwd_counts}


def register_helper(kind: str, helper: object) -> None:
    _registry[kind] = helper


def get_helper(kind: str) -> Optional[object]:
    """None when helpers are disabled or none is registered for
    ``kind``; the layer then uses its built-in path."""
    if not _enabled:
        return None
    helper = _registry.get(kind)
    if helper is None:
        # lazy registration on first ask
        from deeplearning4j_tpu_torch.helpers import (
            batch_norm, flash_attention, fused_epilogue, lrn,
            paged_attention,
        )

        register_helper("paged_attention",
                        paged_attention.PagedAttentionHelper())
        register_helper("attention", flash_attention.FlashAttentionHelper())
        register_helper("epilogue", fused_epilogue.FusedEpilogueHelper())
        register_helper("batch_norm", batch_norm.BatchNormHelper())
        register_helper("lrn", lrn.LRNHelper())
        helper = _registry.get(kind)
    return helper

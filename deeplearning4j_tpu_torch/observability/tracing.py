"""Request trace ids — ``new_trace_id`` copied from
``deeplearning4j_tpu/observability/tracing.py`` (the span tracer comes
with the observability slice)."""

from __future__ import annotations

import os


def new_trace_id() -> str:
    """A 16-hex-char request trace id (random; no global coordination)."""
    return os.urandom(8).hex()

"""RnnOutputLayer — counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``
(the LSTM family comes with the recurrent slice)."""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.layers.base import register_layer
from deeplearning4j_tpu_torch.nn.layers.dense import OutputLayer


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(OutputLayer):
    """Per-timestep dense + loss head: [B, T, n_in] -> [B, T, n_out]."""

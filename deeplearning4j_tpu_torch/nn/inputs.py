"""InputType — static shape metadata flowing through config.

Copied from ``deeplearning4j_tpu/nn/inputs.py`` (framework-free).

Reference: ``nn/conf/inputs/InputType.java`` (FF/RNN/CNN variants) used for
layer n_in inference and preprocessor auto-insertion
(``nn/conf/layers/InputTypeUtil.java``, ``ConvolutionLayerSetup.java:42``).

TPU-first conventions (differ deliberately from the reference's ND4J layouts):
- feed-forward: [batch, size]
- recurrent:    [batch, time, size]        (reference: [batch, size, time])
- convolutional:[batch, height, width, ch] (reference NCHW; NHWC is the
  layout XLA tiles best onto the MXU/VPU)
Static shapes are load-bearing: every iterator pads/buckets so jit traces once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str  # "ff" | "rnn" | "cnn" | "cnn_flat"
    size: Optional[int] = None          # ff/rnn feature size
    timesteps: Optional[int] = None     # rnn known seq length (None = dynamic->padded)
    height: Optional[int] = None
    width: Optional[int] = None
    channels: Optional[int] = None

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", size=size)

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType("rnn", size=size, timesteps=timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", height=height, width=width, channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        """Flattened image rows (e.g. raw MNIST vectors), reference
        ``InputType.convolutionalFlat``."""
        return InputType(
            "cnn_flat",
            size=height * width * channels,
            height=height,
            width=width,
            channels=channels,
        )

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn", "cnn_flat"):
            return self.size
        return self.height * self.width * self.channels

    def batch_shape(self, batch: int) -> Tuple[int, ...]:
        if self.kind in ("ff", "cnn_flat"):
            return (batch, self.size)
        if self.kind == "rnn":
            return (batch, self.timesteps or 1, self.size)
        return (batch, self.height, self.width, self.channels)

    def to_dict(self):
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    @staticmethod
    def from_dict(d) -> "InputType":
        return InputType(**d)

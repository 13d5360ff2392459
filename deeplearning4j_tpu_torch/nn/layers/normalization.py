"""BatchNormalization, LocalResponseNormalization and LayerNorm —
counterpart of ``deeplearning4j_tpu/nn/layers/normalization.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.helpers.lrn import window_sum
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer
@dataclasses.dataclass(frozen=True)
class BatchNormalization(Layer):
    """Batch normalization over every axis but the trailing channel axis
    (rank-2 dense and rank-4 NHWC alike), running mean and var in the
    layer's state (float32), updated at train time with ``decay`` and the
    biased batch variance, as the reference.

    Every call at every rank goes through the ``"batch_norm"`` helper
    (the JAX package sends only rank-2 training calls there, below a VMEM
    cap; both gates are TPU layout limits).  On a CUDA tensor the helper
    does not take (float64) the layer raises: the built-in path runs on
    the card only with helpers disabled.  The built-in path below is the
    reference's jnp formula, with its dtype promotion: under a bfloat16
    compute dtype the float32 running stats make the inference output
    float32, where the helper returns x's type."""

    n_out: Optional[int] = None   # feature/channel count (inferred)
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False  # fixed gamma/beta, no params
    gamma: float = 1.0
    beta: float = 0.0
    activation: str = "identity"

    def setup(self, input_type: InputType) -> "BatchNormalization":
        if self.n_out is None:
            n = (input_type.channels if input_type.kind == "cnn"
                 else input_type.flat_size())
            return dataclasses.replace(self, n_out=n)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self) -> bool:
        return not self.lock_gamma_beta

    def param_shapes(self):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": (self.n_out,), "beta": (self.n_out,)}

    def init(self, gen, dtype=torch.float32, device=None):
        return {name: torch.full(shape, getattr(self, name), dtype=dtype,
                                 device=device)
                for name, shape in self.param_shapes().items()}

    def init_state(self, device=None):
        return {"mean": torch.zeros((self.n_out,), dtype=torch.float32,
                                    device=device),
                "var": torch.ones((self.n_out,), dtype=torch.float32,
                                  device=device)}

    def _affine(self, params, x):
        if self.lock_gamma_beta:
            return (torch.full((self.n_out,), self.gamma, dtype=x.dtype,
                               device=x.device),
                    torch.full((self.n_out,), self.beta, dtype=x.dtype,
                               device=x.device))
        return params["gamma"], params["beta"]

    def _moving(self, state, mean, var):
        with torch.no_grad():
            return {"mean": self.decay * state["mean"]
                    + (1 - self.decay) * mean.detach(),
                    "var": self.decay * state["var"]
                    + (1 - self.decay) * var.detach()}

    def apply(self, params, x, *, train=False, rng=None):
        raise TypeError("BatchNormalization is stateful: call "
                        "apply_with_state(params, state, x, ...)")

    def apply_with_state(self, params, state, x, *, train=False, rng=None):
        act = activations.get(self.activation)
        helper = helpers.get_helper("batch_norm")
        use_helper = helper is not None and helper.supports(x)
        if helper is not None and not use_helper and x.device.type != "cpu":
            raise TypeError(
                f"BatchNormalization: the batch_norm kernels do not take "
                f"{x.dtype} {tuple(x.shape)} on {x.device}; disable the "
                "helpers (helpers.enable_helpers(False)) for the built-in "
                "path")
        if train:
            if use_helper:
                gamma, beta = self._affine(params, x)
                y, mean, var = helper.apply_training(x, gamma, beta, self.eps)
                return act(y), self._moving(state, mean, var)
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)
            new_state = self._moving(state, mean, var)
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
            if use_helper:
                gamma, beta = self._affine(params, x)
                y = helper.apply_inference(x, mean, var, gamma, beta,
                                           self.eps)
                return act(y), new_state
        xhat = (x - mean) * torch.rsqrt(var + self.eps)
        if self.lock_gamma_beta:
            y = self.gamma * xhat + self.beta
        else:
            y = params["gamma"] * xhat + params["beta"]
        return act(y), new_state


@register_layer
@dataclasses.dataclass(frozen=True)
class LocalResponseNormalization(Layer):
    """LRN across the trailing channel axis (NHWC):
    ``y = x / (k + alpha * Σ_{|w| <= n/2} x[c + w]²)^beta``, with the
    reference's defaults k = 2, n = 5, alpha = 1e-4, beta = 0.75.  No
    parameters.

    Every call goes through the ``"lrn"`` helper, at any size (the JAX
    package sends only tensors below a VMEM cap there); on a CUDA tensor
    the helper does not take (float64) the layer raises, so the built-in
    path runs on the card only with helpers disabled.  The built-in path
    is the reference's formula in x's type, with the kernel's window for
    every n: offsets −⌊n/2⌋ … ⌊n/2⌋, n + 1 channels for an even n (where
    the reference's ``reduce_window`` fails)."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self) -> bool:
        return False

    def param_shapes(self):
        return {}

    def init(self, gen, dtype=torch.float32, device=None):
        return {}

    def apply(self, params, x, *, train=False, rng=None):
        helper = helpers.get_helper("lrn")
        if helper is not None:
            if helper.supports(x):
                return helper.apply(x, self.k, self.n, self.alpha, self.beta)
            if x.device.type != "cpu":
                raise TypeError(
                    f"LocalResponseNormalization: the lrn kernels do not "
                    f"take {x.dtype} {tuple(x.shape)} on {x.device}; use "
                    "helpers.helpers_disabled() (or enable_helpers(False)) "
                    "for the built-in path")
        denom = (self.k + self.alpha * window_sum(x * x, self.n // 2)) \
            ** self.beta
        return x / denom


@register_layer
@dataclasses.dataclass(frozen=True)
class LayerNorm(Layer):
    """Per-example normalization over the trailing feature axis:
    ``gamma * (x - mean) / sqrt(var + eps) + beta`` with the biased
    variance, as the reference."""

    n_in: Optional[int] = None
    eps: float = 1e-5
    activation: str = "identity"

    def setup(self, input_type: InputType) -> "LayerNorm":
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.size)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def param_shapes(self):
        return {"gamma": (self.n_in,), "beta": (self.n_in,)}

    def init(self, gen, dtype=torch.float32, device=None):
        return {"gamma": torch.ones((self.n_in,), dtype=dtype, device=device),
                "beta": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def apply(self, params, x, *, train=False, rng=None):
        y = F.layer_norm(x, (x.shape[-1],), params["gamma"], params["beta"],
                         self.eps)
        return activations.get(self.activation)(y)

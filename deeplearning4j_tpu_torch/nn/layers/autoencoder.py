"""Pretrain layers — counterpart of
``deeplearning4j_tpu/nn/layers/autoencoder.py``: the denoising
AutoEncoder (tied weights, a visible bias ``vb``) and the RBM trained by
contrastive divergence (CD-k, binary or gaussian units).

Both act as an encoder (a dense forward) inside a supervised stack; their
unsupervised objective is ``pretrain_loss(params, x, rng)``, which the
facades' layerwise ``pretrain`` differentiates.  ``rng`` is a key of
``backend/rng.py`` (a generator or a device key): it is split as the
reference splits its JAX key, and the corruption mask, the Gibbs chain's
binary samples and its gaussian noise are counter-based draws from the
children, so a captured pretraining step draws new ones each replay.
JAX's streams cannot be matched: parity with the reference goes through
given chains and moments, not seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.nn import activations, initializers, losses
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.dense import _matmul


class _Pretrainable(Layer):
    """What the two share: ``n_in`` from the input type, a feed-forward
    output, and the parameters ``W`` [n_in, n_out], ``b`` [n_out] (the
    hidden bias) and ``vb`` [n_in] (the visible bias)."""

    def setup(self, input_type: InputType):
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.flat_size())
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,),
                "vb": (self.n_in,)}

    def _weights(self, gen, dtype, device):
        return initializers.init(
            self.weight_init, gen, (self.n_in, self.n_out), dtype, device,
            distribution=initializers.distribution_from_dict(self.dist))


@register_layer
@dataclasses.dataclass(frozen=True)
class AutoEncoder(_Pretrainable):
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    corruption_level: float = 0.3
    loss: str = "mse"   # the reconstruction loss

    def init(self, gen, dtype=torch.float32, device=None):
        return {"W": self._weights(gen, dtype, device),
                "b": torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=device),
                "vb": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def encode(self, params, x):
        return activations.get(self.activation)(
            _matmul(x, params["W"]) + params["b"])

    def decode(self, params, y):
        # tied weights: the decoder is W^T
        return activations.get(self.activation)(
            _matmul(y, params["W"].t()) + params["vb"])

    def apply(self, params, x, *, train=False, rng=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        return self.encode(params, x)

    def pretrain_loss(self, params, x, rng):
        """The reconstruction loss of ``x`` from its corrupted copy (each
        input zeroed with probability ``corruption_level``, the mask drawn
        from the first of ``rng``'s two children)."""
        if self.corruption_level > 0.0:
            k1, _ = rng_mod.split(rng, 2)
            keep = rng_mod.bernoulli(k1, 1.0 - self.corruption_level,
                                     x.shape, x.device)
            x_in = torch.where(keep, x, torch.zeros_like(x))
        else:
            x_in = x
        recon = self.decode(params, self.encode(params, x_in))
        return losses.score(self.loss, x, recon, "identity")


@register_layer
@dataclasses.dataclass(frozen=True)
class RBM(_Pretrainable):
    """Restricted Boltzmann machine trained by CD-k; ``hidden_unit`` and
    ``visible_unit`` are ``"binary"`` or ``"gaussian"``."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    hidden_unit: str = "binary"
    visible_unit: str = "binary"
    k: int = 1                      # Gibbs steps (CD-k)
    activation: str = "sigmoid"

    def init(self, gen, dtype=torch.float32, device=None):
        return {"W": self._weights(gen, dtype, device),
                "b": torch.zeros((self.n_out,), dtype=dtype, device=device),
                "vb": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def apply(self, params, x, *, train=False, rng=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        return self.prop_up(params, x)

    def prop_up(self, params, v):
        pre = _matmul(v, params["W"]) + params["b"]
        return torch.sigmoid(pre) if self.hidden_unit == "binary" else pre

    def prop_down(self, params, h):
        pre = _matmul(h, params["W"].t()) + params["vb"]
        return torch.sigmoid(pre) if self.visible_unit == "binary" else pre

    def _sample(self, key, probs, kind):
        if kind == "binary":
            return rng_mod.bernoulli_probs(key, probs)
        # gaussian units: the mean plus unit noise
        return probs + rng_mod.normal(key, probs.shape, probs.device,
                                      probs.dtype)

    def gibbs_chain(self, params, v0, rng):
        """The CD-k chain's last visible sample ``vk`` from ``v0``
        (``rng`` split into 2k + 1 keys: the first for h0, then two a
        step), outside autograd: the reference stops its gradient."""
        keys = rng_mod.split(rng, 2 * self.k + 1)
        with torch.no_grad():
            hk = self._sample(keys[0], self.prop_up(params, v0),
                              self.hidden_unit)
            vk = v0
            for i in range(self.k):
                vk = self._sample(keys[2 * i + 1], self.prop_down(params, hk),
                                  self.visible_unit)
                hk = self._sample(keys[2 * i + 2], self.prop_up(params, vk),
                                  self.hidden_unit)
        return vk

    def cd_loss(self, params, v0, vk):
        """The CD surrogate over a given chain: the mean of F(v0) - F(vk),
        whose gradient is the CD update <v0 h0> - <vk hk>."""
        return torch.mean(self._free_energy(params, v0)
                          - self._free_energy(params, vk))

    def pretrain_loss(self, params, v0, rng):
        return self.cd_loss(params, v0, self.gibbs_chain(params, v0, rng))

    def _free_energy(self, params, v):
        # F(v) = -v.vb - sum softplus(v W + b), for gaussian visible units
        # too (the reference's form)
        pre = _matmul(v, params["W"]) + params["b"]
        return -_matmul(v, params["vb"]) - F.softplus(pre).sum(-1)

    def reconstruction_error(self, params, v, rng=None):
        recon = self.prop_down(params, self.prop_up(params, v))
        return torch.mean(torch.sum((v - recon) ** 2, dim=-1))

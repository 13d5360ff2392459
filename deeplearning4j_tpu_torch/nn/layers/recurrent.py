"""Recurrent layers — counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``:
``GravesLSTM`` (peepholes), ``LSTM`` (none), ``GravesBidirectionalLSTM``
(the two directions summed) and the ``RnnOutputLayer`` head.

The reference's layout and parameters: sequences are [B, T, F]; ``W``
[n_in, 4H], ``RW`` [H, 4H] and ``b`` [4H] hold the gates in the order
input, forget, cell (g), output, with the forget-gate bias at 1.0; the
peepholes ``pI`` and ``pF`` act on the previous cell state and ``pO`` on
the new one.  As in the reference, the input projection of every
timestep is one [B·T, n_in] @ W, and only ``h @ RW`` and the gates stay
in the time loop (the reference's ``lax.scan``, here a Python loop whose
steps autograd records: on the card the facades capture the whole step
in a CUDA graph, ``models/capture.py``).  A masked step freezes (h, c)
and emits 0.  No Pallas kernel sits on this path in the reference, so
none is ported: the matmuls are ``torch.matmul``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import activations, initializers
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.dense import OutputLayer

_PEEPHOLES = ("pI", "pF", "pO")


def _lstm_shapes(n_in, n_out, peephole, prefix=""):
    shapes = {prefix + "W": (n_in, 4 * n_out),
              prefix + "RW": (n_out, 4 * n_out),
              prefix + "b": (4 * n_out,)}
    if peephole:
        shapes.update({prefix + g: (n_out,) for g in _PEEPHOLES})
    return shapes


def _lstm_init(gen, n_in, n_out, weight_init, dist, peephole, dtype,
               device, prefix=""):
    """The reference's ``_lstm_init``: W with fans (n_in, n_out), RW and
    the peepholes with (n_out, n_out), the forget-gate bias 1.0."""
    d = initializers.distribution_from_dict(dist)

    def draw(shape, fan_in):
        return initializers.init(weight_init, gen, shape, dtype, device,
                                 fan_in=fan_in, fan_out=n_out,
                                 distribution=d)

    b = torch.zeros((4 * n_out,), dtype=dtype)
    b[n_out:2 * n_out] = 1.0
    p = {prefix + "W": draw((n_in, 4 * n_out), n_in),
         prefix + "RW": draw((n_out, 4 * n_out), n_out),
         prefix + "b": b.to(device)}
    if peephole:
        for g in _PEEPHOLES:
            p[prefix + g] = draw((n_out,), n_out)
    return p


def _cell_step(params, act_fn, gate_act, peephole, h_prev, c_prev, xproj_t,
               prefix=""):
    """One cell step from the step's input projection [B, 4H]."""
    z = xproj_t + h_prev @ params[prefix + "RW"]
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    if peephole:
        zi = zi + c_prev * params[prefix + "pI"]
        zf = zf + c_prev * params[prefix + "pF"]
    c = gate_act(zf) * c_prev + gate_act(zi) * act_fn(zg)
    if peephole:
        zo = zo + c * params[prefix + "pO"]
    return gate_act(zo) * act_fn(c), c


def _scan_lstm(params, act_fn, gate_act, peephole, x, mask, reverse=False,
               h0=None, c0=None, prefix=""):
    """[B, T, n_in] -> ([B, T, H], (h_T, c_T)); a masked step (``mask``
    [B, T] <= 0) keeps the state it had and emits 0.  ``reverse`` runs
    from the last timestep to the first (the reference's
    ``lax.scan(reverse=True)``): outputs stay at their timesteps, and
    the carry returned is the one after timestep 0."""
    b, t, _ = x.shape
    hid = params[prefix + "RW"].shape[0]
    xproj = (x.reshape(b * t, -1) @ params[prefix + "W"]
             + params[prefix + "b"]).reshape(b, t, 4 * hid)
    h = torch.zeros((b, hid), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    c = torch.zeros((b, hid), dtype=x.dtype, device=x.device) \
        if c0 is None else c0
    ys = [None] * t
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        hn, cn = _cell_step(params, act_fn, gate_act, peephole, h, c,
                            xproj[:, i], prefix)
        if mask is not None:
            m = mask[:, i, None]
            keep = m > 0
            hn = torch.where(keep, hn, h)
            cn = torch.where(keep, cn, c)
            ys[i] = hn * m
        else:
            ys[i] = hn
        h, c = hn, cn
    return torch.stack(ys, dim=1), (h, c)


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesLSTM(Layer):
    """Graves-style LSTM with peephole connections (reference
    ``GravesLSTM.java:38``)."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    peephole: bool = True
    _TAKES_MASK = True

    def setup(self, input_type: InputType) -> "GravesLSTM":
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.size)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def param_shapes(self):
        return _lstm_shapes(self.n_in, self.n_out, self.peephole)

    def init(self, gen, dtype=torch.float32, device=None):
        return _lstm_init(gen, self.n_in, self.n_out, self.weight_init,
                          self.dist, self.peephole, dtype, device)

    def _acts(self):
        return (activations.get(self.activation),
                activations.get(self.gate_activation))

    def apply(self, params, x, *, train=False, rng=None, mask=None):
        return self.apply_with_carry(params, x, None, train=train, rng=rng,
                                     mask=mask)[0]

    def apply_with_carry(self, params, x, carry, *, train=False, rng=None,
                         mask=None):
        """The sequence forward from ``carry`` ((h, c), or None for
        zeros), returning (y, the final (h, c)): TBPTT's windows and
        streaming inference pass the carry from one call to the next
        (reference ``rnnActivateUsingStoredState``)."""
        x = self.maybe_dropout(x, train=train, rng=rng)
        h0, c0 = carry if carry is not None else (None, None)
        act, gact = self._acts()
        return _scan_lstm(params, act, gact, self.peephole, x, mask,
                          h0=h0, c0=c0)

    def initial_carry(self, batch: int, dtype=torch.float32, device=None):
        """Zero (h, c) [batch, H]: the carry of a sequence's start."""
        return (torch.zeros((batch, self.n_out), dtype=dtype, device=device),
                torch.zeros((batch, self.n_out), dtype=dtype, device=device))

    def step(self, params, carry, x_t):
        """One timestep: x_t [B, n_in] -> (y [B, H], the new carry)."""
        act, gact = self._acts()
        h, c = _cell_step(params, act, gact, self.peephole, carry[0],
                          carry[1], x_t @ params["W"] + params["b"])
        return h, (h, c)


@register_layer
@dataclasses.dataclass(frozen=True)
class LSTM(GravesLSTM):
    """LSTM without peepholes."""

    peephole: bool = False


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesBidirectionalLSTM(Layer):
    """Bidirectional Graves LSTM: a forward (``f_``) and a backward
    (``b_``) LSTM over the sequence, summed (reference
    ``GravesBidirectionalLSTM.java:218``).  It carries no state between
    calls.  As in the reference, the facades hand it no features mask;
    called with one, it freezes each direction's state on masked steps."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    peephole: bool = True

    def setup(self, input_type: InputType) -> "GravesBidirectionalLSTM":
        if self.n_in is None:
            return dataclasses.replace(self, n_in=input_type.size)
        return self

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def param_shapes(self):
        return {**_lstm_shapes(self.n_in, self.n_out, self.peephole, "f_"),
                **_lstm_shapes(self.n_in, self.n_out, self.peephole, "b_")}

    def init(self, gen, dtype=torch.float32, device=None):
        p = _lstm_init(gen, self.n_in, self.n_out, self.weight_init,
                       self.dist, self.peephole, dtype, device, prefix="f_")
        p.update(_lstm_init(gen, self.n_in, self.n_out, self.weight_init,
                            self.dist, self.peephole, dtype, device,
                            prefix="b_"))
        return p

    def apply(self, params, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        act = activations.get(self.activation)
        gact = activations.get(self.gate_activation)
        fwd, _ = _scan_lstm(params, act, gact, self.peephole, x, mask,
                            prefix="f_")
        bwd, _ = _scan_lstm(params, act, gact, self.peephole, x, mask,
                            reverse=True, prefix="b_")
        return fwd + bwd


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(OutputLayer):
    """Per-timestep dense + loss head: [B, T, n_in] -> [B, T, n_out]."""

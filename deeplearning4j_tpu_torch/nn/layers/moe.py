"""Mixture-of-Experts layer — counterpart of
``deeplearning4j_tpu/nn/layers/moe.py``: top-1 ("switch") routing with a
fixed capacity per expert, expert FFNs and a gated combine, plus the
residual path.

The semantics are the reference's: each token goes to its router's
argmax (the first on ties), takes the next slot of that expert's buffer
of ``max(1, int(capacity_factor · T / E))``, and a token past a full
expert keeps only the residual; the expert's output is scaled by the
token's gate.  Two departures keep that function:

- positions are counted in int32.  The reference counts them in the
  tokens' own type (``moe.py:97``), so in bfloat16 past 256 tokens an
  expert (float16: 2048) several tokens round to one slot and the
  dispatch sums them;
- no ``[T, E, C]`` one-hot tensor is built.  Dispatch copies each kept
  token into its slot (``index_copy``) and combine reads it back
  (``index_select``); a slot holds at most one token and a token reads at
  most one slot, so both are exact and deterministic and equal the
  one-hot einsums.  Dropped tokens write into, and read from, one spare
  row past the buffers, which nothing else reads.

The expert FFNs are batched products over ``[E, C, ·]``.

Under a slot master's step the routing counts over the global batch,
every data slot's rows (``backend.slots.gather_rows``), as the
reference's one program does; under the model slots of a
``TensorParallelTrainingMaster`` the experts are sharded, each slot
running its ``E/tp`` experts' FFNs and combining its own tokens, and the
slots' combines are psum'd (``_combine_slots``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend import slots
from deeplearning4j_tpu_torch.nn import activations, initializers
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


class Routing(NamedTuple):
    """A batch's routing: each token's expert, its gate, its position in
    that expert's buffer (int32), whether it fits, and the capacity."""

    expert: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    kept: torch.Tensor
    capacity: int


@register_layer
@dataclasses.dataclass(frozen=True)
class MoELayer(Layer):
    """Switch-routed expert FFN: x -> router -> expert MLP -> combine.

    n_in/n_out: the model width (``residual`` adds the input, so they
    match); hidden: each expert's FFN width (0: 4 · n_in)."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    num_experts: int = 4
    hidden: int = 0
    capacity_factor: float = 1.25
    activation: str = "relu"
    residual: bool = True
    _SLOT_AWARE = True

    def setup(self, input_type: InputType) -> "MoELayer":
        n_in = self.n_in if self.n_in is not None else input_type.flat_size()
        n_out = self.n_out if self.n_out is not None else n_in
        return dataclasses.replace(self, n_in=n_in, n_out=n_out)

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def validate(self) -> None:
        super().validate()
        if self.residual and self.n_in != self.n_out:
            raise ValueError("MoE residual path needs n_in == n_out")

    def _hidden(self) -> int:
        return self.hidden or 4 * self.n_in

    def param_shapes(self):
        E, h = self.num_experts, self._hidden()
        return {"W_router": (self.n_in, E), "W_up": (E, self.n_in, h),
                "b_up": (E, h), "W_down": (E, h, self.n_out),
                "b_down": (E, self.n_out)}

    def init(self, gen, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
        E, h = self.num_experts, self._hidden()
        k1, k2, k3, _ = rng_mod.split(gen, 4)

        def w(k, shape, fan_in, fan_out):
            return initializers.init(self.weight_init, k, shape, dtype,
                                     device, fan_in=fan_in, fan_out=fan_out)

        return {
            "W_router": w(k1, (self.n_in, E), self.n_in, E),
            "W_up": w(k2, (E, self.n_in, h), self.n_in, h),
            "b_up": torch.zeros((E, h), dtype=dtype, device=device),
            "W_down": w(k3, (E, h, self.n_out), h, self.n_out),
            "b_down": torch.zeros((E, self.n_out), dtype=dtype,
                                  device=device),
        }

    def capacity(self, n_tokens: int) -> int:
        return max(1, int(self.capacity_factor * n_tokens
                          / self.num_experts))

    def route(self, params, tokens) -> Routing:
        """The routing of ``tokens`` [T, d] (under a slot master the
        global batch's, ``slots.gather_rows``): the softmax gates'
        argmax, the token's gate, and its position in its expert's
        buffer (the tokens before it that chose the same expert, an exact
        int32 count)."""
        E = self.num_experts
        logits = slots.linear(tokens, params["W_router"], self.n_in, E)
        gates = torch.softmax(slots.gather_act(logits), dim=-1)
        expert = torch.argmax(gates, dim=-1)
        gate = gates.gather(1, expert[:, None])[:, 0]
        # the one-hot as [E, T], so the count runs along the contiguous
        # axis (a scan down the T rows of [T, E] is serial on the card)
        onehot = (expert[None, :] == torch.arange(
            E, device=expert.device)[:, None]).to(torch.int32)
        pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(
            0, expert[None, :])[0] - 1
        cap = self.capacity(int(tokens.shape[0]))
        return Routing(expert, gate, pos, pos < cap, cap)

    def apply(self, params, x, *, train=False, rng=None):
        x = self.maybe_dropout(x, train=train, rng=rng)
        lead = x.shape[:-1]
        # the routing counts over every data slot's tokens; across
        # processes the layer hands back its own rows
        tokens = slots.gather_rows(x.reshape(-1, x.shape[-1]))   # [T, d]
        params = slots.coupled_params(params)
        E = self.num_experts
        r = self.route(params, tokens)
        C = r.capacity
        # each kept token's row of the [E * C] buffers; dropped tokens
        # share the spare row E * C
        slot = torch.where(r.kept, r.expert * C + r.pos,
                           torch.full_like(r.pos, E * C)).to(torch.int64)
        buf = tokens.new_zeros((E * C + 1, tokens.shape[-1]))
        expert_in = buf.index_copy(0, slot, tokens)[:E * C].view(
            E, C, tokens.shape[-1])
        act = activations.get(self.activation)
        if slots.sharded_dim(params["W_up"], (E, self.n_in,
                                              self._hidden())) == 0:
            combined = self._combine_slots(params, expert_in, slot, r, act)
        else:
            hdn = act(torch.baddbmm(params["b_up"][:, None, :], expert_in,
                                    params["W_up"]))
            out = torch.baddbmm(params["b_down"][:, None, :], hdn,
                                params["W_down"])             # [E, C, o]
            flat = torch.cat([out.reshape(E * C, self.n_out),
                              out.new_zeros((1, self.n_out))])
            combined = flat.index_select(0, slot) * r.gate[:, None]
        if self.residual:
            combined = combined + tokens
        return slots.own_rows(combined).reshape(tuple(lead) + (self.n_out,))

    def _combine_slots(self, params, expert_in, slot, r, act):
        """The experts sharded over the model slots: slot k runs experts
        ``[k*E/tp, (k+1)*E/tp)`` on their buffers and reads back the
        tokens routed to them (every other token reads its spare zero
        row); the slots' combines are psum'd.  A token reads one slot's
        expert, so the sum is exact."""
        n = params["W_up"].shape[0]
        E, C = self.num_experts, r.capacity
        el = E // n
        xin = expert_in.reshape(n, el, C, expert_in.shape[-1])
        hdn = act(torch.matmul(xin, params["W_up"])
                  + params["b_up"].reshape(n, el, 1, -1))
        out = (torch.matmul(hdn, params["W_down"])
               + params["b_down"].reshape(n, el, 1, -1))  # [tp, E/tp, C, o]
        per = el * C + 1
        flat = torch.cat([out.reshape(n, el * C, self.n_out),
                          out.new_zeros((n, 1, self.n_out))], dim=1)
        owner = torch.arange(n, device=slot.device)[:, None]
        mine = (slot[None, :] // (el * C) == owner) & r.kept[None, :]
        local = torch.where(mine, slot[None, :] - owner * (el * C),
                            torch.full_like(slot[None, :], el * C))
        got = flat.reshape(n * per, self.n_out).index_select(
            0, (local + owner * per).reshape(-1)).reshape(n, -1, self.n_out)
        return slots.psum(got * r.gate[None, :, None])

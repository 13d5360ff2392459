"""ResidualBlock — counterpart of ``deeplearning4j_tpu/nn/layers/composite.py``.

y = x + f(x), f = the sublayers in order; sublayer ``i``'s params live
under ``sub{i}``.  A pre-norm block (LayerNorm, then a sublayer) opens
with the fused dropout/residual/LayerNorm prologue when the
``"epilogue"`` helper takes the input (``_fused_prologue_helper``), and
``remat=True`` recomputes the block in the backward pass
(``torch.utils.checkpoint`` in place of ``jax.checkpoint``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.backend import rng as rng_mod
from deeplearning4j_tpu_torch.backend import slots
from deeplearning4j_tpu_torch.backend.rng import KeyStream
from deeplearning4j_tpu_torch.helpers import get_helper
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, layer_from_dict, register_layer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import LayerNorm


def _apply_sub(sub, params, h, *, train, rng, mask):
    params, h = slots.layer_in(sub, params, h)
    kw = {"mask": mask} if mask is not None and sub._TAKES_MASK else {}
    return slots.layer_out(sub.apply(params, h, train=train, rng=rng, **kw))


@register_layer
@dataclasses.dataclass(frozen=True)
class ResidualBlock(Layer):
    layers: Tuple[Layer, ...] = ()
    remat: bool = False
    _TAKES_MASK = True
    # its sublayers meet the model slots one by one (``_apply_sub``)
    _SLOT_AWARE = True

    def slot_reads_blocks(self, params) -> bool:
        return True

    def validate(self) -> None:
        for sub in self.layers:
            sub.validate()

    def param_shapes(self):
        return {f"sub{i}": sub.param_shapes()
                for i, sub in enumerate(self.layers) if sub.has_params()}

    def init(self, gen, dtype=torch.float32, device=None):
        keys = KeyStream(int(torch.randint(0, 2 ** 62, (1,), generator=gen)))
        params: Dict[str, Any] = {}
        for i, sub in enumerate(self.layers):
            k = keys.next()
            if sub.has_params():
                params[f"sub{i}"] = sub.init(k, dtype, device)
        return params

    def _fused_prologue_helper(self, x):
        """The ``"epilogue"`` helper when the block opens LayerNorm ->
        sublayer (identity activation) and the helper takes ``x``; else
        None, and the block runs its sublayers one by one.  A CUDA tensor
        that reaches the helper and that its kernel does not take raises
        (the built-in path runs on the card only with helpers disabled)."""
        if len(self.layers) < 2:
            return None
        ln = self.layers[0]
        if not isinstance(ln, LayerNorm) or ln.activation != "identity":
            return None
        helper = get_helper("epilogue")
        if helper is None or helper.supports(x):
            return helper
        if x.device.type != "cpu":
            raise TypeError(
                f"ResidualBlock: the fused prologue kernel does not take "
                f"{x.dtype} {tuple(x.shape)} on {x.device}; use "
                "helpers.helpers_disabled() for the built-in path")
        return None

    def apply(self, params, x, *, train=False, rng=None, mask=None):
        n = len(self.layers)
        rngs = rng_mod.split(rng, n) if rng is not None else [None] * n
        fused = self._fused_prologue_helper(x)

        def body(params, x):
            h = x
            start = 0
            if fused is not None:
                ln, sub1 = self.layers[0], self.layers[1]
                # sub1's INPUT dropout folds into the prologue, drawn from
                # sub1's own key: the same mask the unfused path draws
                rate = (sub1.dropout if train and sub1.dropout > 0.0
                        and not sub1.drop_connect else 0.0)
                h = fused.prologue(slots.gather_act(h),
                                   params["sub0"]["gamma"],
                                   params["sub0"]["beta"], eps=ln.eps,
                                   rate=rate, generator=rngs[1], train=train)
                sub1r = (dataclasses.replace(sub1, dropout=0.0)
                         if rate > 0.0 else sub1)
                h = _apply_sub(sub1r, params.get("sub1", {}), h, train=train,
                               rng=rngs[1], mask=mask)
                start = 2
            for i in range(start, n):
                h = _apply_sub(self.layers[i], params.get(f"sub{i}", {}), h,
                               train=train, rng=rngs[i], mask=mask)
            return x + h

        if self.remat and train:
            # masks come from the keys, never from torch's global RNG, so
            # there is no RNG state to stash (and a CUDA graph capture
            # could not read it)
            return checkpoint(body, params, x, use_reentrant=False,
                              preserve_rng_state=False)
        return body(params, x)

    def reg_score(self, params):
        total = 0.0
        for i, sub in enumerate(self.layers):
            if sub.has_params():
                total = total + sub.reg_score(params[f"sub{i}"])
        return total

    def init_cache(self, batch: int, dtype=torch.float32, device=None):
        """Stream caches of the cache-bearing sublayers (attention), by
        ``sub{i}``: a dict (maybe empty) when any sublayer carries state,
        None when none does."""
        carry = {}
        carryable = False
        for i, sub in enumerate(self.layers):
            if hasattr(sub, "init_cache"):
                carryable = True
                c = sub.init_cache(batch, dtype, device)
                if c is not None:
                    carry[f"sub{i}"] = c
            elif hasattr(sub, "apply_with_carry"):
                carryable = True
        return carry if carryable else None

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype=torch.float32, device=None):
        """Paged pools for the pageable sublayers (attention), or None
        when the block holds none."""
        carry = {}
        for i, sub in enumerate(self.layers):
            if hasattr(sub, "init_paged_cache"):
                carry[f"sub{i}"] = sub.init_paged_cache(num_pages, page_size,
                                                        dtype, device)
        return carry or None

    def apply_with_carry(self, params, x, carry, *, train=False, rng=None,
                         mask=None):
        """carry=None -> ``apply``.  With a carry dict (the serving path):
        thread each sublayer's cache through, with plain LayerNorm, as
        the reference."""
        if carry is None:
            return self.apply(params, x, train=train, rng=rng,
                              mask=mask), None
        n = len(self.layers)
        rngs = rng_mod.split(rng, n) if rng is not None else [None] * n
        h = x
        new_carry = {}
        for i, sub in enumerate(self.layers):
            p = params.get(f"sub{i}", {})
            if hasattr(sub, "apply_with_carry"):
                h, nc = sub.apply_with_carry(p, h, carry.get(f"sub{i}"),
                                             train=train, rng=rngs[i],
                                             mask=mask)
                if nc is not None:
                    new_carry[f"sub{i}"] = nc
            else:
                h = _apply_sub(sub, p, h, train=train, rng=rngs[i],
                               mask=mask)
        return x + h, new_carry

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": "ResidualBlock",
            "name": self.name,
            "remat": self.remat,
            "layers": [sub.to_dict() for sub in self.layers],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ResidualBlock":
        return cls(name=d.get("name"), remat=d.get("remat", False),
                   layers=tuple(layer_from_dict(s) for s in d["layers"]))

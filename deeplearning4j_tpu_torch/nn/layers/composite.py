"""ResidualBlock — counterpart of ``deeplearning4j_tpu/nn/layers/composite.py``.

y = x + f(x), f = the sublayers in order; sublayer ``i``'s params live
under ``sub{i}``.  Inference only so far: ``remat`` is kept for the
config round-trip, and the fused dropout/residual/LayerNorm prologue of
the reference's train path comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from deeplearning4j_tpu_torch.backend.rng import KeyStream
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, layer_from_dict, register_layer,
)


@register_layer
@dataclasses.dataclass(frozen=True)
class ResidualBlock(Layer):
    layers: Tuple[Layer, ...] = ()
    remat: bool = False

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

    def apply(self, params, x):
        h = x
        for i, sub in enumerate(self.layers):
            h = sub.apply(params.get(f"sub{i}", {}), h)
        return x + h

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

    def apply_with_carry(self, params, x, carry):
        """carry=None -> ``apply``.  With a carry dict: thread each
        sublayer's cache through."""
        if carry is None:
            return self.apply(params, x), None
        h = x
        new_carry = {}
        for i, sub in enumerate(self.layers):
            p = params.get(f"sub{i}", {})
            if hasattr(sub, "apply_with_carry"):
                h, nc = sub.apply_with_carry(p, h, carry.get(f"sub{i}"))
                if nc is not None:
                    new_carry[f"sub{i}"] = nc
            else:
                h = sub.apply(p, h)
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

"""Decode seams — the part of ``deeplearning4j_tpu/models/decode.py`` the
generation engine uses.  (The reference's one-program ``lax.scan``
``generate`` has no port yet: the engine is the port's decode path.)"""

from __future__ import annotations


def _last_logits_fwd(net):
    """(params, x, carries) -> (preoutput, new_carries): the one seam the
    decode programs need."""
    def fwd(params, x, carries):
        return net._forward(params, x, carries=carries or None)
    return fwd


def _ids_need_time_axis(net, one_hot: bool) -> bool:
    """True when id inputs need a trailing singleton axis, so that a
    ``collapse_column`` embedding reads [B, T, 1] as T column steps
    instead of collapsing a [B, 1] feed to a rank-2 column."""
    from deeplearning4j_tpu_torch.nn.layers.dense import EmbeddingLayer

    if one_hot:
        return False
    l0 = net.layers[0] if net.layers else None
    return isinstance(l0, EmbeddingLayer) and l0.collapse_column


def _resolve_encoding(net):
    """(one_hot, vocab_size): a network whose first layer is not an
    embedding consumes one-hot vectors as wide as that layer's input."""
    from deeplearning4j_tpu_torch.nn.layers.dense import EmbeddingLayer

    l0 = net.layers[0]
    if isinstance(l0, EmbeddingLayer):
        return False, None
    return True, getattr(l0, "n_in", None) or net.layers[-1].n_out

"""Model zoo — counterpart of ``deeplearning4j_tpu/models/zoo.py``
(``transformer_char_lm`` so far)."""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.backend.device import DeviceLike
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    DenseLayer, EmbeddingLayer, LayerNorm, ResidualBlock, RnnOutputLayer,
    SelfAttentionLayer,
)


def transformer_char_lm(vocab_size: int = 77, d_model: int = 128,
                        n_heads: int = 4, layers: int = 2,
                        ff_mult: int = 4, seed: int = 12345,
                        updater: str = "adam", lr: float = 1e-3,
                        remat: bool = False,
                        compute_dtype: Optional[str] = None,
                        rope: bool = True,
                        n_kv_heads: Optional[int] = None,
                        window: Optional[int] = None,
                        max_cache: int = 1024,
                        device: DeviceLike = None) -> MultiLayerNetwork:
    """Causal transformer char-LM: embedding, ``layers`` pre-norm blocks
    of (LayerNorm -> self-attention) and (LayerNorm -> Dense relu ->
    Dense), final LayerNorm and a per-timestep softmax head — the same
    config (and JSON) the reference builds, with seeded weights on
    ``device``.  ``remat=True`` recomputes each block in the backward
    pass."""
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr).list())
    if compute_dtype:
        b.compute_dtype(compute_dtype)
    # collapse_column off: ids are [B, T] sequences; a length-1 prompt
    # must keep its time axis
    b.layer(EmbeddingLayer(n_in=vocab_size, n_out=d_model,
                           collapse_column=False))
    for _ in range(layers):
        b.layer(ResidualBlock(remat=remat, layers=(
            LayerNorm(n_in=d_model),
            SelfAttentionLayer(n_in=d_model, n_out=d_model, n_heads=n_heads,
                               causal=True, rope=rope, n_kv_heads=n_kv_heads,
                               window=window, max_cache=max_cache),
        )))
        b.layer(ResidualBlock(remat=remat, layers=(
            LayerNorm(n_in=d_model),
            DenseLayer(n_in=d_model, n_out=d_model * ff_mult,
                       activation="relu"),
            DenseLayer(n_in=d_model * ff_mult, n_out=d_model,
                       activation="identity"),
        )))
    b.layer(LayerNorm(n_in=d_model))
    b.layer(RnnOutputLayer(n_in=d_model, n_out=vocab_size, loss="mcxent",
                           activation="softmax"))
    return MultiLayerNetwork(b.build()).init(device)

"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

The JAX package stays the reference; this package mirrors its module
layout and names so that every module here has a counterpart at the
same relative path there.  It imports ``torch`` and numpy only — never
``jax`` and nothing of ``deeplearning4j_tpu`` — so it runs on a machine
that has no JAX at all.

Entry points (``MultiLayerNetwork.init``, ``models.zoo``,
``models.serialization``, ``models.interop``) place tensors on ``cuda``
unless the caller passes ``device="cpu"``; with no GPU and no explicit
CPU request they raise instead of quietly running on the host.

Ported so far (slice 1, serving): the transformer char-LM's inference
path and the continuous-batching ``generation.GenerationEngine``, whose
paged decode attention is a hand-written CUDA kernel
(``helpers/csrc/paged_attention.cu``).
"""

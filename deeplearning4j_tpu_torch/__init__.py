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

Every module of the JAX package is ported, ``provision/`` (the GPU
hosts' command lines and ``bootstrap_distributed``) included.  Training
runs across processes, one a card, joined by
``parallel.initialize_distributed`` over ``torch.distributed`` (NCCL
between cards, gloo on the CPU): the sync master (replicated and ZeRO),
``ParallelWrapper`` and parameter averaging, the elastic masters, the
introspection policy and the numerics ledger, resilient fits (a commit
is every process's shards staged, a barrier, process 0's rename, a
barrier), ``DistributedNetwork``, the sharded checkpoint and the
distributed NLP fits; only the model and seq axes raise there, naming
ROADMAP A14b.
The serving stack (the char-LM's
inference path, ``generation`` and ``serving`` engines, HTTP, the fleet),
the facades' training, the layer zoo, the data path and the dashboard,
online learning, slot-mesh data, sequence, tensor, expert and pipeline
parallelism, the NLP embedding stack, ``graphs`` (DeepWalk over the NLP engine), ``clustering`` (k-means and
exact t-SNE on the device, the trees and Barnes-Hut t-SNE on the host),
``utils.viterbi`` and ``utils.interop``.  Every Pallas kernel of the
reference has a hand-written CUDA counterpart in ``helpers/csrc/``.
"""

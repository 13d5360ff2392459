"""Model zoo — counterpart of ``deeplearning4j_tpu/models/zoo.py``
(``lenet``, ``resnet50``, ``alexnet``, ``graves_lstm_char_lm`` and
``transformer_char_lm`` so far).  Each builds the reference's config (and JSON) and seeded weights
on ``device``: ``cuda`` unless the caller passes ``device="cpu"``."""

from __future__ import annotations

from typing import Optional, Sequence

from deeplearning4j_tpu_torch.backend.device import DeviceLike
from deeplearning4j_tpu_torch.models.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    EmbeddingLayer, GlobalPoolingLayer, GravesLSTM, LayerNorm,
    LocalResponseNormalization, OutputLayer, ResidualBlock, RnnOutputLayer,
    SelfAttentionLayer, SubsamplingLayer,
)


def lenet(seed: int = 12345, updater: str = "nesterovs", lr: float = 0.01,
          n_classes: int = 10, device: DeviceLike = None
          ) -> MultiLayerNetwork:
    """LeNet-5 on flattened 28x28x1 images (the classic DL4J MNIST
    config); the builder inserts ``FeedForwardToCnn`` before the first
    convolution and ``CnnToFeedForward`` before the dense layer."""
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(updater, learning_rate=lr)
            .regularization(True).l2(5e-4).list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity",
                                    weight_init="xavier"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=n_classes, loss="mcxent",
                               activation="softmax"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())
    return MultiLayerNetwork(conf).init(device)


def _bottleneck(g, name: str, in_name: str, channels: int, stride: int,
                project: bool) -> str:
    """ResNet-v1 bottleneck: 1x1 -> 3x3 -> 1x1 (4c) + shortcut, relu after
    the add."""
    mid, out_ch = channels, channels * 4
    g.add_layer(f"{name}_c1", ConvolutionLayer(
        n_out=mid, kernel_size=(1, 1), stride=(stride, stride),
        activation="identity", weight_init="relu"), in_name)
    g.add_layer(f"{name}_bn1", BatchNormalization(activation="relu"),
                f"{name}_c1")
    g.add_layer(f"{name}_c2", ConvolutionLayer(
        n_out=mid, kernel_size=(3, 3), stride=(1, 1), padding=(1, 1),
        activation="identity", weight_init="relu"), f"{name}_bn1")
    g.add_layer(f"{name}_bn2", BatchNormalization(activation="relu"),
                f"{name}_c2")
    g.add_layer(f"{name}_c3", ConvolutionLayer(
        n_out=out_ch, kernel_size=(1, 1), stride=(1, 1),
        activation="identity", weight_init="relu"), f"{name}_bn2")
    g.add_layer(f"{name}_bn3", BatchNormalization(activation="identity"),
                f"{name}_c3")
    shortcut = in_name
    if project:
        g.add_layer(f"{name}_proj", ConvolutionLayer(
            n_out=out_ch, kernel_size=(1, 1), stride=(stride, stride),
            activation="identity", weight_init="relu"), in_name)
        g.add_layer(f"{name}_projbn", BatchNormalization(
            activation="identity"), f"{name}_proj")
        shortcut = f"{name}_projbn"
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), f"{name}_bn3",
                 shortcut)
    g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_relu"


def resnet50(height: int = 224, width: int = 224, channels: int = 3,
             n_classes: int = 1000, seed: int = 12345,
             updater: str = "nesterovs", lr: float = 0.1,
             blocks: Sequence[int] = (3, 4, 6, 3),
             stem_stride: int = 2, init_channels: int = 64,
             compute_dtype: Optional[str] = None,
             device: DeviceLike = None) -> ComputationGraph:
    """ResNet-50 as a ComputationGraph (residual adds are
    ElementWiseVertex), the same config (and JSON) the reference builds,
    with seeded weights on ``device``.  For CIFAR-scale inputs pass
    height=width=32, stem_stride=1."""
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr).graph()
         .add_inputs("input")
         .set_input_types(input=InputType.convolutional(height, width,
                                                        channels)))
    if compute_dtype:
        b.compute_dtype(compute_dtype)
    stem_kernel = (7, 7) if stem_stride == 2 else (3, 3)
    stem_pad = (3, 3) if stem_stride == 2 else (1, 1)
    b.add_layer("stem", ConvolutionLayer(
        n_out=init_channels, kernel_size=stem_kernel,
        stride=(stem_stride, stem_stride), padding=stem_pad,
        activation="identity", weight_init="relu"), "input")
    b.add_layer("stem_bn", BatchNormalization(activation="relu"), "stem")
    prev = "stem_bn"
    if stem_stride == 2:
        b.add_layer("stem_pool", SubsamplingLayer(
            pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
            padding=(1, 1)), "stem_bn")
        prev = "stem_pool"
    ch = init_channels
    for stage, n_blocks in enumerate(blocks):
        for i in range(n_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            prev = _bottleneck(b, f"s{stage}b{i}", prev, ch, stride,
                               project=i == 0)
        ch *= 2
    b.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), prev)
    b.add_layer("fc", OutputLayer(n_out=n_classes, loss="mcxent",
                                  activation="softmax",
                                  weight_init="xavier"), "gap")
    return ComputationGraph(b.set_outputs("fc").build()).init(device)


def alexnet(height: int = 224, width: int = 224, channels: int = 3,
            n_classes: int = 1000, seed: int = 12345,
            updater: str = "nesterovs", lr: float = 0.01,
            compute_dtype: Optional[str] = None,
            device: DeviceLike = None) -> MultiLayerNetwork:
    """AlexNet (the DL4J model-zoo config): five convolutions, LRN after
    the first two, three max pools, two dense layers of 4096 with input
    dropout 0.5, and the softmax head; l2 5e-4 under Nesterov.  Both LRN
    layers run on the ``"lrn"`` helper."""
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr)
         .regularization(True).l2(5e-4).list())
    if compute_dtype:
        b.compute_dtype(compute_dtype)
    pool = dict(pooling_type="max", kernel_size=(3, 3), stride=(2, 2))
    (b.layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11), stride=(4, 4),
                              activation="relu", weight_init="relu"))
      .layer(LocalResponseNormalization())
      .layer(SubsamplingLayer(**pool))
      .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5), stride=(1, 1),
                              padding=(2, 2), activation="relu"))
      .layer(LocalResponseNormalization())
      .layer(SubsamplingLayer(**pool))
      .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3), stride=(1, 1),
                              padding=(1, 1), activation="relu"))
      .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3), stride=(1, 1),
                              padding=(1, 1), activation="relu"))
      .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3), stride=(1, 1),
                              padding=(1, 1), activation="relu"))
      .layer(SubsamplingLayer(**pool))
      .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
      .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
      .layer(OutputLayer(n_out=n_classes, loss="mcxent",
                         activation="softmax"))
      .set_input_type(InputType.convolutional(height, width, channels)))
    return MultiLayerNetwork(b.build()).init(device)


def graves_lstm_char_lm(vocab_size: int = 77, hidden: int = 200,
                        seq_len: int = 64, layers: int = 2,
                        seed: int = 12345, updater: str = "rmsprop",
                        lr: float = 0.1, tbptt: int = 50,
                        device: DeviceLike = None) -> MultiLayerNetwork:
    """GravesLSTM character language model (the classic DL4J char-RNN
    example; ``BASELINE.md:31``): ``layers`` GravesLSTMs of ``hidden``
    over one-hot characters, a softmax head, truncated BPTT in windows of
    ``tbptt``.  ``seq_len`` is the reference's argument, which it does
    not read either."""
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr).list())
    n_in = vocab_size
    for _ in range(layers):
        b.layer(GravesLSTM(n_in=n_in, n_out=hidden, activation="tanh"))
        n_in = hidden
    b.layer(RnnOutputLayer(n_in=hidden, n_out=vocab_size, loss="mcxent",
                           activation="softmax"))
    conf = b.backprop_type("truncated_bptt", fwd_length=tbptt,
                           back_length=tbptt).build()
    return MultiLayerNetwork(conf).init(device)


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
                        stability=None, introspection=None, numerics=None,
                        device: DeviceLike = None) -> MultiLayerNetwork:
    """Causal transformer char-LM: embedding, ``layers`` pre-norm blocks
    of (LayerNorm -> self-attention) and (LayerNorm -> Dense relu ->
    Dense), final LayerNorm and a per-timestep softmax head — the same
    config (and JSON) the reference builds, with seeded weights on
    ``device``.  ``remat=True`` recomputes each block in the backward
    pass.  ``stability``, ``introspection`` and ``numerics`` set the
    training policies (``True``, a policy or its keyword dict), as the
    reference's arguments do (``zoo.py:345-382``)."""
    nb = (NeuralNetConfiguration.builder().seed(seed)
          .updater(updater, learning_rate=lr))
    for set_policy, policy in ((nb.training_stability, stability),
                               (nb.training_introspection, introspection),
                               (nb.training_numerics, numerics)):
        if isinstance(policy, dict):
            set_policy(**policy)
        elif policy is not None:
            set_policy(policy)
    b = nb.list()
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

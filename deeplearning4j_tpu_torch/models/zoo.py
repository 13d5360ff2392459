"""Model zoo — counterpart of ``deeplearning4j_tpu/models/zoo.py``
(``lenet``, ``resnet50``, ``alexnet``, ``vgg16``, ``googlenet``,
``dbn``, ``graves_lstm_char_lm`` and ``transformer_char_lm``).  Each builds the reference's config (and JSON) and seeded weights
on ``device``: ``cuda`` unless the caller passes ``device="cpu"``."""

from __future__ import annotations

from typing import Optional, Sequence

from deeplearning4j_tpu_torch.backend.device import DeviceLike
from deeplearning4j_tpu_torch.models.graph import ComputationGraph
from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.vertices import (
    ElementWiseVertex, MergeVertex,
)
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    RBM, ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
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


def vgg16(height: int = 224, width: int = 224, channels: int = 3,
          n_classes: int = 1000, seed: int = 12345,
          updater: str = "nesterovs", lr: float = 0.01,
          compute_dtype: Optional[str] = None,
          device: DeviceLike = None) -> MultiLayerNetwork:
    """VGG-16 (13 conv 3x3 + 3 fc; the DL4J model-zoo config): five
    blocks of 3x3 convolutions, each closed by a 2x2 max pool, two dense
    layers of 4096 with input dropout 0.5 and the softmax head; l2 5e-4
    under Nesterov."""
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr)
         .regularization(True).l2(5e-4).list())
    if compute_dtype:
        b.compute_dtype(compute_dtype)
    for n_convs, ch in [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]:
        for _ in range(n_convs):
            b.layer(ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                     stride=(1, 1), padding=(1, 1),
                                     activation="relu"))
        b.layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                 stride=(2, 2)))
    (b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
      .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
      .layer(OutputLayer(n_out=n_classes, loss="mcxent",
                         activation="softmax"))
      .set_input_type(InputType.convolutional(height, width, channels)))
    return MultiLayerNetwork(b.build()).init(device)


def _inception(g, name: str, in_name: str, c1: int, c3r: int, c3: int,
               c5r: int, c5: int, cp: int) -> str:
    """GoogLeNet's inception module: four parallel branches (1x1 |
    1x1->3x3 | 1x1->5x5 | maxpool->1x1) concatenated on channels by a
    ``MergeVertex``."""
    def conv(n, k, pad=(0, 0)):
        return ConvolutionLayer(n_out=n, kernel_size=(k, k), padding=pad,
                                activation="relu", weight_init="relu")

    g.add_layer(f"{name}_b1", conv(c1, 1), in_name)
    g.add_layer(f"{name}_b2r", conv(c3r, 1), in_name)
    g.add_layer(f"{name}_b2", conv(c3, 3, (1, 1)), f"{name}_b2r")
    g.add_layer(f"{name}_b3r", conv(c5r, 1), in_name)
    g.add_layer(f"{name}_b3", conv(c5, 5, (2, 2)), f"{name}_b3r")
    g.add_layer(f"{name}_b4p", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(1, 1),
        padding=(1, 1)), in_name)
    g.add_layer(f"{name}_b4", conv(cp, 1), f"{name}_b4p")
    g.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_b1", f"{name}_b2",
                 f"{name}_b3", f"{name}_b4")
    return f"{name}_cat"


def googlenet(height: int = 224, width: int = 224, channels: int = 3,
              n_classes: int = 1000, seed: int = 12345,
              updater: str = "nesterovs", lr: float = 0.01,
              compute_dtype: Optional[str] = None,
              device: DeviceLike = None) -> ComputationGraph:
    """GoogLeNet (Inception-v1) as a ComputationGraph: the stem, nine
    inception modules joined by ``MergeVertex``, 3x3 max pools with
    padding 1, global average pooling and a softmax head with input
    dropout 0.4; l2 2e-4 under Nesterov."""
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr)
         .regularization(True).l2(2e-4).graph()
         .add_inputs("input")
         .set_input_types(input=InputType.convolutional(height, width,
                                                        channels)))
    if compute_dtype:
        b.compute_dtype(compute_dtype)
    pool = dict(pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
                padding=(1, 1))
    b.add_layer("stem1", ConvolutionLayer(
        n_out=64, kernel_size=(7, 7), stride=(2, 2), padding=(3, 3),
        activation="relu", weight_init="relu"), "input")
    b.add_layer("pool1", SubsamplingLayer(**pool), "stem1")
    b.add_layer("stem2r", ConvolutionLayer(
        n_out=64, kernel_size=(1, 1), activation="relu", weight_init="relu"),
        "pool1")
    b.add_layer("stem2", ConvolutionLayer(
        n_out=192, kernel_size=(3, 3), padding=(1, 1), activation="relu",
        weight_init="relu"), "stem2r")
    b.add_layer("pool2", SubsamplingLayer(**pool), "stem2")
    # (c1, c3r, c3, c5r, c5, cp) a module: the published v1 table
    prev = _inception(b, "i3a", "pool2", 64, 96, 128, 16, 32, 32)
    prev = _inception(b, "i3b", prev, 128, 128, 192, 32, 96, 64)
    b.add_layer("pool3", SubsamplingLayer(**pool), prev)
    prev = _inception(b, "i4a", "pool3", 192, 96, 208, 16, 48, 64)
    prev = _inception(b, "i4b", prev, 160, 112, 224, 24, 64, 64)
    prev = _inception(b, "i4c", prev, 128, 128, 256, 24, 64, 64)
    prev = _inception(b, "i4d", prev, 112, 144, 288, 32, 64, 64)
    prev = _inception(b, "i4e", prev, 256, 160, 320, 32, 128, 128)
    b.add_layer("pool4", SubsamplingLayer(**pool), prev)
    prev = _inception(b, "i5a", "pool4", 256, 160, 320, 32, 128, 128)
    prev = _inception(b, "i5b", prev, 384, 192, 384, 48, 128, 128)
    b.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), prev)
    b.add_layer("fc", OutputLayer(n_out=n_classes, loss="mcxent",
                                  activation="softmax", weight_init="xavier",
                                  dropout=0.4), "gap")
    return ComputationGraph(b.set_outputs("fc").build()).init(device)


def dbn(n_in: int = 784, hidden: Sequence[int] = (500, 250, 100),
        n_classes: int = 10, seed: int = 12345, updater: str = "nesterovs",
        lr: float = 0.1, k: int = 1,
        device: DeviceLike = None) -> MultiLayerNetwork:
    """Deep Belief Network: stacked RBMs (CD-``k``) and a softmax head,
    trained by layerwise ``pretrain`` then supervised ``fit``.  The
    first RBM sees real-valued inputs (gaussian visible units), the
    deeper ones sigmoid activations in [0, 1] (binary)."""
    b = (NeuralNetConfiguration.builder().seed(seed)
         .updater(updater, learning_rate=lr).list())
    prev = n_in
    for li, h in enumerate(hidden):
        b.layer(RBM(n_in=prev, n_out=h, hidden_unit="binary",
                    visible_unit="gaussian" if li == 0 else "binary", k=k))
        prev = h
    b.layer(OutputLayer(n_in=prev, n_out=n_classes, loss="mcxent",
                        activation="softmax"))
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
                        seq_axis: Optional[str] = None,
                        device: DeviceLike = None) -> MultiLayerNetwork:
    """Causal transformer char-LM: embedding, ``layers`` pre-norm blocks
    of (LayerNorm -> self-attention) and (LayerNorm -> Dense relu ->
    Dense), final LayerNorm and a per-timestep softmax head — the same
    config (and JSON) the reference builds, with seeded weights on
    ``device``.  ``remat=True`` recomputes each block in the backward
    pass.  ``stability``, ``introspection`` and ``numerics`` set the
    training policies (``True``, a policy or its keyword dict), as the
    reference's arguments do (``zoo.py:345-382``).  With
    ``seq_axis='seq'`` every attention layer runs ring attention over
    that axis's slots (``SequenceParallelTrainingMaster``)."""
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
                               window=window, max_cache=max_cache,
                               seq_axis=seq_axis),
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

"""Layer classes (importing this module registers every ported layer type)."""

from deeplearning4j_tpu_torch.nn.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.layers.autoencoder import RBM, AutoEncoder
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer, layer_from_dict, register_layer,
)
from deeplearning4j_tpu_torch.nn.layers.composite import ResidualBlock
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionLayer, GlobalPoolingLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.dense import (
    ActivationLayer, DenseLayer, DropoutLayer, EmbeddingLayer, OutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.moe import MoELayer
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization, LayerNorm, LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    LSTM, GravesBidirectionalLSTM, GravesLSTM, RnnOutputLayer,
)

__all__ = [
    "RBM", "ActivationLayer", "AutoEncoder", "BatchNormalization", "ConvolutionLayer",
    "DenseLayer", "DropoutLayer", "EmbeddingLayer", "GlobalPoolingLayer",
    "GravesBidirectionalLSTM", "GravesLSTM", "LSTM", "Layer", "LayerNorm",
    "LocalResponseNormalization", "MoELayer", "OutputLayer",
    "ResidualBlock", "RnnOutputLayer", "SelfAttentionLayer",
    "SubsamplingLayer", "layer_from_dict", "register_layer",
]

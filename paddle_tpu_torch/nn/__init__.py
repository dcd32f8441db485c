from . import clip, functional, layer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue)
from .layer import (  # noqa: F401
    GELU, AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout, Embedding,
    LayerNorm, Linear, MaxPool2D, MultiHeadAttention, ReLU, Tanh,
    Transformer, TransformerDecoder, TransformerDecoderLayer,
    TransformerEncoder, TransformerEncoderLayer)

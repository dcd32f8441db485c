from .activation import GELU, ReLU, Tanh  # noqa: F401
from .common import (  # noqa: F401
    Constant, Dropout, Embedding, KaimingNormal, Linear, Normal,
    XavierNormal)
from .conv import Conv2D  # noqa: F401
from .norm import BatchNorm2D, LayerNorm  # noqa: F401
from .pooling import AdaptiveAvgPool2D, MaxPool2D  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)


def __getattr__(name):
    # the parallel layers (distributed/meta_parallel.py) import this
    # package, so they are re-exported on first use
    from . import common
    return getattr(common, name)

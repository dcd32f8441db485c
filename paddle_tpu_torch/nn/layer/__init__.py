from .activation import ReLU  # noqa: F401
from .common import (  # noqa: F401
    ColumnParallelLinear, Constant, KaimingNormal, Linear, Normal,
    RowParallelLinear, VocabParallelEmbedding, XavierNormal)
from .conv import Conv2D  # noqa: F401
from .norm import BatchNorm2D  # noqa: F401
from .pooling import AdaptiveAvgPool2D, MaxPool2D  # noqa: F401

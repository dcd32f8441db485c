from . import functional, layer  # noqa: F401
from .layer import (  # noqa: F401
    AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D, ReLU)

from . import activation, conv, loss, pooling  # noqa: F401
from .activation import gelu, tanh  # noqa: F401
from .attention import _sdpa_ref, scaled_dot_product_attention  # noqa: F401
from .common import (  # noqa: F401
    batch_norm, dropout, embedding, flatten, layer_norm, linear, relu, silu)
from .conv import conv2d  # noqa: F401
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .pooling import adaptive_avg_pool2d, max_pool2d  # noqa: F401

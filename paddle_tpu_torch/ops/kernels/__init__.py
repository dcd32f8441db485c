"""The port's hand-written CUDA kernels (counterpart of ``ops/pallas``).

Importing a kernel module registers it; nothing is compiled until a CUDA
tensor first needs the kernel.
"""
from . import (conv_bn_stats, flash_attention, int8_matmul,  # noqa: F401
               kv_attention, opt_apply, pull_dequant, registry, segment_sum)

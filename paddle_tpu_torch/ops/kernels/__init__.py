"""The port's hand-written CUDA kernels (counterpart of ``ops/pallas``).

Importing a kernel module registers it; nothing is compiled until a CUDA
tensor first needs the kernel.
"""
from . import (flash_attention, int8_matmul, kv_attention,  # noqa: F401
               opt_apply, pull_dequant, registry, segment_sum)

// An empty kernel, with a plain C interface: it replaces no TPU kernel
// and no path runs it.  chip_smoke.py's phase 3 queues it behind a
// spinning kernel, as it queues the port's kernels, to measure the fixed
// device cost of one launch: the least time any kernel takes there.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Launch `grid` blocks of `threads` threads of the empty kernel on
// `stream`; returns the CUDA error of the launch (0 on success).
int empty_launch(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

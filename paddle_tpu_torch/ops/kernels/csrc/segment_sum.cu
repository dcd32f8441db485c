// Ordered segment sum of embedding-gradient rows for Hopper (sm_90a), with
// a plain C interface.
//
// Replaces: paddle_tpu/ops/pallas/segment_sum.py:58
// `_segment_sum_kernel` (launched by `segment_sum_pallas`): out[inv[i]] +=
// g[i] for i = 0..n-1 in row order, out [nseg, dim] f32 starting at zero.
// The device cache's push merges the gradients of a batch's duplicate ids
// with it before the optimizer apply (paddle_tpu/distributed/fleet/
// heter.py:551).
//
// What bounds it on this card: bytes.  Each gradient row is read once and
// each output row written once, with one add per gradient element: at the
// wide&deep push (n = 26,624 rows of dim 16, 8,192 segments) that is 1.70
// MB of gradients, 0.14 MB of row order and offsets and 0.52 MB of output,
// under a microsecond at 3.35 TB/s, far from any arithmetic limit.  In
// practice the launch and the longest segment's serial loop set the time.
//
// What the design does about it: the TPU kernel walks the rows in order,
// adding each into a VMEM-resident output; blocks here run in parallel and
// in no order, so the wrapper hands the kernel a stable order of the rows
// by segment (`order`, [n]) and each segment's range in it (`offsets`,
// [nseg + 1]).  One thread owns one (segment, column) and adds that
// segment's rows in ascending row order, from 0.0, with __fadd_rn: the
// same additions in the same order as the reference and as the plain
// version, so the result is bitwise theirs, and a rerun is bitwise equal.
// No atomics (they would add in an order that changes from run to run).
// Neighbouring threads take neighbouring columns of one row, so a warp's
// loads of a gradient row are coalesced, and the order entry is one
// broadcast load.  An empty segment (a bucket's padding) writes 0.  Any
// dim (16, 13, 5, ...): no vector width is assumed.  What this simple form
// does not do: split a hot segment (Zipf ids put up to ~300 rows on one
// segment, whose thread's loop is the kernel's tail).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segment_sum_kernel(const float* __restrict__ g,
                                   const int* __restrict__ order,
                                   const int* __restrict__ offsets,
                                   float* __restrict__ out, int nseg,
                                   int dim) {
  const long long total = (long long)nseg * dim;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int seg = (int)(t / dim);
    const int col = (int)(t - (long long)seg * dim);
    const int end = offsets[seg + 1];
    float acc = 0.0f;
    for (int r = offsets[seg]; r < end; ++r)
      acc = __fadd_rn(acc, g[(long long)order[r] * dim + col]);
    out[t] = acc;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// g: [n, dim] f32 contiguous; order: [n] int32, the rows stably sorted by
// segment; offsets: [nseg + 1] int32, segment s owns order[offsets[s] ..
// offsets[s + 1]); out: [nseg, dim] f32 contiguous, every element written.
// Returns the CUDA error of the launch (0 on success).
int segment_sum_f32(const void* g, const void* order, const void* offsets,
                    void* out, int nseg, int dim, void* stream) {
  if (nseg <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nseg * dim;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  segment_sum_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(order),
      static_cast<const int*>(offsets), static_cast<float*>(out), nseg, dim);
  return (int)cudaGetLastError();
}

}  // extern "C"

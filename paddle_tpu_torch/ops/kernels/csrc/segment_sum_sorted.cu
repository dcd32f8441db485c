// Sorted segment sum of embedding-gradient rows for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces: paddle_tpu/ops/pallas/segment_sum.py:126
// `_segment_sum_sorted_kernel` (launched by `segment_sum_sorted_pallas`):
// out[s] = sum of the rows r with seg[r] == s, for segment ids that arrive
// sorted ascending, added in row order from 0.0; out [nseg, dim] f32, rows
// of no gradient are 0.  The streaming trainer's pre-merge takes it through
// `merge_segments` once a batch has 4,096 unique ids or more
// (paddle_tpu/online/streaming.py:225-241).
//
// What bounds it on this card: bytes.  Each gradient row is read once, each
// id once and each output row written once, one add per gradient element:
// at the wide&deep stream's merge (26,624 rows of dim 16 into ~6,250
// segments) that is 1.70 MB of rows, 0.11 MB of ids and 0.40 MB of output,
// under a microsecond at 3.35 TB/s.  The launch and the hottest segment's
// serial loop (~300 rows) set the time in practice.
//
// What the design does about it: the TPU kernel streams 512-row output
// blocks through VMEM and, for each, walks its row range [bounds[i],
// bounds[i+1]) from a host searchsorted, in row order.  Blocks here run in
// parallel and in no order, so nothing is carried between them: one thread
// owns one (segment, column), finds its segment's rows [lo, hi) in the
// sorted ids by two binary searches on the card (no host bounds), and adds
// them in ascending row order from 0.0 with __fadd_rn, the same additions
// in the same order as the reference, the plain version and kernel 7
// (segment_sum.cu) on the same merge, so the result is bitwise theirs and
// a rerun is bitwise equal.  No atomics (they would add in an order that
// changes from run to run), and a hot segment is not split for the same
// reason.  Neighbouring threads take neighbouring columns of one row, so a
// warp's loads of a gradient row coalesce and its id loads broadcast.  Any
// dim; segments far outnumbering rows (200,000 into 256) cost one short
// search per thread and a zero store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// first index in seg[0, n) whose id is >= key (seg ascending)
__device__ __forceinline__ int lower_bound(const int* __restrict__ seg, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (seg[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void segment_sum_sorted_kernel(const float* __restrict__ g,
                                          const int* __restrict__ seg,
                                          float* __restrict__ out, int n,
                                          int nseg, int dim) {
  const long long total = (long long)nseg * dim;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int s = (int)(t / dim);
    const int col = (int)(t - (long long)s * dim);
    const int lo = lower_bound(seg, n, s);
    // s + 1 <= nseg < 2^31: no overflow
    const int hi = lo + lower_bound(seg + lo, n - lo, s + 1);
    float acc = 0.0f;
    for (int r = lo; r < hi; ++r)
      acc = __fadd_rn(acc, g[(long long)r * dim + col]);
    out[t] = acc;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// g: [n, dim] f32 contiguous, the rows in segment order; seg: [n] int32
// ascending, each in [0, nseg); out: [nseg, dim] f32 contiguous, every
// element written.  Returns the CUDA error of the launch (0 on success).
int segment_sum_sorted_f32(const void* g, const void* seg, void* out, int n,
                           int nseg, int dim, void* stream) {
  if (n < 0 || nseg <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)nseg * dim;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  segment_sum_sorted_kernel<<<(unsigned)blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(seg),
      static_cast<float*>(out), n, nseg, dim);
  return (int)cudaGetLastError();
}

}  // extern "C"

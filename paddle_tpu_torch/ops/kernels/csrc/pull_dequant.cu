// Dequantisation of int8 parameter-server rows for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces: paddle_tpu/ops/pallas/pull_dequant.py:44
// `_pull_dequant_kernel` (launched by `pull_dequant_pallas`): out[i, j] =
// f32(codes[i, j]) * scales[i].  A device cache on the q8 wire fills its
// misses through it (paddle_tpu/distributed/fleet/heter.py:319).
//
// What bounds it on this card: bytes.  One byte of code and a quarter of a
// scale are read and four bytes written per element, against one multiply:
// at a miss fill of 6,242 rows of dim 16 that is 0.54 MB, well under a
// microsecond at 3.35 TB/s; such small fills are bound by the launch.
//
// What the design does about it: one thread converts one code, and
// neighbouring threads take neighbouring elements, so loads and stores are
// coalesced; a grid-stride loop covers any m and dim.  No vector loads: at
// the path's fills the launch, not the bytes, sets the time.  The
// conversion is exact (__int2float_rn of an int8) and each element is one
// f32 multiply (__fmul_rn, so no FMA can arise), as the reference and the
// plain version compute it: the result is bitwise theirs and bitwise the
// host's numpy dequant.  An all-zero row ships
// scale 0 and comes back as zeros (0 * 0), not NaN.  The reference's lane
// padding and _MAX_DIM were VMEM tiling artefacts and are not needed here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pull_dequant_kernel(const int8_t* __restrict__ codes,
                                    const float* __restrict__ scales,
                                    float* __restrict__ out, long long total,
                                    int dim) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x)
    out[i] = __fmul_rn(__int2float_rn(codes[i]), scales[i / dim]);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// codes: [m, dim] int8 contiguous; scales: [m] f32; out: [m, dim] f32
// contiguous.  Returns the CUDA error of the launch (0 on success).
int pull_dequant_f32(const void* codes, const void* scales, void* out,
                     long long m, int dim, void* stream) {
  if (m <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long total = m * dim;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  pull_dequant_kernel<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<float*>(out), total, dim);
  return (int)cudaGetLastError();
}

}  // extern "C"

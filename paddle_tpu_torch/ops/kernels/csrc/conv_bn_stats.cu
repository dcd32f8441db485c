// A 1x1 convolution as a matrix product with the batch-norm statistics of
// its output taken in the epilogue, for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces: tools/exp_conv_bn_kernel.py:30 `_kernel` (launched by
// `fused_matmul_bn_stats`, :45): y = x @ w with an f32 accumulator stored
// in x's dtype, and per output channel the sum and the sum of squares of
// the f32 accumulator, as one partial per row block that is summed
// afterwards.
//
// What bounds it on this card: bytes at six of the eight ResNet-50
// batch-256 bottleneck shapes (K or N of 64 to 256 against M of 50,176 to
// 802,816: at most ~200 operations per byte, below the ~295 the bf16 tensor
// cores need), operations at the two with K or N of 2,048 (M 12,544).  The
// least time is the larger of 2MKN / 989 TFLOP/s and (MK + KN + MN) * 2
// bytes / 3.35 TB/s.
//
// What the design does about it: the activation y is written once and
// never read back for the statistics, which is the point of the fusion;
// the sums come from the f32 accumulator while it is in registers.  A
// block of 256 threads (8 warps, 4 along M by 2 along N) computes a
// 128 x BN output tile (BN 128, or 64 where N <= 64) over K in steps of
// 32 with mma.sync m16n8k16 bf16 -> f32.  x rows go to shared memory as
// they are (row pitch 80 bytes, so a warp's 32-bit fragment loads hit 32
// banks); w [K, N] stays row-major in shared memory and ldmatrix.trans
// builds the column-major B fragments from it.  The next K tile is loaded
// into registers while the current one is multiplied.  Rows past M and K
// past its end are zero-filled, and zeros add nothing to the product or
// the sums.  The epilogue rounds the accumulator to bf16 once for y, sums
// each column's values and squares over the thread's rows, then across
// the warp by shuffles and across the 4 warps along M through shared
// memory in a fixed order, and writes one partial per column per block:
// no atomics, so two runs give the same bits.  What this simple form does
// not do: cp.async or TMA pipelines, wgmma, split-K, a coalesced store of
// y through shared memory, or a tile chosen per shape.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kAP = kBK + 8;    // x tile row pitch in bf16 (80 bytes)
constexpr int kThreads = 256;   // 8 warps: 4 along M x 2 along N

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i; each lane receives its column-major fragment of each.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// x [M, K], w [K, N], y [M, N] bf16 row-major; p1, p2 [gridDim.x, N] f32.
template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_bn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ p1,
                     float* __restrict__ p2, int M, int N, int K) {
  constexpr int BP = BN + 8;     // w tile row pitch in bf16
  constexpr int WN = BN / 2;     // columns a warp owns
  constexpr int NJ = WN / 8;     // 16 x 8 mma tiles a warp owns along N
  constexpr int A_CHUNKS = kBM * kBK / 8 / kThreads;   // 16-byte chunks
  constexpr int B_CHUNKS = kBK * BN / 8 / kThreads;
  __shared__ __align__(16) __nv_bfloat16 As[kBM * kAP];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBK * BP];
  __shared__ float red[2][4][BN];

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;

  float acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  uint4 ra[A_CHUNKS], rb[B_CHUNKS];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int k0) {
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int r = idx >> 2, kc = (idx & 3) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      ra[c] = (gr < M && gk < K)
                  ? *reinterpret_cast<const uint4*>(x + (long long)gr * K + gk)
                  : zero;
    }
#pragma unroll
    for (int c = 0; c < B_CHUNKS; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      const int r = idx / (BN / 8), nc = (idx % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      rb[c] = (gk < K && gn < N)
                  ? *reinterpret_cast<const uint4*>(w + (long long)gk * N + gn)
                  : zero;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      *reinterpret_cast<uint4*>(&As[(idx >> 2) * kAP + (idx & 3) * 8]) =
          ra[c];
    }
#pragma unroll
    for (int c = 0; c < B_CHUNKS; ++c) {
      const int idx = threadIdx.x + c * kThreads;
      *reinterpret_cast<uint4*>(
          &Bs[(idx / (BN / 8)) * BP + (idx % (BN / 8)) * 8]) = rb[c];
    }
  };

  const int ktiles = (K + kBK - 1) / kBK;
  load(0);
  store();
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load((kt + 1) * kBK);   // in flight meanwhile
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4], bf[NJ][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* p = &As[(wm * 32 + i * 16 + g) * kAP + kk + 2 * t];
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kAP);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kAP + 8);
      }
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        // matrices: k rows kk..+7 and kk+8..+15 of n tiles 2jj and 2jj+1
        const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ncol = wn * WN + jj * 16 + (lane >> 4) * 8;
        uint32_t r4[4];
        ldsm_x4_trans(r4, &Bs[krow * BP + ncol]);
        bf[2 * jj][0] = r4[0];
        bf[2 * jj][1] = r4[1];
        bf[2 * jj + 1][0] = r4[2];
        bf[2 * jj + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < ktiles) {
      __syncthreads();   // every warp is done with this tile
      store();
      __syncthreads();
    }
  }

  // y: c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + wn * WN + j * 8 + 2 * t;
    if (col >= N) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + h * 8;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(y + (long long)row * N + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  }

  // column sums of acc and acc^2 over the block's rows
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = acc[i][j][2 * h + e];
          s1 += v;
          s2 += v * v;
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {   // over g: lane bits 2-4
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (g == 0) {
        const int c = wn * WN + j * 8 + 2 * t + e;
        red[0][wm][c] = s1;
        red[1][wm][c] = s2;
      }
    }
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += kThreads) {
    const int n = n0 + c;
    if (n < N) {
      const long long o = (long long)blockIdx.x * N + n;
      p1[o] = ((red[0][0][c] + red[0][1][c]) + red[0][2][c]) + red[0][3][c];
      p2[o] = ((red[1][0][c] + red[1][1][c]) + red[1][2][c]) + red[1][3][c];
    }
  }
}

template <int BN>
cudaError_t run(const void* x, const void* w, void* y, void* p1, void* p2,
                int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  conv_bn_stats_kernel<BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(p1), static_cast<float*>(p2), M, N, K);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: [M, K] bf16, w: [K, N] bf16, y: [M, N] bf16, all contiguous and
// 16-byte aligned, K and N multiples of 8; p1, p2: [ceil(M / 128), N] f32
// partial sums of y's f32 accumulator and of its square.  Returns the CUDA
// error of the launch (0 on success).
int conv_bn_stats_bf16(const void* x, const void* w, void* y, void* p1,
                       void* p2, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 ||
      !aligned16(x) || !aligned16(w) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(N <= 64 ? run<64>(x, w, y, p1, p2, M, N, K, s)
                       : run<128>(x, w, y, p1, p2, M, N, K, s));
}

// The row-block height of the partials (their first dimension is
// ceil(M / this)).
int conv_bn_stats_block_rows(void) { return kBM; }

}  // extern "C"

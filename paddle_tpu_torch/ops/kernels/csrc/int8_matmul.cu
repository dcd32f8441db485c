// Int8 matrix product with a per-column rescale for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces: paddle_tpu/ops/pallas/int8_matmul.py:62
// `_int8_matmul_kernel` (launched by `int8_matmul_pallas`): out[m, n] =
// f32(sum_k x[m, k] * w[k, n]) * scale[n] in the compute dtype, where x and
// w are int8 and the sum is int32 (dynamic mode), or out = x @ (w dequantised
// to the compute dtype) with f32 sums (weight-only mode).
//
// What bounds it on this card: bytes for every GEMM of an int8 ResNet-50
// forward up to batch 32.  A conv's GEMM does 2*K operations per output
// element against about K bytes of int8 input rows and 2-4 bytes of output;
// at K <= 4608 and N <= 512 that is at most ~2*N operations per byte, below
// the ~590 int8 operations per byte the H100 needs before its 1,979 TOPS
// int8 tensor cores are the limit.  The least time is the int8 rows, the
// int8 weights and the output over 3.35 TB/s.
//
// What the design does about it: operands stay int8 all the way into the
// tensor cores (mma.sync m16n8k32 s8.s8 -> s32), so x and w are read at one
// byte an element and nothing is dequantised into memory.  A block computes
// a BM x BN output tile (128 or 64 by 128 or 64, chosen from M and N so the
// grid fills the 132 SMs where it can) over a K loop of 64-byte tiles
// streamed through a three-stage cp.async ring: two tiles are in flight
// while one is multiplied.  Rows are padded to 80 bytes in shared memory so
// the 32-bit fragment loads of a warp hit 32 different banks.  The K tail
// (K = 147 for the 7x7 stem) is loaded with cp.async's source size: the
// bytes past K are zero-filled, and zeros add nothing to an integer sum, so
// any K works as long as rows start on 16 bytes.  The epilogue converts the
// int32 sum with round-to-nearest (|sum| exceeds 2^24 from K ~ 1040 on),
// multiplies by the folded x_scale * w_scale of its column (one f32
// rounding, as the reference) and stores f32 or bf16 (round to nearest
// even).  Integer sums do not depend on their order, so the result is
// bitwise equal to the plain version.  What this simple form does not do:
// ldmatrix, wgmma on s8, TMA, split-K for grids smaller than the card, or a
// persistent tile loop.
//
// Weight-only mode dequantises the int8 weight tile into shared memory as
// the reference's compute dtype holds it and never writes it to device
// memory: for bf16, bf16(q) * bf16(scale) (one rounding, as XLA gives)
// feeding mma.sync m16n8k16 bf16 -> f32 on a 64 x 64 tile per block; for
// f32, f32(q) * scale feeding a tiled FMA kernel (4 x 4 outputs a
// thread; the tensor cores have no exact f32 product).  Both sum in f32
// and round the output to the compute dtype.  Plain element loads, no
// pipelining: this mode is not on the int8 ResNet path; it serves
// Int8InferenceLinear(act_quant=None).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;          // int8 bytes of K per tile: two mma k-steps
constexpr int kRow = kBK + 16;   // shared-memory row pitch in bytes
constexpr int kStages = 3;
constexpr int kSMs = 132;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                       float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// One k-tile of a BM x 64 (or BN x 64) int8 operand into shared memory:
// 16-byte chunks, rows past `rows` and bytes past K zero-filled.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* g,
                                          long long ld, int row0, int rows,
                                          int k0, int K) {
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * 4; c += THREADS) {
    const int r = c >> 2, kc = (c & 3) * 16;
    const int gr = row0 + r, k = k0 + kc;
    int bytes = K - k;
    bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
    if (gr >= rows) bytes = 0;
    const int8_t* src = bytes ? g + (long long)gr * ld + k : g;
    cp_async16(s + r * kRow + kc, src, bytes);
  }
}

// Dynamic mode: x [M, K] int8 (row pitch lda), w [N, K] int8 (row pitch
// ldb), scale [N] f32 (x_scale * w_scale), out [M, N] OT.  A warp owns a
// 64 x 32 output tile: 4 x 4 mma tiles of 16 x 8.
template <int BM, int BN, typename OT>
__global__ void __launch_bounds__((BM / 64) * (BN / 32) * 32)
int8_mm_dyn(const int8_t* __restrict__ x, long long lda,
            const int8_t* __restrict__ w, long long ldb,
            const float* __restrict__ scale, OT* __restrict__ out, int M,
            int N, int K) {
  constexpr int WN = BN / 32;
  constexpr int THREADS = (BM / 64) * WN * 32;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;                            // [kStages][BM][kRow]
  int8_t* Bs = smem + kStages * BM * kRow;      // [kStages][BN][kRow]

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      load_tile<BM, THREADS>(As + s * BM * kRow, x, lda, m0, M, s * kBK, K);
      load_tile<BN, THREADS>(Bs + s * BN * kRow, w, ldb, n0, N, s * kBK, K);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile kt landed; everyone is done with kt - 1
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      const int s = nk % kStages;
      load_tile<BM, THREADS>(As + s * BM * kRow, x, lda, m0, M, nk * kBK, K);
      load_tile<BN, THREADS>(Bs + s * BN * kRow, w, ldb, n0, N, nk * kBK, K);
    }
    cp_async_commit();

    const int8_t* a_s = As + (kt % kStages) * BM * kRow;
    const int8_t* b_s = Bs + (kt % kStages) * BN * kRow;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = a_s + (wm * 64 + i * 16 + g) * kRow + kk + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = b_s + (wn * 32 + j * 8 + g) * kRow + kk + t * 4;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at (row g, cols 2t, 2t+1); c2, c3 at row g + 8
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + t * 2;
    if (col >= N) continue;
    const float s0 = scale[col];
    const float s1 = col + 1 < N ? scale[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + i * 16 + g + h * 8;
        if (row >= M) continue;
        const float v0 = __int2float_rn(acc[i][j][2 * h]) * s0;
        const float v1 = __int2float_rn(acc[i][j][2 * h + 1]) * s1;
        OT* o = out + (long long)row * N + col;
        if (pairs) {
          store2(o, v0, v1);
        } else {
          store(o, v0);
          if (col + 1 < N) store(o + 1, v1);
        }
      }
    }
  }
}

template <int BM, int BN, typename OT>
cudaError_t run_dyn(const int8_t* x, long long lda, const int8_t* w,
                    long long ldb, const float* scale, void* out, int M,
                    int N, int K, cudaStream_t stream) {
  constexpr int threads = (BM / 64) * (BN / 32) * 32;
  const int smem = kStages * (BM + BN) * kRow;
  cudaError_t err = cudaFuncSetAttribute(
      int8_mm_dyn<BM, BN, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_mm_dyn<BM, BN, OT><<<grid, threads, smem, stream>>>(
      x, lda, w, ldb, scale, static_cast<OT*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename OT>
cudaError_t pick_dyn(const int8_t* x, long long lda, const int8_t* w,
                     long long ldb, const float* scale, void* out, int M,
                     int N, int K, cudaStream_t stream) {
  // the narrowest tile that is not mostly padding along N; 64-row tiles
  // when 128-row ones would leave SMs idle
  const bool narrow = N <= 64;
  const long long tiles128 =
      (long long)((M + 127) / 128) * ((N + (narrow ? 63 : 127)) /
                                      (narrow ? 64 : 128));
  const bool short_m = tiles128 < 2 * kSMs;
  if (narrow)
    return short_m ? run_dyn<64, 64, OT>(x, lda, w, ldb, scale, out, M, N,
                                         K, stream)
                   : run_dyn<128, 64, OT>(x, lda, w, ldb, scale, out, M, N,
                                          K, stream);
  return short_m ? run_dyn<64, 128, OT>(x, lda, w, ldb, scale, out, M, N, K,
                                        stream)
                 : run_dyn<128, 128, OT>(x, lda, w, ldb, scale, out, M, N,
                                         K, stream);
}

// Weight-only mode: x [M, K] (row pitch ldx), w [N, K] int8 (row pitch
// ldw), scale [N] f32, out [M, N] in x's dtype.  A 64 x 64 output tile a
// block, K in steps of 32.
constexpr int kWT = 64, kWK = 32;

// bf16: 4 warps, each a 32 x 32 tile of 2 x 4 mma tiles of 16 x 8; x and
// the dequantised weights as bf16 in shared memory, rows padded to 40
// (80 bytes) so a warp's 32-bit fragment loads hit 32 banks.
__global__ void __launch_bounds__(128)
int8_mm_wonly_bf16(const __nv_bfloat16* __restrict__ x, long long ldx,
                   const int8_t* __restrict__ w, long long ldw,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  constexpr int kP = kWK + 8;
  __shared__ __align__(16) __nv_bfloat16 xs[kWT][kP];
  __shared__ __align__(16) __nv_bfloat16 ws[kWT][kP];
  const int m0 = blockIdx.x * kWT, n0 = blockIdx.y * kWT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kWK) {
    for (int e = threadIdx.x; e < kWT * kWK; e += 128) {
      const int r = e / kWK, k = e % kWK;
      const int gm = m0 + r, gn = n0 + r, gk = k0 + k;
      xs[r][k] = (gm < M && gk < K) ? x[(long long)gm * ldx + gk] : zero;
      ws[r][k] = (gn < N && gk < K)
          ? __float2bfloat16_rn(
                (float)w[(long long)gn * ldw + gk] *
                __bfloat162float(__float2bfloat16_rn(scale[gn])))
          : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 2 * t]);
        af[i][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 2 * t]);
        af[i][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 2 * t + 8]);
        af[i][3] =
            *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(&ws[n][kk + 2 * t]);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(&ws[n][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + i * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn * 32 + j * 8 + t * 2 + (e & 1);
        if (row < M && col < N)
          out[(long long)row * N + col] = __float2bfloat16_rn(acc[i][j][e]);
      }
}

// f32: 16 x 16 threads, 4 x 4 outputs each, FMA.
__global__ void __launch_bounds__(256)
int8_mm_wonly_f32(const float* __restrict__ x, long long ldx,
                  const int8_t* __restrict__ w, long long ldw,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int M, int N, int K) {
  __shared__ float xs[kWK][kWT + 1];
  __shared__ float ws[kWK][kWT + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * kWT, n0 = blockIdx.y * kWT;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kWK) {
    for (int e = threadIdx.x; e < kWT * kWK; e += 256) {
      const int r = e / kWK, k = e % kWK;
      const int gm = m0 + r, gn = n0 + r, gk = k0 + k;
      xs[k][r] = (gm < M && gk < K) ? x[(long long)gm * ldx + gk] : 0.f;
      ws[k][r] = (gn < N && gk < K)
                     ? (float)w[(long long)gn * ldw + gk] * scale[gn]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[(long long)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic mode.  x: [M, K] int8 with row pitch lda; w: [N, K] int8 with
// row pitch ldb (both pointers and pitches multiples of 16 bytes); scale:
// [N] f32; out: [M, N] contiguous, f32 or bf16 (out_bf16).  Returns the
// CUDA error of the launch (0 on success).
int int8_matmul_dynamic(const void* x, long long lda, const void* w,
                        long long ldb, const void* scale, void* out, int M,
                        int N, int K, int out_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || lda < K || ldb < K || lda % 16 != 0 ||
      ldb % 16 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 || N > 65535 * 64)
    return (int)cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(out_bf16
                   ? pick_dyn<__nv_bfloat16>(xp, lda, wp, ldb, sp, out, M, N,
                                             K, s)
                   : pick_dyn<float>(xp, lda, wp, ldb, sp, out, M, N, K, s));
}

// Weight-only mode.  x: [M, K] f32 or bf16 (is_bf16) with row pitch ldx;
// w: [N, K] int8 with row pitch ldw; scale: [N] f32 (w_scale); out: [M, N]
// contiguous in x's dtype.
int int8_matmul_weight_only(const void* x, long long ldx, const void* w,
                            long long ldw, const void* scale, void* out,
                            int M, int N, int K, int is_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < K ||
      (N + kWT - 1) / kWT > 65535)
    return (int)cudaErrorInvalidValue;
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kWT - 1) / kWT, (N + kWT - 1) / kWT);
  if (is_bf16)
    int8_mm_wonly_bf16<<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ldx, wp, ldw, sp,
        static_cast<__nv_bfloat16*>(out), M, N, K);
  else
    int8_mm_wonly_f32<<<grid, 256, 0, s>>>(static_cast<const float*>(x), ldx,
                                           wp, ldw, sp,
                                           static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"

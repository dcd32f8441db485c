// Flash attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py:72 `_fwd_kernel`
// (launched by `_pallas_forward`, entry `_fa_impl`): blockwise online-
// softmax attention on (B, H, S, D), causal block skip, optional LSE.
//
// What bounds it on this card: a long causal prefill does 2*S^2*D*H
// flops against 4*S*H*D*2 bytes of Q/K/V/O, about 1000 flops per byte at
// S=2048, D=128 -- far above the H100's ~295 bf16 flops per byte, so it
// is bound by tensor-core operations, not memory.  Only `wgmma` reaches
// the card's 989 TFLOP/s; after the products, the exponentials (one per
// score, 16 a clock per SM) are the next limit.
//
// What the design does about it, on the bf16 head_dim-128 route
// (`flash_fwd_sm90`, the route of both main paths):
// - work items of (128 query rows, head, batch), heaviest causal items
//   first, at most one block per SM, each block walking its items in a
//   snake order; so the next item's Q and K/V loads run under the
//   current item's last tiles and its store;
// - three warpgroups: a producer (registers lowered with setmaxnreg.dec)
//   whose one thread issues every TMA load, and two consumer warpgroups
//   (setmaxnreg.inc) of 64 query rows each;
// - Q (128 x 128 bf16, 32 KB) is loaded once an item; K and V tiles of
//   128 keys (32 KB each) stream through a 2-stage ring in shared memory
//   with full and empty mbarriers, K and V released separately.  The
//   tensor maps are 4-D (D, S, H, B) with the caller's byte strides: the
//   server's (B, S, H, D) views need no copy, and TMA zero-fills rows
//   past the ragged end.  128-byte swizzle, as wgmma's shared-memory
//   descriptors expect; tiles past the causal diagonal are never loaded;
// - S = Q.K^T is wgmma m64n128k16 with both operands in shared memory (8
//   steps over D); the online softmax runs on the f32 accumulator in
//   registers (rows reduce over the 4 threads of a quad), one FFMA and
//   one ex2 per score with scale * log2(e) folded in, the mask only on
//   the diagonal tile and the ragged last tile;
// - O += P.V is wgmma m64n128k16 with A from registers: P is packed to
//   bf16 in place (the accumulator layout is the register A layout) and
//   V is read as an MN-major B operand (the transpose bit), so P never
//   touches shared memory;
// - both overlaps are done: a warpgroup issues S(j) and P(j-1).V(j-1)
//   together and runs the softmax of S(j) while P(j-1).V(j-1) is on the
//   tensor cores, and the two warpgroups ping-pong (named barriers) so
//   that one's softmax runs under the other's products.  A consumer
//   releases a K or V stage as soon as the wgmma that read it retires;
// - the epilogue normalises, stages O through shared memory in the
//   swizzled layout and stores it with one TMA store a warpgroup (rows
//   past Sq clipped); one thread a row writes the LSE.
// ptxas -v (nvcc 12.9, sm_90a): 168 registers (the count at entry,
// 65,536 / 384), 0 bytes of spills; 197,712 bytes of dynamic shared
// memory.  Registers are what limit the design: the in-flight S, O and P
// fragments take 160 of them, and ptxas serialises the wgmmas (C7512,
// "insufficient register resources") unless each commit is followed by
// operand fences.
//
// The other routes keep the first design: bf16 at head_dim 64 and 256 on
// mma.sync m16n8k16 (K/V staged synchronously through padded shared
// memory, P re-packed in registers, 64-row query tiles of 4 warps), and
// f32 on a plain FMA kernel (the tensor cores have no exact f32 product).
//
// Numerics follow the Pallas kernel: s = (q.k)*scale in f32, masked
// scores -1e30, running max/denominator in f32, probabilities rounded to
// bf16 for the P.V product (against the running max of each key tile:
// 128 keys on the sm90 route, 64 on the mma.sync route),
// out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)).  Ragged
// sequence ends are masked here; no length needs to divide the tiles.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, Hkv, Sq, Sk;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  float scale;
};

// ---------------------------------------------------------------------
// bf16 mma.sync route (head_dim 64 and 256)
// ---------------------------------------------------------------------

constexpr int kBQ = 64;   // query rows per block: 4 warps x 16
constexpr int kBK = 64;   // keys per tile
constexpr int kPad = 8;   // bf16 elements of row padding (16 bytes)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// copy `rows` rows of D bf16 (16-byte chunks) from global into a padded
// shared tile; rows at or past `limit` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride,
                                               int row0, int rows,
                                               int limit) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int c8 = (c % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + c8);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + c8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * (D + kPad);
  __nv_bfloat16* Vs = Ks + kBK * (D + kPad);

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;       // fragment row group
  const int t = lane % 4;       // thread in group

  const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q)
                            + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k)
                            + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v)
                            + b * p.v_sb + hk * p.v_sh;

  load_tile_bf16<D>(Qs, qg, p.q_ss, q0, kBQ, p.Sq);

  constexpr int kNT = D / 8;    // output n-tiles of 8 columns
  float oacc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};   // rows g and g+8 of this warp
  float l_r[2] = {0.f, 0.f};           // per-thread partial denominators

  const int row_a = q0 + warp * 16 + g;      // absolute query rows
  const int row_b = row_a + 8;
  const int kv_end = p.causal ? min(p.Sk, q0 + kBQ) : p.Sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const __nv_bfloat16* qw = Qs + (warp * 16) * (D + kPad);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // previous tile fully consumed
    load_tile_bf16<D>(Ks, kg, p.k_ss, k0, kBK, p.Sk);
    load_tile_bf16<D>(Vs, vg, p.v_ss, k0, kBK, p.Sk);
    __syncthreads();

    // S = Q K^T : 16 x 64 per warp, 8 n-tiles of 8 keys
    float sacc[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      const int c = ks * 16 + 2 * t;
      a[0] = *reinterpret_cast<const uint32_t*>(qw + g * (D + kPad) + c);
      a[1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * (D + kPad) + c);
      a[2] = *reinterpret_cast<const uint32_t*>(qw + g * (D + kPad) + c + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * (D + kPad) + c + 8);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const __nv_bfloat16* kr = Ks + (j * 8 + g) * (D + kPad) + c;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_16816(sacc[j], a, b0, b1);
      }
    }

    // scale, mask, online softmax (rows g and g+8; a row's 64 scores are
    // spread over the 4 threads of its quad)
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        const int qp = (e < 2) ? row_a : row_b;
        float s = sacc[j][e] * p.scale;
        if (kp >= p.Sk || (p.causal && kp > qp)) s = kNegInf;
        sacc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(sacc[j][e] - mx[e >> 1]);
        sacc[j][e] = pe;
        l_r[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P V : P (16 x 64) from registers, V (64 x D) from shared
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      a[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      a[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      a[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
      const unsigned short* vr = reinterpret_cast<const unsigned short*>(
          Vs + (kk * 16 + 2 * t) * (D + kPad));
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 = (uint32_t)vr[col]
                            | ((uint32_t)vr[(D + kPad) + col] << 16);
        const uint32_t b1 = (uint32_t)vr[8 * (D + kPad) + col]
                            | ((uint32_t)vr[9 * (D + kPad) + col] << 16);
        mma_16816(oacc[n], a, b0, b1);
      }
    }
  }

  // finish: full row denominators, normalise, store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const float inv[2] = {1.f / fmaxf(l_r[0], 1e-30f),
                        1.f / fmaxf(l_r[1], 1e-30f)};
  __nv_bfloat16* og = reinterpret_cast<__nv_bfloat16*>(p.o)
                      + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < p.Sq)
      *reinterpret_cast<uint32_t*>(og + row_a * p.o_ss + col) =
          pack_bf16(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
    if (row_b < p.Sq)
      *reinterpret_cast<uint32_t*>(og + row_b * p.o_ss + col) =
          pack_bf16(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
  }
  if (p.lse != nullptr && t == 0) {
    float* lg = p.lse + ((long long)b * p.H + h) * p.Sq;
    if (row_a < p.Sq) lg[row_a] = m_r[0] + logf(fmaxf(l_r[0], 1e-30f));
    if (row_b < p.Sq) lg[row_b] = m_r[1] + logf(fmaxf(l_r[1], 1e-30f));
  }
}

// ---------------------------------------------------------------------
// f32 FMA path
// ---------------------------------------------------------------------

constexpr int kRowsF = 8;               // query rows per warp
constexpr int kBQF = kWarps * kRowsF;   // 32 query rows per block
constexpr int kBKF = 32;                // keys per tile: one per lane

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);     // [kBQF][D]
  float* Ks = Qs + kBQF * D;                          // [kBKF][D+1]
  float* Vs = Ks + kBKF * (D + 1);                    // [kBKF][D]
  float* Ps = Vs + kBKF * D;                          // [kWarps][kRowsF][kBKF]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * kBQF;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float* qg = reinterpret_cast<const float*>(p.q) + b * p.q_sb
                    + h * p.q_sh;
  const float* kg = reinterpret_cast<const float*>(p.k) + b * p.k_sb
                    + hk * p.k_sh;
  const float* vg = reinterpret_cast<const float*>(p.v) + b * p.v_sb
                    + hk * p.v_sh;

  for (int e = threadIdx.x; e < kBQF * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[e] = (q0 + r < p.Sq) ? qg[(long long)(q0 + r) * p.q_ss + d] : 0.f;
  }

  constexpr int kCols = D / 32;   // output columns per lane
  float acc[kRowsF][kCols];
  float m_r[kRowsF], l_r[kRowsF];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  const int row0 = q0 + warp * kRowsF;
  const int kv_end = p.causal ? min(p.Sk, q0 + kBQF) : p.Sk;
  const int n_tiles = (kv_end + kBKF - 1) / kBKF;
  float* Pw = Ps + warp * kRowsF * kBKF;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBKF;
    __syncthreads();
    for (int e = threadIdx.x; e < kBKF * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool ok = k0 + r < p.Sk;
      Ks[r * (D + 1) + d] = ok ? kg[(long long)(k0 + r) * p.k_ss + d] : 0.f;
      Vs[r * D + d] = ok ? vg[(long long)(k0 + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // lane = key column
    float s[kRowsF];
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int r = 0; r < kRowsF; ++r)
        s[r] = fmaf(Qs[(warp * kRowsF + r) * D + d], kv, s[r]);
    }
    const int kp = k0 + lane;
    float alpha[kRowsF];
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      float sv = s[r] * p.scale;
      if (kp >= p.Sk || (p.causal && kp > row0 + r)) sv = kNegInf;
      float mx = sv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[r], mx);
      const float pe = expf(sv - m_new);
      float sum = pe;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      alpha[r] = expf(m_r[r] - m_new);
      l_r[r] = l_r[r] * alpha[r] + sum;
      m_r[r] = m_new;
      Pw[r * kBKF + lane] = pe;
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float pv[kRowsF];
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) pv[r] = 0.f;
      for (int n = 0; n < kBKF; ++n) {
        const float vv = Vs[n * D + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsF; ++r)
          pv[r] = fmaf(Pw[r * kBKF + n], vv, pv[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowsF; ++r)
        acc[r][c] = acc[r][c] * alpha[r] + pv[r];
    }
    __syncwarp();
  }

  float* og = reinterpret_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const int row = row0 + r;
    if (row >= p.Sq) continue;
    const float l = fmaxf(l_r[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      og[(long long)row * p.o_ss + lane + 32 * c] = acc[r][c] / l;
    if (p.lse != nullptr && lane == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + row] = m_r[r] + logf(l);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem,
                   cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    if constexpr (D == 128) {
      return cudaErrorInvalidValue;   // the sm90 route's
    } else {
      const size_t smem = (size_t)(kBQ + 2 * kBK) * (D + kPad)
                          * sizeof(__nv_bfloat16);
      dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
      return launch(flash_fwd_bf16<D>, grid, smem, stream, p);
    }
  }
  const size_t smem = (size_t)(kBQF * D + kBKF * (D + 1) + kBKF * D
                               + kWarps * kRowsF * kBKF) * sizeof(float);
  dim3 grid((p.Sq + kBQF - 1) / kBQF, p.H, B);
  return launch(flash_fwd_f32<D>, grid, smem, stream, p);
}

// ---------------------------------------------------------------------
// bf16 head_dim-128 route for sm_90a: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------

namespace sm90 {

constexpr int kBQ = 128;          // query rows per work item
constexpr int kBK = 128;          // keys per K/V tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 384;     // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kPanelBytes = 128 * kPanel * 2;   // 128 rows x 128 B
constexpr int kTileBytes = 2 * kPanelBytes;     // 128 rows x 128 cols
constexpr int kSmemBytes = 1024                 // alignment slack
                           + kTileBytes         // Q
                           + 2 * kStages * kTileBytes   // K, V ring
                           + kTileBytes         // O staging
                           + 8 * (2 + 4 * kStages);    // mbarriers

struct Params {
  float* lse;
  int B, H, Hkv, Sq, Sk;
  int n_qt;           // query tiles per (head, batch)
  int causal;
  float scale;        // for the LSE
  float scale_log2;   // scale * log2(e), for the exponentials
};

// S = Q K^T for this warpgroup's 64 rows against a 128-key tile, 8 steps
// of 16 over head_dim (the first step overwrites S).  Descriptors of
// step 0; step kk adds (kk / 4) panels and (kk % 4) 32-byte columns.
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint64_t off = ((kk / 4) * kPanelBytes + (kk % 4) * 32) >> 4;
    wgmma_ss(sc, dq + off, dk + off, kk > 0);
  }
}

// O += P V, 8 steps of 16 keys; P in registers, V MN-major; step kk adds
// 16 key rows of 128 bytes
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&pa)[32],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs(o, &pa[4 * kk], dv + ((kk * 16 * 128) >> 4));
}

// Accumulator element r of a thread: row row_a (+8 if bit 1 of r),
// column 8 * (r / 4) + 2 * t + (r & 1), t = lane % 4.
struct RowState {
  float m_a, m_b;   // running max, raw q.k units
  float l_a, l_b;   // the thread's partial sums of P
};

// One key tile's online softmax on the raw scores `sc`: masks where
// `mask` says (the diagonal or ragged tile), updates the running max and
// the thread's partial sums, returns each row's rescale factor and
// leaves P (f32) in `sc`.  One FFMA and one ex2 a score: the scale and
// log2(e) are folded into c.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], RowState& st,
                                             float& alpha_a, float& alpha_b,
                                             float c, bool mask, int k0,
                                             int Sk, int causal, int row_a,
                                             int t) {
  if (mask) {
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      const int key = k0 + 8 * (r / 4) + 2 * t + (r & 1);
      const int row = row_a + ((r & 2) ? 8 : 0);
      if (key >= Sk || (causal && key > row)) sc[r] = kNegInf;
    }
  }
  float mx_a = st.m_a, mx_b = st.m_b;
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    if (r & 2) mx_b = fmaxf(mx_b, sc[r]);
    else mx_a = fmaxf(mx_a, sc[r]);
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mc_a = mx_a * c, mc_b = mx_b * c;
  // exactly 1 where the running max did not move
  alpha_a = ex2((st.m_a - mx_a) * c);
  alpha_b = ex2((st.m_b - mx_b) * c);
  st.m_a = mx_a;
  st.m_b = mx_b;
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    const float pe = ex2(fmaf(sc[r], c, (r & 2) ? -mc_b : -mc_a));
    sc[r] = pe;
    if (r & 2) rs_b += pe;
    else rs_a += pe;
  }
  st.l_a = st.l_a * alpha_a + rs_a;
  st.l_b = st.l_b * alpha_b + rs_b;
}

// P to bf16 as the register A fragments of P.V: k-step kk takes
// accumulator columns 16kk..16kk+15, elements 8kk..8kk+7
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = pack_bf16x2(sc[2 * i], sc[2 * i + 1]);
}

// The work items, (query tile, head, batch), heaviest causal tiles first;
// block c takes items c, 2G - 1 - c, 2G + c, 4G - 1 - c, ... of the G
// blocks' rounds (a snake, so that heavy and light items even out).
// Returns false past the last item.
struct Item {
  int qt, h, b, n_tiles;
};

__device__ __forceinline__ bool item_of(const Params& p, int round,
                                        Item& it) {
  const int G = gridDim.x, c = blockIdx.x;
  const int i = round * G + ((round & 1) ? G - 1 - c : c);
  const int hb = p.H * p.B;
  if (i >= p.n_qt * hb) return false;
  it.qt = p.n_qt - 1 - i / hb;
  it.h = (i % hb) % p.H;
  it.b = (i % hb) / p.H;
  const int q0 = it.qt * kBQ;
  const int kv_end = p.causal ? min(p.Sk, q0 + kBQ) : p.Sk;
  it.n_tiles = (kv_end + kBK - 1) / kBK;
  return true;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to, const Params p) {
  extern __shared__ __align__(128) unsigned char smem_sm90[];
  // swizzled tiles need 1024-byte alignment
  const uint32_t sQ = (smem_u32(smem_sm90) + 1023u) & ~1023u;
  const uint32_t sK = sQ + kTileBytes;                // [stage]
  const uint32_t sV = sK + kStages * kTileBytes;      // [stage]
  const uint32_t sO = sV + kStages * kTileBytes;      // [warpgroup]
  const uint32_t bar_q = sO + kTileBytes;             // Q full
  const uint32_t bar_qe = bar_q + 8;                  // Q empty
  const uint32_t bar_k = bar_qe + 8;                  // K full, [stage]
  const uint32_t bar_v = bar_k + 8 * kStages;         // V full, [stage]
  const uint32_t bar_ek = bar_v + 8 * kStages;        // K empty, [stage]
  const uint32_t bar_ev = bar_ek + 8 * kStages;       // V empty, [stage]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, kConsumerWarps);
      mbar_init(bar_ev + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0 && lane == 0) {
      int kv_it = 0;   // K/V tiles loaded so far: the ring's position
      Item it;
      for (int round = 0; item_of(p, round, it); ++round) {
        const int hk = it.h / (p.H / p.Hkv);
        // Q's previous item released (passes at once on the first)
        mbar_wait(bar_qe, (round & 1) ^ 1);
        mbar_expect_tx(bar_q, kTileBytes);
        tma_load(sQ, &tq, bar_q, 0, it.qt * kBQ, it.h, it.b);
        tma_load(sQ + kPanelBytes, &tq, bar_q, kPanel, it.qt * kBQ, it.h,
                 it.b);
        for (int j = 0; j < it.n_tiles; ++j, ++kv_it) {
          const int s = kv_it % kStages;
          // the slot's previous tile released (passes at once at first)
          const uint32_t par = ((kv_it / kStages) & 1) ^ 1;
          const int k0 = j * kBK;
          const uint32_t dk = sK + s * kTileBytes;
          const uint32_t dv = sV + s * kTileBytes;
          mbar_wait(bar_ek + 8 * s, par);
          mbar_expect_tx(bar_k + 8 * s, kTileBytes);
          tma_load(dk, &tk, bar_k + 8 * s, 0, k0, hk, it.b);
          tma_load(dk + kPanelBytes, &tk, bar_k + 8 * s, kPanel, k0, hk,
                   it.b);
          mbar_wait(bar_ev + 8 * s, par);
          mbar_expect_tx(bar_v + 8 * s, kTileBytes);
          tma_load(dv, &tv, bar_v + 8 * s, 0, k0, hk, it.b);
          tma_load(dv + kPanelBytes, &tv, bar_v + 8 * s, kPanel, k0, hk,
                   it.b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = warp / 4 - 1;          // consumer warpgroup 0 or 1
    const int wl = warp % 4;              // warp within it: 16 rows
    const int g = lane / 4;               // accumulator row group
    const int t = lane % 4;               // thread in the quad
    const int tid = threadIdx.x % 128;
    const float c = p.scale_log2;
    const uint64_t dq = sw128_desc(sQ + cw * 64 * 128, 16, 1024);
    const uint32_t oa = sO + cw * (kTileBytes / 2);   // its O staging
    auto k_desc = [&](int s) {
      return sw128_desc(sK + s * kTileBytes, 16, 1024);
    };
    auto v_desc = [&](int s) {
      return sw128_desc(sV + s * kTileBytes, kPanelBytes, 1024);
    };
    // Ping-pong: the tensor cores alternate between the two warpgroups.
    // Each waits for its turn (named barrier 3 + cw) before it issues
    // S(j) and P(j-1).V(j-1), and hands the turn over (3 + other) once
    // they are issued, so one warpgroup's softmax runs under the other's
    // products.  Warpgroup 1 gives warpgroup 0 the first turn and skips
    // its own last hand-over, so every barrier sees as many arrivals as
    // waits.
    auto turn_wait = [&]() { named_sync<256>(3 + cw); };
    auto turn_pass = [&]() { named_arrive<256>(3 + (cw ^ 1)); };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    if (cw == 1) named_arrive<256>(3);

    int kv_it = 0;
    Item it;
    bool more = item_of(p, 0, it);
    for (int round = 0; more; ++round) {
      const int n = it.n_tiles;
      const int wg_row0 = it.qt * kBQ + cw * 64;
      const int row_a = wg_row0 + wl * 16 + g;   // rows row_a, row_a + 8
      const int row_b = row_a + 8;
      // the diagonal tile and the ragged last tile need the mask
      auto softmax = [&](float (&sc)[64], RowState& st, float& alpha_a,
                         float& alpha_b, int j) {
        const int k0 = j * kBK;
        softmax_tile(sc, st, alpha_a, alpha_b, c,
                     k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > wg_row0),
                     k0, p.Sk, p.causal, row_a, t);
      };
      float o[64], sc[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) o[r] = sc[r] = 0.f;
      uint32_t pa[32];
      RowState st{kNegInf, kNegInf, 0.f, 0.f};
      float alpha_a, alpha_b;

      // S(j) and P(j-1).V(j-1) are issued together; the softmax of S(j)
      // runs while P(j-1).V(j-1) is on the tensor cores.  A consumer
      // releases K(j) once S(j) has retired, V(j-1) once P(j-1).V(j-1)
      // has, and Q after the item's last S.
      mbar_wait(bar_q, round & 1);
      turn_wait();
      {
        const int s = kv_it % kStages;
        mbar_wait(bar_k + 8 * s, (kv_it / kStages) & 1);
        wgmma_fence();
        issue_qk(sc, dq, k_desc(s));
        wgmma_commit();
        fence_regs(sc);
        turn_pass();
        wgmma_wait<0>();
        fence_regs(sc);
        release(bar_ek + 8 * s);
        if (n == 1) release(bar_qe);
        softmax(sc, st, alpha_a, alpha_b, 0);
        pack_p(sc, pa);
      }
      for (int j = 1; j < n; ++j) {
        const int s = (kv_it + j) % kStages;
        const int sp = (kv_it + j - 1) % kStages;
        turn_wait();
        mbar_wait(bar_k + 8 * s, ((kv_it + j) / kStages) & 1);
        mbar_wait(bar_v + 8 * sp, ((kv_it + j - 1) / kStages) & 1);
        wgmma_fence();
        issue_qk(sc, dq, k_desc(s));
        wgmma_commit();
        issue_pv(o, pa, v_desc(sp));
        wgmma_commit();
        fence_regs(sc);
        fence_regs(o);
        fence_regs(pa);
        turn_pass();
        wgmma_wait<1>();
        fence_regs(sc);
        release(bar_ek + 8 * s);
        if (j == n - 1) release(bar_qe);
        softmax(sc, st, alpha_a, alpha_b, j);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(bar_ev + 8 * sp);
#pragma unroll
        for (int r = 0; r < 64; ++r) o[r] *= (r & 2) ? alpha_b : alpha_a;
        pack_p(sc, pa);
      }
      {
        const int sp = (kv_it + n - 1) % kStages;
        turn_wait();
        mbar_wait(bar_v + 8 * sp, ((kv_it + n - 1) / kStages) & 1);
        wgmma_fence();
        issue_pv(o, pa, v_desc(sp));
        wgmma_commit();
        fence_regs(o);
        wgmma_wait<0>();
        fence_regs(o);
        release(bar_ev + 8 * sp);
      }
      kv_it += n;
      const Item cur = it;
      more = item_of(p, round + 1, it);
      if (more || cw == 0) turn_pass();

      // epilogue: full row sums, normalise, LSE
      float l_a = st.l_a, l_b = st.l_b;
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      l_a = fmaxf(l_a, 1e-30f);
      l_b = fmaxf(l_b, 1e-30f);
      const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
      if (p.lse != nullptr && t == 0) {
        float* lg = p.lse + ((long long)cur.b * p.H + cur.h) * p.Sq;
        if (row_a < p.Sq) lg[row_a] = st.m_a * p.scale + logf(l_a);
        if (row_b < p.Sq) lg[row_b] = st.m_b * p.scale + logf(l_b);
      }

      // O (bf16) to this warpgroup's staging tile, two 64-column panels
      // in the 128-byte swizzle (conflict-free, and the layout the store
      // map reads), once the previous item's store has read it; then one
      // TMA store, which clips rows past Sq
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync<128>(1 + cw);
      const int lr_a = wl * 16 + g, lr_b = lr_a + 8;   // local rows
#pragma unroll
      for (int r = 0; r < 64; r += 2) {
        const int col = 8 * (r / 4) + 2 * t;
        const int lr = (r & 2) ? lr_b : lr_a;
        const float inv = (r & 2) ? inv_b : inv_a;
        const int chunk = (col % kPanel) / 8;
        const uint32_t addr = oa + (col / kPanel) * (kTileBytes / 4)
                              + lr * 128 + ((chunk ^ (lr % 8)) * 16)
                              + (col % 8) * 2;
        const uint32_t v2 = pack_bf16x2(o[r] * inv, o[r + 1] * inv);
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v2)
                     : "memory");
      }
      // the writes must be visible to the async proxy before TMA reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync<128>(1 + cw);
      if (tid == 0) {
        tma_store(&to, oa, 0, wg_row0, cur.h, cur.b);
        tma_store(&to, oa + kTileBytes / 4, kPanel, wg_row0, cur.h, cur.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (!more)
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      }
    }
  }
}

}  // namespace sm90

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  static char buf[160];
  if (err == kErrPlan)
    return "the launch plan names tiles this library was not built with";
  if (err == kErrNoEncode)
    return "cuTensorMapEncodeTiled not found through the CUDA runtime";
  if (err >= kErrEncode) {
    const int which = (err - kErrEncode) % 16;
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed for %s "
             "(CUresult %d)", which == 0 ? "q" : which == 1 ? "k"
             : which == 2 ? "v" : "o", (err - kErrEncode) / 16);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}

// The mma.sync and FMA routes: q/k/v/o (B, H, S, D) views with unit
// stride on D; strides in elements.  lse: contiguous (B, H, Sq) f32, or
// null.  bf16 at head_dim 128 is not taken here (that is the sm90
// route's).  Returns the CUDA error of the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, int B, int H, int Hkv, int Sq,
                        int Sk, int D, long long q_sb, long long q_sh,
                        long long q_ss, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh,
                        long long v_ss, long long o_sb, long long o_sh,
                        long long o_ss, int causal, float scale, int is_bf16,
                        void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0
      || (is_bf16 && D == 128))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, static_cast<float*>(lse), H, Hkv, Sq, Sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)run<64>(p, B, is_bf16, s);
    case 128: return (int)run<128>(p, B, is_bf16, s);
    case 256: return (int)run<256>(p, B, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The sm90 route: bf16, head_dim 128.  q/k/v: (B, H, S, 128) views with
// unit stride on D, 16-byte aligned; o: the (B, H, Sq, 128) output, same
// rules.  `tma_strides`: the byte strides (seq, head, batch) of q, k, v
// and o, 12 values, multiples of 16.  lse: contiguous (B, H, Sq) f32, or
// null.  `plan`: block_q, block_k, stages, threads, shared-memory bytes
// and the grid (blocks, 1, 1) as the Python launch plan computed them;
// the tiles must be the ones compiled here, and the blocks at most the
// work items.  Returns the CUDA error of the launch (0 on success).
int flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Hkv,
                             int Sq, int Sk, const long long* tma_strides,
                             const int* plan, int causal, float scale,
                             void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_qt = (Sq + sm90::kBQ - 1) / sm90::kBQ;
  // plan: block_q, block_k, stages, threads, shared memory, and the grid
  // (blocks, 1, 1): one block per work item, or fewer that loop
  if (plan[0] != sm90::kBQ || plan[1] != sm90::kBK
      || plan[2] != sm90::kStages || plan[3] != sm90::kThreads
      || plan[4] != sm90::kSmemBytes || plan[5] < 1
      || plan[5] > n_qt * H * B || plan[6] != 1 || plan[7] != 1)
    return kErrPlan;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  const int seqs[4] = {Sq, Sk, Sk, Sq};
  const int heads[4] = {H, Hkv, Hkv, H};
  for (int i = 0; i < 4; ++i) {
    // loads take 128-row boxes, the store a warpgroup's 64 rows
    const int rc = encode_map(fn, &maps[i], ptrs[i], seqs[i], heads[i], B,
                              tma_strides + 3 * i, i < 3 ? sm90::kBK : 64);
    if (rc != 0) return kErrEncode + rc * 16 + i;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      sm90::flash_fwd_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sm90::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  sm90::Params p{static_cast<float*>(lse), B, H, Hkv, Sq, Sk, n_qt,
                 causal, scale, scale * sm90::kLog2e};
  sm90::flash_fwd_sm90<<<plan[5], sm90::kThreads, sm90::kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Flash attention backward for Hopper (sm_90a), with a plain C interface:
// two kernels, dK/dV and dQ, from the forward's saved logsumexp.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py:208 `_bwd_dkv_kernel`
// Replaces: paddle_tpu/ops/pallas/flash_attention.py:258 `_bwd_dq_kernel`
// (launched by `_pallas_backward`, the custom-vjp backward `_fa_bwd`):
// FlashAttention-2 backward on (B, H, S, D), causal block skip.
//
// What bounds it on this card: at the training shape (S=2048, D=128) the
// dK/dV kernel does 8*D flops and the dQ kernel 6*D flops per unmasked
// (query, key) pair against 6 and 4 rows of S*D elements moved per head,
// about 1000 flops per byte -- far above the H100's ~295 bf16 flops per
// byte, so both are bound by tensor-core operations, not memory.
//
// What the design does about it: every product runs on the tensor cores
// with mma.sync m16n8k16 bf16 -> f32, and the score tile never leaves
// registers: the accumulator fragment of a 16x64 product is re-packed in
// registers as the A operand of the next product (the layouts line up),
// so P^T and dS^T (dK/dV kernel) and dS (dQ kernel) cost no shared or
// device memory traffic.  The dK/dV block keeps its K and V tile in
// shared memory for the whole loop over query tiles (and over the R query
// heads of its group under grouped-query attention), and the dQ block
// keeps its Q and dO tile while it loops over key tiles.  No atomics: the
// two kernels write disjoint outputs, so the gradients are bitwise the
// same from run to run.  The simple form stops there: no TMA, no wgmma,
// no ldmatrix, no double buffering -- those are later work.  The f32 path
// is a plain FMA kernel (the tensor cores have no exact f32 product).
//
// Grids: dK/dV (key tiles, Hkv, B), one block of 4 warps per 64-key tile
// (bf16, D <= 128; at D = 256 two warps share a 16-key row group and
// split the output columns, so a block holds 32 keys) or 32-key tile
// (f32); dQ (query tiles, H, B), one block per 64-row (bf16) or 32-row
// (f32) query tile, heavy (late) tiles first.
// Numerics follow the Pallas kernels: s = (q.k)*scale in f32, masked
// pairs have p = 0, p = exp(s - lse), dp = dO.v in f32,
// dS = p * (dp - delta) * scale, with P and dS rounded to bf16 before
// their products on the bf16 path, accumulations in f32, outputs cast to
// the input dtype once.  The causal mask is top-left aligned (query i
// sees keys 0..i).  Ragged sequence ends are masked here; no length needs
// to divide the tiles.  delta = rowsum(dO * O) comes from the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// strides (elements) of q, k, v, dO, dq, dk, dv: (batch, head, seq) each
enum { kQ = 0, kK, kV, kDO, kDQ, kDK, kDV, kNumT };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, H, Sq) contiguous
  const float* delta;   // (B, H, Sq) contiguous
  void* dq;
  void* dk;
  void* dv;
  int H, Hkv, Sq, Sk;
  long long st[kNumT][3];
  int causal;
  float scale;
};

// ---------------------------------------------------------------------
// bf16 tensor-core path
// ---------------------------------------------------------------------

constexpr int kBQ = 64;   // query rows per tile: 4 warps x 16
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
  constexpr int kChunks = D / 8;
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

// acc[j] (16 x 64, 8 n-tiles of 8 columns) += A (16 rows at `arow`) times
// the transpose of the 64 rows at `brow`, contracting over D
template <int D>
__device__ __forceinline__ void mma_abt(float (*acc)[4],
                                        const __nv_bfloat16* arow,
                                        const __nv_bfloat16* brow,
                                        int g, int t) {
  constexpr int kS = D + kPad;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    const int c = ks * 16 + 2 * t;
    a[0] = *reinterpret_cast<const uint32_t*>(arow + g * kS + c);
    a[1] = *reinterpret_cast<const uint32_t*>(arow + (g + 8) * kS + c);
    a[2] = *reinterpret_cast<const uint32_t*>(arow + g * kS + c + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(arow + (g + 8) * kS + c + 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* br = brow + (j * 8 + g) * kS + c;
      mma_16816(acc[j], a, *reinterpret_cast<const uint32_t*>(br),
                *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// out[n] (16 x kNT*8) += P (16 x 64, the f32 accumulator fragment `pf`,
// rounded to bf16 here) times the 64 rows x (kNT*8) columns of `rows`
// starting at column `col0`
template <int D, int kNT>
__device__ __forceinline__ void mma_pv(float (*out)[4], float (*pf)[4],
                                       const __nv_bfloat16* rows, int col0,
                                       int g, int t) {
  constexpr int kS = D + kPad;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(pf[2 * kk][0], pf[2 * kk][1]);
    a[1] = pack_bf16(pf[2 * kk][2], pf[2 * kk][3]);
    a[2] = pack_bf16(pf[2 * kk + 1][0], pf[2 * kk + 1][1]);
    a[3] = pack_bf16(pf[2 * kk + 1][2], pf[2 * kk + 1][3]);
    const unsigned short* vr = reinterpret_cast<const unsigned short*>(
        rows + (kk * 16 + 2 * t) * kS);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = col0 + n * 8 + g;
      const uint32_t b0 = (uint32_t)vr[col] | ((uint32_t)vr[kS + col] << 16);
      const uint32_t b1 = (uint32_t)vr[8 * kS + col]
                          | ((uint32_t)vr[9 * kS + col] << 16);
      mma_16816(out[n], a, b0, b1);
    }
  }
}

// dK/dV: one block per (key tile, kv head, batch).  CS warps share a row
// group of 16 keys and split the D output columns CS ways.
template <int D, int CS>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16(Params p) {
  constexpr int kS = D + kPad;
  constexpr int kBK = 16 * kWarps / CS;   // keys per block
  constexpr int kDW = D / CS;             // output columns per warp
  constexpr int kNT = kDW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kBK * kS;
  __nv_bfloat16* Qs = Vs + kBK * kS;
  __nv_bfloat16* Os = Qs + kBQ * kS;      // dO
  float* Ls = reinterpret_cast<float*>(Os + kBQ * kS);
  float* Dl = Ls + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int R = p.H / p.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = warp / CS;       // key row group
  const int col0 = (warp % CS) * kDW;

  load_tile_bf16<D>(Ks, reinterpret_cast<const __nv_bfloat16*>(p.k)
                            + b * p.st[kK][0] + hk * p.st[kK][1],
                    p.st[kK][2], k0, kBK, p.Sk);
  load_tile_bf16<D>(Vs, reinterpret_cast<const __nv_bfloat16*>(p.v)
                            + b * p.st[kV][0] + hk * p.st[kV][1],
                    p.st[kV][2], k0, kBK, p.Sk);

  float dk[kNT][4], dv[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int key_a = k0 + rg * 16 + g;   // this thread's key rows
  const int key_b = key_a + 8;
  const __nv_bfloat16* kw = Ks + rg * 16 * kS;
  const __nv_bfloat16* vw = Vs + rg * 16 * kS;
  const int qt0 = p.causal ? k0 / kBQ : 0;
  const int n_qt = (p.Sq + kBQ - 1) / kBQ;

  for (int r = 0; r < R; ++r) {
    const int h = hk * R + r;
    const __nv_bfloat16* qg = reinterpret_cast<const __nv_bfloat16*>(p.q)
                              + b * p.st[kQ][0] + h * p.st[kQ][1];
    const __nv_bfloat16* og = reinterpret_cast<const __nv_bfloat16*>(p.dout)
                              + b * p.st[kDO][0] + h * p.st[kDO][1];
    const float* lg = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* dg = p.delta + ((long long)b * p.H + h) * p.Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();   // previous query tile fully consumed
      load_tile_bf16<D>(Qs, qg, p.st[kQ][2], q0, kBQ, p.Sq);
      load_tile_bf16<D>(Os, og, p.st[kDO][2], q0, kBQ, p.Sq);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        const bool in = q0 + i < p.Sq;
        Ls[i] = in ? lg[q0 + i] : 0.f;
        Dl[i] = in ? dg[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T: 16 keys x 64 queries per warp; then P^T in place
      float sacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
      mma_abt<D>(sacc, kw, Qs, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1);
          const int qp = q0 + qi;
          const int kp = (e < 2) ? key_a : key_b;
          const bool live = qp < p.Sq && kp < p.Sk
                            && !(p.causal && kp > qp);
          sacc[j][e] = live ? expf(sacc[j][e] * p.scale - Ls[qi]) : 0.f;
        }
      }
      // dV += bf16(P^T) dO
      mma_pv<D, kNT>(dv, sacc, Os, col0, g, t);

      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) scale in place
      float pacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pacc[j][0] = pacc[j][1] = pacc[j][2] = pacc[j][3] = 0.f;
      mma_abt<D>(pacc, vw, Os, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1);
          sacc[j][e] = sacc[j][e] * (pacc[j][e] - Dl[qi]) * p.scale;
        }
      }
      // dK += bf16(dS^T) Q
      mma_pv<D, kNT>(dk, sacc, Qs, col0, g, t);
    }
  }

  __nv_bfloat16* dkg = reinterpret_cast<__nv_bfloat16*>(p.dk)
                       + b * p.st[kDK][0] + hk * p.st[kDK][1];
  __nv_bfloat16* dvg = reinterpret_cast<__nv_bfloat16*>(p.dv)
                       + b * p.st[kDV][0] + hk * p.st[kDV][1];
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = col0 + n * 8 + 2 * t;
    if (key_a < p.Sk) {
      *reinterpret_cast<uint32_t*>(dkg + key_a * p.st[kDK][2] + col) =
          pack_bf16(dk[n][0], dk[n][1]);
      *reinterpret_cast<uint32_t*>(dvg + key_a * p.st[kDV][2] + col) =
          pack_bf16(dv[n][0], dv[n][1]);
    }
    if (key_b < p.Sk) {
      *reinterpret_cast<uint32_t*>(dkg + key_b * p.st[kDK][2] + col) =
          pack_bf16(dk[n][2], dk[n][3]);
      *reinterpret_cast<uint32_t*>(dvg + key_b * p.st[kDV][2] + col) =
          pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

// dQ: one block per (query tile, head, batch), 16 query rows per warp
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(Params p) {
  constexpr int kS = D + kPad;
  constexpr int kBK = 64;   // keys per tile
  constexpr int kNT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + kBQ * kS;      // dO
  __nv_bfloat16* Ks = Os + kBQ * kS;
  __nv_bfloat16* Vs = Ks + kBK * kS;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_tile_bf16<D>(Qs, reinterpret_cast<const __nv_bfloat16*>(p.q)
                            + b * p.st[kQ][0] + h * p.st[kQ][1],
                    p.st[kQ][2], q0, kBQ, p.Sq);
  load_tile_bf16<D>(Os, reinterpret_cast<const __nv_bfloat16*>(p.dout)
                            + b * p.st[kDO][0] + h * p.st[kDO][1],
                    p.st[kDO][2], q0, kBQ, p.Sq);
  const __nv_bfloat16* kg = reinterpret_cast<const __nv_bfloat16*>(p.k)
                            + b * p.st[kK][0] + hk * p.st[kK][1];
  const __nv_bfloat16* vg = reinterpret_cast<const __nv_bfloat16*>(p.v)
                            + b * p.st[kV][0] + hk * p.st[kV][1];

  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const float* lg = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* dg = p.delta + ((long long)b * p.H + h) * p.Sq;
  const float lse_r[2] = {row_a < p.Sq ? lg[row_a] : 0.f,
                          row_b < p.Sq ? lg[row_b] : 0.f};
  const float del_r[2] = {row_a < p.Sq ? dg[row_a] : 0.f,
                          row_b < p.Sq ? dg[row_b] : 0.f};

  float dq[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const int kv_end = p.causal ? min(p.Sk, q0 + kBQ) : p.Sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const __nv_bfloat16* qw = Qs + warp * 16 * kS;
  const __nv_bfloat16* ow = Os + warp * 16 * kS;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // previous tile fully consumed
    load_tile_bf16<D>(Ks, kg, p.st[kK][2], k0, kBK, p.Sk);
    load_tile_bf16<D>(Vs, vg, p.st[kV][2], k0, kBK, p.Sk);
    __syncthreads();

    // S = Q K^T (16 x 64 per warp), then P in place
    float sacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
    mma_abt<D>(sacc, qw, Ks, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        const int qp = (e < 2) ? row_a : row_b;
        const bool live = qp < p.Sq && kp < p.Sk && !(p.causal && kp > qp);
        sacc[j][e] = live ? expf(sacc[j][e] * p.scale - lse_r[e >> 1]) : 0.f;
      }
    }
    // dP = dO V^T, then dS = P (dP - delta) scale in place
    float pacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pacc[j][0] = pacc[j][1] = pacc[j][2] = pacc[j][3] = 0.f;
    mma_abt<D>(pacc, ow, Vs, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[j][e] = sacc[j][e] * (pacc[j][e] - del_r[e >> 1]) * p.scale;
    // dQ += bf16(dS) K
    mma_pv<D, kNT>(dq, sacc, Ks, 0, g, t);
  }

  __nv_bfloat16* dqg = reinterpret_cast<__nv_bfloat16*>(p.dq)
                       + b * p.st[kDQ][0] + h * p.st[kDQ][1];
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < p.Sq)
      *reinterpret_cast<uint32_t*>(dqg + row_a * p.st[kDQ][2] + col) =
          pack_bf16(dq[n][0], dq[n][1]);
    if (row_b < p.Sq)
      *reinterpret_cast<uint32_t*>(dqg + row_b * p.st[kDQ][2] + col) =
          pack_bf16(dq[n][2], dq[n][3]);
  }
}

// ---------------------------------------------------------------------
// f32 FMA path
// ---------------------------------------------------------------------

constexpr int kRowsF = 8;               // rows per warp
constexpr int kBF = kWarps * kRowsF;    // 32 rows per block
constexpr int kLaneF = 32;              // the other side's tile: one per lane

// copy `rows` rows of D floats into a shared tile of row stride `ld`
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* src,
                                              long long row_stride, int row0,
                                              int rows, int limit) {
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * ld + d] = (row0 + r < limit)
                          ? src[(long long)(row0 + r) * row_stride + d] : 0.f;
  }
}

// dK/dV: 8 keys per warp (32 per block); lane = query for the scores,
// lane = output column for the accumulation
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);     // [kBF][D]
  float* Vs = Ks + kBF * D;                           // [kBF][D]
  float* Qs = Vs + kBF * D;                           // [kLaneF][D+1]
  float* Os = Qs + kLaneF * (D + 1);                  // dO [kLaneF][D+1]
  float* Pw = Os + kLaneF * (D + 1);                  // [kWarps][8][32]
  float* Sw = Pw + kWarps * kRowsF * kLaneF;          // [kWarps][8][32]
  float* Ls = Sw + kWarps * kRowsF * kLaneF;          // [kLaneF]
  float* Dl = Ls + kLaneF;                            // [kLaneF]

  const int k0 = blockIdx.x * kBF;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int R = p.H / p.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile_f32<D>(Ks, D, reinterpret_cast<const float*>(p.k)
                              + b * p.st[kK][0] + hk * p.st[kK][1],
                   p.st[kK][2], k0, kBF, p.Sk);
  load_tile_f32<D>(Vs, D, reinterpret_cast<const float*>(p.v)
                              + b * p.st[kV][0] + hk * p.st[kV][1],
                   p.st[kV][2], k0, kBF, p.Sk);

  constexpr int kCols = D / 32;
  float dk[kRowsF][kCols], dv[kRowsF][kCols];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[r][c] = dv[r][c] = 0.f;
  const int key0 = k0 + warp * kRowsF;
  const float* kr = Ks + warp * kRowsF * D;
  const float* vr = Vs + warp * kRowsF * D;
  float* pw = Pw + warp * kRowsF * kLaneF;
  float* sw = Sw + warp * kRowsF * kLaneF;
  const int qt0 = p.causal ? k0 / kLaneF : 0;
  const int n_qt = (p.Sq + kLaneF - 1) / kLaneF;

  for (int rh = 0; rh < R; ++rh) {
    const int h = hk * R + rh;
    const float* qg = reinterpret_cast<const float*>(p.q)
                      + b * p.st[kQ][0] + h * p.st[kQ][1];
    const float* og = reinterpret_cast<const float*>(p.dout)
                      + b * p.st[kDO][0] + h * p.st[kDO][1];
    const float* lg = p.lse + ((long long)b * p.H + h) * p.Sq;
    const float* dg = p.delta + ((long long)b * p.H + h) * p.Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kLaneF;
      __syncthreads();
      load_tile_f32<D>(Qs, D + 1, qg, p.st[kQ][2], q0, kLaneF, p.Sq);
      load_tile_f32<D>(Os, D + 1, og, p.st[kDO][2], q0, kLaneF, p.Sq);
      if (threadIdx.x < kLaneF) {
        const bool in = q0 + threadIdx.x < p.Sq;
        Ls[threadIdx.x] = in ? lg[q0 + threadIdx.x] : 0.f;
        Dl[threadIdx.x] = in ? dg[q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      float s[kRowsF], dp[kRowsF];
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) s[r] = dp[r] = 0.f;
      const float* qrow = Qs + lane * (D + 1);
      const float* orow = Os + lane * (D + 1);
      for (int d = 0; d < D; ++d) {
        const float qv = qrow[d], ov = orow[d];
#pragma unroll
        for (int r = 0; r < kRowsF; ++r) {
          s[r] = fmaf(kr[r * D + d], qv, s[r]);
          dp[r] = fmaf(vr[r * D + d], ov, dp[r]);
        }
      }
      const int qp = q0 + lane;
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) {
        const int kp = key0 + r;
        const bool live = qp < p.Sq && kp < p.Sk && !(p.causal && kp > qp);
        const float pe = live ? expf(s[r] * p.scale - Ls[lane]) : 0.f;
        pw[r * kLaneF + lane] = pe;
        sw[r * kLaneF + lane] = pe * (dp[r] - Dl[lane]) * p.scale;
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        for (int n = 0; n < kLaneF; ++n) {
          const float ov = Os[n * (D + 1) + lane + 32 * c];
          const float qv = Qs[n * (D + 1) + lane + 32 * c];
#pragma unroll
          for (int r = 0; r < kRowsF; ++r) {
            dv[r][c] = fmaf(pw[r * kLaneF + n], ov, dv[r][c]);
            dk[r][c] = fmaf(sw[r * kLaneF + n], qv, dk[r][c]);
          }
        }
      }
      __syncwarp();
    }
  }

  float* dkg = reinterpret_cast<float*>(p.dk) + b * p.st[kDK][0]
               + hk * p.st[kDK][1];
  float* dvg = reinterpret_cast<float*>(p.dv) + b * p.st[kDV][0]
               + hk * p.st[kDV][1];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const int kp = key0 + r;
    if (kp >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dkg[(long long)kp * p.st[kDK][2] + lane + 32 * c] = dk[r][c];
      dvg[(long long)kp * p.st[kDV][2] + lane + 32 * c] = dv[r][c];
    }
  }
}

// dQ: 8 query rows per warp (32 per block); lane = key for the scores,
// lane = output column for the accumulation
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);     // [kBF][D]
  float* Os = Qs + kBF * D;                           // dO [kBF][D]
  float* Ks = Os + kBF * D;                           // [kLaneF][D+1]
  float* Vs = Ks + kLaneF * (D + 1);                  // [kLaneF][D+1]
  float* Sw = Vs + kLaneF * (D + 1);                  // [kWarps][8][32]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * kBF;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile_f32<D>(Qs, D, reinterpret_cast<const float*>(p.q)
                              + b * p.st[kQ][0] + h * p.st[kQ][1],
                   p.st[kQ][2], q0, kBF, p.Sq);
  load_tile_f32<D>(Os, D, reinterpret_cast<const float*>(p.dout)
                              + b * p.st[kDO][0] + h * p.st[kDO][1],
                   p.st[kDO][2], q0, kBF, p.Sq);
  const float* kg = reinterpret_cast<const float*>(p.k) + b * p.st[kK][0]
                    + hk * p.st[kK][1];
  const float* vg = reinterpret_cast<const float*>(p.v) + b * p.st[kV][0]
                    + hk * p.st[kV][1];
  const int row0 = q0 + warp * kRowsF;
  const float* lg = p.lse + ((long long)b * p.H + h) * p.Sq;
  const float* dg = p.delta + ((long long)b * p.H + h) * p.Sq;
  float lse_r[kRowsF], del_r[kRowsF];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const bool in = row0 + r < p.Sq;
    lse_r[r] = in ? lg[row0 + r] : 0.f;
    del_r[r] = in ? dg[row0 + r] : 0.f;
  }

  constexpr int kCols = D / 32;
  float dq[kRowsF][kCols];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[r][c] = 0.f;
  const int kv_end = p.causal ? min(p.Sk, q0 + kBF) : p.Sk;
  const int n_tiles = (kv_end + kLaneF - 1) / kLaneF;
  const float* qr = Qs + warp * kRowsF * D;
  const float* orr = Os + warp * kRowsF * D;
  float* sw = Sw + warp * kRowsF * kLaneF;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kLaneF;
    __syncthreads();
    load_tile_f32<D>(Ks, D + 1, kg, p.st[kK][2], k0, kLaneF, p.Sk);
    load_tile_f32<D>(Vs, D + 1, vg, p.st[kV][2], k0, kLaneF, p.Sk);
    __syncthreads();

    float s[kRowsF], dp[kRowsF];
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) s[r] = dp[r] = 0.f;
    const float* krow = Ks + lane * (D + 1);
    const float* vrow = Vs + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kv = krow[d], vv = vrow[d];
#pragma unroll
      for (int r = 0; r < kRowsF; ++r) {
        s[r] = fmaf(qr[r * D + d], kv, s[r]);
        dp[r] = fmaf(orr[r * D + d], vv, dp[r]);
      }
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsF; ++r) {
      const int qp = row0 + r;
      const bool live = qp < p.Sq && kp < p.Sk && !(p.causal && kp > qp);
      const float pe = live ? expf(s[r] * p.scale - lse_r[r]) : 0.f;
      sw[r * kLaneF + lane] = pe * (dp[r] - del_r[r]) * p.scale;
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      for (int n = 0; n < kLaneF; ++n) {
        const float kv = Ks[n * (D + 1) + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kRowsF; ++r)
          dq[r][c] = fmaf(sw[r * kLaneF + n], kv, dq[r][c]);
      }
    }
    __syncwarp();
  }

  float* dqg = reinterpret_cast<float*>(p.dq) + b * p.st[kDQ][0]
               + h * p.st[kDQ][1];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) {
    const int row = row0 + r;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      dqg[(long long)row * p.st[kDQ][2] + lane + 32 * c] = dq[r][c];
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
cudaError_t run_dkv(const Params& p, int B, int is_bf16, cudaStream_t s) {
  if (is_bf16) {
    constexpr int CS = D > 128 ? 2 : 1;
    constexpr int BK = 16 * kWarps / CS;
    const size_t smem = (size_t)(2 * BK + 2 * kBQ) * (D + kPad)
                            * sizeof(__nv_bfloat16)
                        + 2 * kBQ * sizeof(float);
    dim3 grid((p.Sk + BK - 1) / BK, p.Hkv, B);
    return launch(flash_bwd_dkv_bf16<D, CS>, grid, smem, s, p);
  }
  const size_t smem = (size_t)(2 * kBF * D + 2 * kLaneF * (D + 1)
                               + 2 * kWarps * kRowsF * kLaneF + 2 * kLaneF)
                      * sizeof(float);
  dim3 grid((p.Sk + kBF - 1) / kBF, p.Hkv, B);
  return launch(flash_bwd_dkv_f32<D>, grid, smem, s, p);
}

template <int D>
cudaError_t run_dq(const Params& p, int B, int is_bf16, cudaStream_t s) {
  if (is_bf16) {
    const size_t smem = (size_t)(2 * kBQ + 2 * 64) * (D + kPad)
                        * sizeof(__nv_bfloat16);
    dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
    return launch(flash_bwd_dq_bf16<D>, grid, smem, s, p);
  }
  const size_t smem = (size_t)(2 * kBF * D + 2 * kLaneF * (D + 1)
                               + kWarps * kRowsF * kLaneF) * sizeof(float);
  dim3 grid((p.Sq + kBF - 1) / kBF, p.H, B);
  return launch(flash_bwd_dq_f32<D>, grid, smem, s, p);
}

bool make_params(Params* p, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, void* dk, void* dv, int B, int H, int Hkv,
                 int Sq, int Sk, const long long* strides, int causal,
                 float scale) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return false;
  p->q = q;
  p->k = k;
  p->v = v;
  p->dout = dout;
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
  p->dq = dq;
  p->dk = dk;
  p->dv = dv;
  p->H = H;
  p->Hkv = Hkv;
  p->Sq = Sq;
  p->Sk = Sk;
  for (int i = 0; i < kNumT; ++i)
    for (int j = 0; j < 3; ++j) p->st[i][j] = strides[3 * i + j];
  p->causal = causal;
  p->scale = scale;
  return true;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q/dout: (B, H, Sq, D), k/v: (B, Hkv, Sk, D) views with unit stride on
// D; dk/dv outputs shaped like k/v.  lse/delta: contiguous (B, H, Sq) f32.
// strides: 21 element strides, (batch, head, seq) of q, k, v, dout, dq,
// dk, dv in that order (the dq entries are unused here).  Returns the
// CUDA error of the launch (0 on success).
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int H, int Hkv, int Sq, int Sk, int D,
                            const long long* strides, int causal,
                            float scale, int is_bf16, void* stream) {
  Params p;
  if (!make_params(&p, q, k, v, dout, lse, delta, nullptr, dk, dv, B, H,
                   Hkv, Sq, Sk, strides, causal, scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)run_dkv<64>(p, B, is_bf16, s);
    case 128: return (int)run_dkv<128>(p, B, is_bf16, s);
    case 256: return (int)run_dkv<256>(p, B, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As above; dq output shaped like q (the dk/dv stride entries are unused).
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int B, int H,
                           int Hkv, int Sq, int Sk, int D,
                           const long long* strides, int causal, float scale,
                           int is_bf16, void* stream) {
  Params p;
  if (!make_params(&p, q, k, v, dout, lse, delta, dq, nullptr, nullptr, B,
                   H, Hkv, Sq, Sk, strides, causal, scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)run_dq<64>(p, B, is_bf16, s);
    case 128: return (int)run_dq<128>(p, B, is_bf16, s);
    case 256: return (int)run_dq<256>(p, B, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

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
// (query, key) pair against 6 and 5 rows of S*D elements moved per head,
// about 1000 flops per byte -- far above the H100's ~295 bf16 flops per
// byte, so both are bound by tensor-core operations, not memory.  Only
// wgmma reaches the card's 989 TFLOP/s.  Inside a block the limit is
// registers: a consumer thread holds dK and dV (64 f32 each at 64 keys x
// 128 columns a warpgroup), or dQ, for its whole work item, plus the 32
// f32 each of S^T and dP^T (S and dP) at 64-row streamed tiles.
//
// What the design does about it, on the bf16 head_dim-128 route
// (`flash_bwd_sm90<true>` for dK/dV, `<false>` for dQ: one template, the
// route of training):
// - a work item keeps 128 "resident" rows in shared memory -- K and V of
//   128 keys (dK/dV) or Q and dO of 128 query rows (dQ), 32 KB a tile --
//   one consumer warpgroup a 64-row half, and streams 64-row tiles of
//   the other pair (Q and dO with their LSE and delta rows; K and V)
//   through a 2-stage ring.  Under grouped-query attention a dK/dV item
//   streams the query tiles of every head of its group;
// - three warpgroups: a producer (setmaxnreg.dec to 40) whose warp 0
//   loads the LSE (times log2 e, once a row) and delta rows and whose
//   lane 0 issues every TMA load, and two consumer warpgroups
//   (setmaxnreg.inc to 232); full and empty mbarriers for the ring and
//   for two resident buffers, so the next item's resident tiles load
//   under the current item's last streamed tiles.  The tensor maps are
//   4-D (D, S, H, B) with the caller's byte strides, so the model's
//   (B, S, H, D) views and autograd's dO need no copy; TMA zero-fills
//   rows past a ragged end; tiles past the causal diagonal are never
//   loaded, and the mask runs only on diagonal and ragged tiles;
// - every product is a wgmma: S^T = K.Q^T and dP^T = V.dO^T (dQ: S =
//   Q.K^T, dP = dO.V^T) are m64n64k16 with both operands in shared
//   memory; dV += P^T.dO and dK += dS^T.Q (dQ += dS.K) are m64n128k16
//   with P and dS packed to bf16 in registers as the A operand (the
//   accumulator layout is the A layout) and the streamed tile read
//   MN-major (the transpose bit).  P is one FFMA and one ex2 a score
//   with scale * log2(e) folded in, against the saved LSE;
// - the two consumer warpgroups ping-pong (named barriers): they take
//   turns to issue their products, so one warpgroup's exponentials and
//   dS run under the other's products;
// - persistent blocks, at most one per SM, walk the items in a snake
//   order, heaviest causal items first (low key tiles for dK/dV, high
//   query tiles for dQ);
// - the epilogue writes the accumulators in bf16 over the warpgroup's
//   own rows of the resident tiles (every wgmma that read them has
//   retired) and stores them with TMA, which clips rows past the end.
// No atomics: the two kernels write disjoint outputs and every sum runs
// in a fixed order, so a rerun is bitwise equal.
// ptxas -v (nvcc 12.9, sm_90a), both entries: 168 registers (the count
// at entry, 65,536 / 384), 0 bytes of spills; 199,744 bytes of dynamic
// shared memory.  The split of registers is tight (128 x producer +
// 256 x consumer <= 168 x 384): at 24 / 240 the producer spills; at
// 40 / 232 dK/dV's consumer fits only if P and dS are packed after both
// are formed (no packed operand in flight while dS is computed); every
// register-A wgmma needs its own wgmma.fence (else ptxas injects one).
//
// The other routes keep the first design: bf16 at head_dim 64 and 256 on
// mma.sync m16n8k16 (operands staged synchronously through padded
// shared memory, P^T and dS^T re-packed in registers, one block per
// 64-key or 64-query tile), and f32 on a plain FMA kernel (the tensor
// cores have no exact f32 product).  Grids: dK/dV (key tiles, Hkv, B),
// one block of 4 warps per 64-key tile (bf16, D = 64; at D = 256 two
// warps share a 16-key row group and split the output columns, so a
// block holds 32 keys) or 32-key tile (f32); dQ (query tiles, H, B), one
// block per 64-row (bf16) or 32-row (f32) query tile, heavy (late) tiles
// first.
// Numerics follow the Pallas kernels: s = (q.k)*scale in f32, masked
// pairs have p = 0, p = exp(s - lse), dp = dO.v in f32,
// dS = p * (dp - delta) * scale, with P and dS rounded to bf16 before
// their products on the bf16 path, accumulations in f32, outputs cast to
// the input dtype once.  The causal mask is top-left aligned (query i
// sees keys 0..i).  Ragged sequence ends are masked here; no length needs
// to divide the tiles.  delta = rowsum(dO * O) comes from the caller.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>

#include "sm90.cuh"

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
    if constexpr (D == 128) {
      return cudaErrorInvalidValue;   // the sm90 route's
    } else {
      constexpr int CS = D > 128 ? 2 : 1;
      constexpr int BK = 16 * kWarps / CS;
      const size_t smem = (size_t)(2 * BK + 2 * kBQ) * (D + kPad)
                              * sizeof(__nv_bfloat16)
                          + 2 * kBQ * sizeof(float);
      dim3 grid((p.Sk + BK - 1) / BK, p.Hkv, B);
      return launch(flash_bwd_dkv_bf16<D, CS>, grid, smem, s, p);
    }
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
    if constexpr (D == 128) {
      return cudaErrorInvalidValue;   // the sm90 route's
    } else {
      const size_t smem = (size_t)(2 * kBQ + 2 * 64) * (D + kPad)
                          * sizeof(__nv_bfloat16);
      dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
      return launch(flash_bwd_dq_bf16<D>, grid, smem, s, p);
    }
  }
  const size_t smem = (size_t)(2 * kBF * D + 2 * kLaneF * (D + 1)
                               + kWarps * kRowsF * kLaneF) * sizeof(float);
  dim3 grid((p.Sq + kBF - 1) / kBF, p.H, B);
  return launch(flash_bwd_dq_f32<D>, grid, smem, s, p);
}

// ---------------------------------------------------------------------
// bf16 head_dim-128 route for sm_90a: TMA, mbarriers, wgmma
// ---------------------------------------------------------------------

namespace sm90 {

// Both kernels are one template.  A work item holds kRes rows of a
// "resident" pair of tiles in shared memory (dK/dV: K and V of 128 keys;
// dQ: Q and dO of 128 query rows), one consumer warpgroup a 64-row half,
// and streams kStr-row tiles of the other pair (dK/dV: Q and dO; dQ: K
// and V) through a kStages ring.  Per streamed tile a warpgroup computes
//   X = A0 B0^T, Y = A1 B1^T      (wgmma m64n64k16, both in shared memory)
// which are S^T, dP^T (dK/dV) or S, dP (dQ); then P from X and the saved
// LSE, dS = P (Y - delta) scale, and
//   acc0 += bf16(dS) B0 [dK or dQ],  acc1 += bf16(P) B1 [dV, dK/dV only]
// (wgmma m64n128k16, A from registers, B0/B1 MN-major).
constexpr int kRes = 128;          // resident rows per work item
constexpr int kStr = 64;           // streamed rows per tile
constexpr int kStages = 2;         // streamed ring depth
constexpr int kThreads = 384;      // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kResPanel = kRes * 128;    // one 64-column panel: 16 KB
constexpr int kResTile = 2 * kResPanel;  // 128 rows x 128 columns
constexpr int kStrPanel = kStr * 128;    // 8 KB
constexpr int kStrTile = 2 * kStrPanel;  // 64 rows x 128 columns
constexpr int kStatBytes = 2048;         // LSE * log2(e) and delta rows
constexpr int kSmemBytes = 1024                       // alignment slack
                           + 2 * 2 * kResTile         // resident, 2 buffers
                           + kStages * 2 * kStrTile   // streamed ring
                           + kStatBytes
                           + 8 * (4 + 2 * kStages);   // mbarriers
static_assert(kSmemBytes <= 232448, "a block's shared memory");

struct BwdParams {
  const float* lse;     // (B, H, Sq) contiguous
  const float* delta;   // (B, H, Sq) contiguous
  int B, H, Hkv, Sq, Sk;
  int n_res;            // resident tiles per (head, batch)
  int n_qt;             // streamed query tiles per head (dK/dV)
  int causal;
  float scale;
  float scale_log2;     // scale * log2(e), for the exponentials
};

// the tensor maps: q, k, v, dO, then the outputs (dK, dV or dQ)
enum { kMapQ = 0, kMapK, kMapV, kMapDO, kMapOut0, kMapOut1, kNumMaps };
struct Maps {
  CUtensorMap m[kNumMaps];
};

// A work item: resident rows r0.. of head hh (the kv head for dK/dV),
// batch b, and its n streamed tiles.  dK/dV streams the query tiles
// qt0.. of each of the R heads of its group (nq a head).
struct Item {
  int r0, hh, b, qt0, nq, n;
};

// Heaviest causal items first (low key tiles for dK/dV, high query tiles
// for dQ); block c takes items c, 2G - 1 - c, 2G + c, ... of the G
// blocks' rounds (a snake).  Returns false past the last item.
template <bool kDKV>
__device__ __forceinline__ bool item_of(const BwdParams& p, int round,
                                        Item& it) {
  const int G = gridDim.x, c = blockIdx.x;
  const int i = round * G + ((round & 1) ? G - 1 - c : c);
  const int heads = kDKV ? p.Hkv : p.H;
  const int hb = heads * p.B;
  if (i >= p.n_res * hb) return false;
  it.r0 = (kDKV ? i / hb : p.n_res - 1 - i / hb) * kRes;
  it.hh = (i % hb) % heads;
  it.b = (i % hb) / heads;
  if (kDKV) {
    it.qt0 = p.causal ? min(it.r0 / kStr, p.n_qt) : 0;
    it.nq = p.n_qt - it.qt0;
    it.n = (p.H / p.Hkv) * it.nq;
  } else {
    const int kv_end = p.causal ? min(p.Sk, it.r0 + kRes) : p.Sk;
    it.qt0 = 0;
    it.nq = 0;
    it.n = (kv_end + kStr - 1) / kStr;
  }
  return true;
}

// X = A.B^T for this warpgroup's 64 resident rows against a streamed
// tile, 8 steps of 16 over head_dim (the first overwrites X)
__device__ __forceinline__ void issue_x(float (&x)[32], uint64_t da,
                                        uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint64_t oa = ((kk / 4) * kResPanel + (kk % 4) * 32) >> 4;
    const uint64_t ob = ((kk / 4) * kStrPanel + (kk % 4) * 32) >> 4;
    wgmma_ss_n64(x, da + oa, db + ob, kk > 0);
  }
}

// acc += A.B, A the packed bf16 registers of a 64 x 64 accumulator, B a
// streamed tile read MN-major: 4 steps of 16 streamed rows
__device__ __forceinline__ void issue_acc(float (&acc)[64],
                                          const uint32_t (&a)[16],
                                          uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < kStr / 16; ++kk)
    wgmma_rs(acc, &a[4 * kk], db + ((kk * 16 * 128) >> 4));
}

__device__ __forceinline__ void pack16(const float (&x)[32],
                                       uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16x2(x[2 * i], x[2 * i + 1]);
}

// A warpgroup's 64 x 128 accumulator as bf16 into its 64 rows of a
// resident tile (two 64-column panels, 128-byte swizzle: the layout the
// store map reads)
__device__ __forceinline__ void stage_acc(const float (&acc)[64],
                                          uint32_t dst, int lr_a, int lr_b,
                                          int t) {
#pragma unroll
  for (int r = 0; r < 64; r += 2) {
    const int col = 8 * (r / 4) + 2 * t;
    const int lr = (r & 2) ? lr_b : lr_a;
    const int chunk = (col % kPanel) / 8;
    const uint32_t addr = dst + (col / kPanel) * kResPanel + lr * 128
                          + ((chunk ^ (lr % 8)) * 16) + (col % 8) * 2;
    asm volatile("st.shared.b32 [%0], %1;\n"
                 :: "r"(addr), "r"(pack_bf16x2(acc[r], acc[r + 1]))
                 : "memory");
  }
}

template <bool kDKV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_sm90(const __grid_constant__ Maps maps, const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  // swizzled tiles need 1024-byte alignment
  const uint32_t sRes = (smem_u32(smem_bwd) + 1023u) & ~1023u;
  const uint32_t sStr = sRes + 2 * 2 * kResTile;     // [stage][B0, B1]
  const uint32_t sStat = sStr + kStages * 2 * kStrTile;
  const uint32_t bar_rf = sStat + kStatBytes;        // resident full [2]
  const uint32_t bar_re = bar_rf + 16;               // resident empty [2]
  const uint32_t bar_sf = bar_re + 16;               // streamed full [stage]
  const uint32_t bar_se = bar_sf + 8 * kStages;      // streamed empty
  // dK/dV: stage s holds its 64 query rows' LSE * log2(e) at
  // stat[128 s], delta at stat[128 s + 64]; dQ: resident buffer rb holds
  // its 128 rows' at stat[256 rb], delta at stat[256 rb + 128]
  float* stat = reinterpret_cast<float*>(smem_bwd
                                         + (sStat - smem_u32(smem_bwd)));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int R = p.H / p.Hkv;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      // dQ's resident rows also wait for the producer warp's stats
      mbar_init(bar_rf + 8 * i, kDKV ? 1 : 2);
      mbar_init(bar_re + 8 * i, 2);   // one store per consumer warpgroup
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_sf + 8 * s, kDKV ? 2 : 1);
      mbar_init(bar_se + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: warp 0's lane 0 issues every TMA load; the warp
    // loads the LSE and delta rows beside them ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0) {
      const CUtensorMap* a0 = &maps.m[kDKV ? kMapK : kMapQ];
      const CUtensorMap* a1 = &maps.m[kDKV ? kMapV : kMapDO];
      const CUtensorMap* b0 = &maps.m[kDKV ? kMapQ : kMapK];
      const CUtensorMap* b1 = &maps.m[kDKV ? kMapDO : kMapV];
      int str_it = 0;   // streamed tiles loaded so far: the ring position
      Item it;
      for (int round = 0; item_of<kDKV>(p, round, it); ++round) {
        const int rb = round & 1;
        const uint32_t dst = sRes + rb * 2 * kResTile;
        const uint32_t full = bar_rf + 8 * rb;
        // the buffer's item of two rounds ago stored (passes at once at
        // first)
        mbar_wait(bar_re + 8 * rb, ((round >> 1) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full, 2 * kResTile);
          tma_load(dst, a0, full, 0, it.r0, it.hh, it.b);
          tma_load(dst + kResPanel, a0, full, kPanel, it.r0, it.hh, it.b);
          tma_load(dst + kResTile, a1, full, 0, it.r0, it.hh, it.b);
          tma_load(dst + kResTile + kResPanel, a1, full, kPanel, it.r0,
                   it.hh, it.b);
        }
        if constexpr (!kDKV) {
          float* st = stat + rb * 2 * kRes;
          const long long off = ((long long)it.b * p.H + it.hh) * p.Sq;
          for (int i = lane; i < kRes; i += 32) {
            const bool in = it.r0 + i < p.Sq;
            st[i] = in ? p.lse[off + it.r0 + i] * kLog2e : 0.f;
            st[kRes + i] = in ? p.delta[off + it.r0 + i] : 0.f;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(full);
        }
        for (int j = 0; j < it.n; ++j, ++str_it) {
          const int s = str_it % kStages;
          const uint32_t sd = sStr + s * 2 * kStrTile;
          const uint32_t sfull = bar_sf + 8 * s;
          // dK/dV: query tile of head hh * R + j / nq; dQ: key tile j
          const int h = kDKV ? it.hh * R + j / it.nq : it.hh / R;
          const int s0 = kDKV ? (it.qt0 + j % it.nq) * kStr : j * kStr;
          mbar_wait(bar_se + 8 * s, ((str_it / kStages) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(sfull, 2 * kStrTile);
            tma_load(sd, b0, sfull, 0, s0, h, it.b);
            tma_load(sd + kStrPanel, b0, sfull, kPanel, s0, h, it.b);
            tma_load(sd + kStrTile, b1, sfull, 0, s0, h, it.b);
            tma_load(sd + kStrTile + kStrPanel, b1, sfull, kPanel, s0, h,
                     it.b);
          }
          if constexpr (kDKV) {
            float* st = stat + s * 2 * kStr;
            const long long off = ((long long)it.b * p.H + h) * p.Sq;
            for (int i = lane; i < kStr; i += 32) {
              const bool in = s0 + i < p.Sq;
              st[i] = in ? p.lse[off + s0 + i] * kLog2e : 0.f;
              st[kStr + i] = in ? p.delta[off + s0 + i] : 0.f;
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(sfull);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 resident rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = warp / 4 - 1;          // consumer warpgroup 0 or 1
    const int wl = warp % 4;              // warp within it: 16 rows
    const int g = lane / 4;               // accumulator row group
    const int t = lane % 4;               // thread in the quad
    const int tid = threadIdx.x % 128;
    const int lr_a = wl * 16 + g, lr_b = lr_a + 8;   // rows in the half
    const float c = p.scale_log2;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // Ping-pong: the tensor cores alternate between the two warpgroups,
    // a turn for each batch of products (S and dP; then the
    // accumulators), so that one warpgroup's exponentials and dS run
    // under the other's products.  A warpgroup waits for its turn (named
    // barrier 3 + cw) and hands it over (3 + other) once its products
    // are issued.  Warpgroup 1 gives warpgroup 0 the first turn and
    // skips its own last hand-over, so every barrier sees as many
    // arrivals as waits.  (A last turn taken by warpgroup 0 after its
    // loop instead makes ptxas spill hundreds of bytes.)
    auto turn_wait = [&]() { named_sync<256>(3 + cw); };
    auto turn_pass = [&]() { named_arrive<256>(3 + (cw ^ 1)); };
    if (cw == 1) turn_pass();
    // whether an item after `round` streams a tile (both warpgroups walk
    // the same items)
    auto more_after = [&](int round) {
      Item nx;
      for (int r = round + 1; item_of<kDKV>(p, r, nx); ++r)
        if (nx.n > 0) return true;
      return false;
    };

    int str_it = 0;
    Item it;
    bool more = item_of<kDKV>(p, 0, it);
    for (int round = 0; more; ++round) {
      const int rb = round & 1;
      // this warpgroup's 64 rows of the resident A0 and A1 tiles
      const uint32_t ra0 = sRes + rb * 2 * kResTile + cw * 64 * 128;
      const uint32_t ra1 = ra0 + kResTile;
      const uint64_t da0 = sw128_desc(ra0, 16, 1024);
      const uint64_t da1 = sw128_desc(ra1, 16, 1024);
      const int w0 = it.r0 + cw * 64;     // its first resident row
      mbar_wait(bar_rf + 8 * rb, (round >> 1) & 1);
      float lse_a = 0.f, lse_b = 0.f, del_a = 0.f, del_b = 0.f;
      if constexpr (!kDKV) {
        const float* st = stat + rb * 2 * kRes + cw * 64;
        lse_a = st[lr_a];
        lse_b = st[lr_b];
        del_a = st[kRes + lr_a];
        del_b = st[kRes + lr_b];
      }
      float acc0[64], acc1[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) acc0[r] = acc1[r] = 0.f;

      for (int j = 0; j < it.n; ++j, ++str_it) {
        const int s = str_it % kStages;
        const uint32_t sb0 = sStr + s * 2 * kStrTile;
        const uint32_t sb1 = sb0 + kStrTile;
        const int s0 = kDKV ? (it.qt0 + j % it.nq) * kStr : j * kStr;
        const float* st = stat + s * 2 * kStr;   // dK/dV's column stats
        float x[32], y[32];
        uint32_t pa[16], pd[16];
        mbar_wait(bar_sf + 8 * s, (str_it / kStages) & 1);
        turn_wait();
        wgmma_fence();
        issue_x(x, da0, sw128_desc(sb0, 16, 1024));
        wgmma_commit();
        issue_x(y, da1, sw128_desc(sb1, 16, 1024));
        wgmma_commit();
        fence_regs(x);
        fence_regs(y);
        turn_pass();
        wgmma_wait<1>();
        fence_regs(x);

        // P = exp(s * scale - lse) = 2^(x * c - lse * log2 e); masked
        // pairs (causal, ragged ends) only on the tiles that have them.
        // Element r: resident row lr_a (+8 if bit 1 of r), streamed
        // column 8 (r / 4) + 2 t + (r & 1).
#pragma unroll
        for (int c4 = 0; c4 < 8; ++c4) {
          float2 l2 = make_float2(0.f, 0.f);
          if constexpr (kDKV)
            l2 = *reinterpret_cast<const float2*>(st + 8 * c4 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 4 * c4 + e;
            const float l = kDKV ? ((e & 1) ? l2.y : l2.x)
                                 : ((e & 2) ? lse_b : lse_a);
            x[r] = ex2(fmaf(x[r], c, -l));
          }
        }
        const bool mask =
            kDKV ? ((p.causal && w0 + 63 > s0) || s0 + kStr > p.Sq
                    || w0 + 64 > p.Sk)
                 : ((p.causal && s0 + kStr - 1 > w0) || s0 + kStr > p.Sk
                    || w0 + 64 > p.Sq);
        if (mask) {
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            const int row = w0 + ((r & 2) ? lr_b : lr_a);
            const int col = s0 + 8 * (r / 4) + 2 * t + (r & 1);
            const int key = kDKV ? row : col;
            const int query = kDKV ? col : row;
            if (key >= p.Sk || query >= p.Sq || (p.causal && key > query))
              x[r] = 0.f;
          }
        }
        wgmma_wait<0>();
        fence_regs(y);

        // dS = P (dP - delta) scale in y; then P and dS in bf16 as the
        // register A operands (packed only now: no packed operand is in
        // flight while dS is formed, which keeps the consumer within its
        // registers)
#pragma unroll
        for (int c4 = 0; c4 < 8; ++c4) {
          float2 d2 = make_float2(0.f, 0.f);
          if constexpr (kDKV)
            d2 = *reinterpret_cast<const float2*>(st + kStr + 8 * c4 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 4 * c4 + e;
            const float d = kDKV ? ((e & 1) ? d2.y : d2.x)
                                 : ((e & 2) ? del_b : del_a);
            y[r] = x[r] * (y[r] - d) * p.scale;
          }
        }
        if constexpr (kDKV) pack16(x, pa);
        pack16(y, pd);
        // dK += bf16(dS^T) Q and dV += bf16(P^T) dO, or dQ += bf16(dS) K
        turn_wait();
        wgmma_fence();
        issue_acc(acc0, pd, sw128_desc(sb0, kStrPanel, 1024));
        if constexpr (kDKV)
          issue_acc(acc1, pa, sw128_desc(sb1, kStrPanel, 1024));
        wgmma_commit();
        fence_regs(acc0);
        fence_regs(pd);
        if constexpr (kDKV) {
          fence_regs(acc1);
          fence_regs(pa);
        }
        if (cw == 0 || j + 1 < it.n || more_after(round)) turn_pass();
        wgmma_wait<0>();
        fence_regs(acc0);
        fence_regs(pd);
        if constexpr (kDKV) {
          fence_regs(acc1);
          fence_regs(pa);
        }
        release(bar_se + 8 * s);
      }

      // epilogue: the accumulators in bf16 over this warpgroup's own
      // rows of the resident tiles (every wgmma that read them has
      // retired), then TMA stores, which clip rows past the end; the
      // buffer goes back to the producer once the stores have read it
      const Item cur = it;
      more = item_of<kDKV>(p, round + 1, it);
      stage_acc(acc0, ra0, lr_a, lr_b, t);
      if constexpr (kDKV) stage_acc(acc1, ra1, lr_a, lr_b, t);
      // the writes must be visible to the async proxy before TMA reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync<128>(1 + cw);
      if (tid == 0) {
        const CUtensorMap* o0 = &maps.m[kMapOut0];
        tma_store(o0, ra0, 0, w0, cur.hh, cur.b);
        tma_store(o0, ra0 + kResPanel, kPanel, w0, cur.hh, cur.b);
        if constexpr (kDKV) {
          const CUtensorMap* o1 = &maps.m[kMapOut1];
          tma_store(o1, ra1, 0, w0, cur.hh, cur.b);
          tma_store(o1, ra1 + kResPanel, kPanel, w0, cur.hh, cur.b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(bar_re + 8 * rb);
        if (!more) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      }
    }
  }
}

}  // namespace sm90

// the sm90 route's launch: tensor maps from the caller's byte strides,
// the plan checked against the tiles compiled here
template <bool kDKV>
int run_sm90(const void* const* ptrs, const void* lse, const void* delta,
             int B, int H, int Hkv, int Sq, int Sk,
             const long long* tma_strides, const int* plan, int causal,
             float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_res = ((kDKV ? Sk : Sq) + sm90::kRes - 1) / sm90::kRes;
  const int items = n_res * (kDKV ? Hkv : H) * B;
  // plan: resident rows, streamed rows, stages, threads, shared memory,
  // and the grid (blocks, 1, 1): at most one block per work item
  if (plan[0] != sm90::kRes || plan[1] != sm90::kStr
      || plan[2] != sm90::kStages || plan[3] != sm90::kThreads
      || plan[4] != sm90::kSmemBytes || plan[5] < 1 || plan[5] > items
      || plan[6] != 1 || plan[7] != 1)
    return kErrPlan;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  // q, k, v, dO, then dK, dV (dK/dV) or dQ: sequence, heads and box rows
  // (resident tiles 128, streamed tiles and stores 64)
  const int n_maps = kDKV ? 6 : 5;
  const int seqs[6] = {Sq, Sk, Sk, Sq, kDKV ? Sk : Sq, Sk};
  const int heads[6] = {H, Hkv, Hkv, H, kDKV ? Hkv : H, Hkv};
  const int res = sm90::kRes, str = sm90::kStr;
  const int rows[6] = {kDKV ? str : res, kDKV ? res : str,
                       kDKV ? res : str, kDKV ? str : res, str, str};
  sm90::Maps maps{};
  for (int i = 0; i < n_maps; ++i) {
    const int rc = encode_map(fn, &maps.m[i], ptrs[i], seqs[i], heads[i], B,
                              tma_strides + 3 * i, rows[i]);
    if (rc != 0) return kErrEncode + rc * 16 + i;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      sm90::flash_bwd_sm90<kDKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sm90::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const sm90::BwdParams p{static_cast<const float*>(lse),
                          static_cast<const float*>(delta), B, H, Hkv, Sq,
                          Sk, n_res, (Sq + sm90::kStr - 1) / sm90::kStr,
                          causal, scale, scale * sm90::kLog2e};
  sm90::flash_bwd_sm90<kDKV><<<plan[5], sm90::kThreads, sm90::kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(maps, p);
  return (int)cudaGetLastError();
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
  static char buf[160];
  if (err == kErrPlan)
    return "the launch plan names tiles this library was not built with";
  if (err == kErrNoEncode)
    return "cuTensorMapEncodeTiled not found through the CUDA runtime";
  if (err >= kErrEncode) {
    static const char* names[6] = {"q", "k", "v", "dO", "dK or dQ", "dV"};
    const int which = (err - kErrEncode) % 16;
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed for %s "
             "(CUresult %d)", which < 6 ? names[which] : "?",
             (err - kErrEncode) / 16);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}

// The mma.sync and FMA routes (bf16 at head_dim 128 is the sm90
// route's): q/dout: (B, H, Sq, D), k/v: (B, Hkv, Sk, D) views with unit
// stride on D; dk/dv outputs shaped like k/v.  lse/delta: contiguous
// (B, H, Sq) f32.
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

// The sm90 route: bf16, head_dim 128.  q/dout: (B, H, Sq, 128) and k/v:
// (B, Hkv, Sk, 128) views with unit stride on D, 16-byte aligned; dk/dv:
// outputs shaped like k/v, same rules.  `tma_strides`: the byte strides
// (seq, head, batch) of q, k, v, dout, dk and dv, 18 values, multiples of
// 16.  lse/delta: contiguous (B, H, Sq) f32.  `plan`: resident rows,
// streamed rows, stages, threads, shared-memory bytes and the grid
// (blocks, 1, 1) as the Python launch plan computed them.  Returns the
// CUDA error of the launch (0 on success).
int flash_attention_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int B, int H, int Hkv, int Sq, int Sk,
                                 const long long* tma_strides,
                                 const int* plan, int causal, float scale,
                                 void* stream) {
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  return run_sm90<true>(ptrs, lse, delta, B, H, Hkv, Sq, Sk, tma_strides,
                        plan, causal, scale, stream);
}

// As above for dQ (shaped like q); `tma_strides`: 15 values, those of q,
// k, v, dout and dq.
int flash_attention_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Hkv, int Sq, int Sk,
                                const long long* tma_strides,
                                const int* plan, int causal, float scale,
                                void* stream) {
  const void* ptrs[6] = {q, k, v, dout, dq, nullptr};
  return run_sm90<false>(ptrs, lse, delta, B, H, Hkv, Sq, Sk, tma_strides,
                         plan, causal, scale, stream);
}

}  // extern "C"

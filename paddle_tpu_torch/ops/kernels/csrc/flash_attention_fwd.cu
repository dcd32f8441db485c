// Flash attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py:72 `_fwd_kernel`
// (launched by `_pallas_forward`, entry `_fa_impl`): blockwise online-
// softmax attention on (B, H, S, D), causal block skip, optional LSE, an
// optional additive bias row (`:110-114`) and optional dropout of the
// normalised weights (`:119-131`, its mask `_keep_mask` `:53`).
//
// What bounds it on this card: a long prefill does 4*S^2*D*H flops (2
// for S = Q.K^T, 2 for P.V) against 4*S*H*D*2 bytes of Q/K/V/O, about
// 500 flops per byte at S = 2048, D = 64 -- far above the H100's ~295
// bf16 flops per byte, so it is bound by operations, not memory.  Only
// `wgmma` reaches the card's 989 TFLOP/s.  The exponentials (one ex2 a
// score, 16 a clock per SM) take about as long as the products at head
// dim 64 (ERNIE-3.0-base's shape: 0.096 ms against 0.104, PERF.md §6),
// so the CUDA cores' work per score -- one FFMA, one ex2, the running
// max and sum, the bf16 packing -- must overlap the tensor cores'.  With
// dropout the keep mask adds Philox4x32-10 (dropout.cuh), about 12.6
// integer instructions a score on the FMA and ALU pipes in this kernel's
// SASS, which alone bound it above the products.
//
// What the design does about it, on the bf16 routes of both main paths:
// one template, flash_fwd_sm90<D, kBias, kDrop> -- head_dim 128 without
// options (the prefill and the proxy's training; the first Hopper
// kernel, its code unchanged), head_dim 64 without options, with the
// bias row or with dropout (ERNIE-3.0-base pretraining):
// - work items of (128 query rows, head, batch), heaviest causal items
//   first, at most one block per SM, each block walking its items in a
//   snake order; so the next item's Q and K/V loads run under the
//   current item's last tiles and its store;
// - three warpgroups: a producer (registers lowered with setmaxnreg.dec)
//   whose one thread issues every TMA load, and two consumer warpgroups
//   (setmaxnreg.inc) of 64 query rows each;
// - Q (128 x D bf16) is loaded once an item; K and V tiles of 128 keys
//   stream through a ring in shared memory (2 stages at head_dim 128, 4
//   at 64; 2 and 4 time the same at 64, PERF.md §6) with full and empty
//   mbarriers, K and V released separately.  The tensor maps are 4-D (D,
//   S, H, B) with the caller's byte strides: the server's (B, S, H, D)
//   views need no copy, and TMA zero-fills rows past the ragged end.
//   128-byte swizzle, as wgmma's shared-memory descriptors expect (a
//   64-column bf16 panel is one swizzle row); tiles past the causal
//   diagonal are never loaded;
// - S = Q.K^T is wgmma m64n128k16 with both operands in shared memory
//   (D / 16 steps); the online softmax runs on the f32 accumulator in
//   registers (rows reduce over the 4 threads of a quad), one FFMA and
//   one ex2 per score with scale * log2(e) folded in, the mask only on
//   the diagonal tile and the ragged last tile;
// - O += P.V is wgmma m64nDk16 with A from registers: P is packed to
//   bf16 in place (the accumulator layout is the register A layout) and
//   V is read as an MN-major B operand (the transpose bit), so P never
//   touches shared memory; at head_dim 64 O is 32 floats a thread;
// - a warpgroup issues S(j) and P(j-1).V(j-1) together, and the two
//   warpgroups ping-pong (named barriers) so that one's softmax runs
//   under the other's products.  ptxas places the wait for P(j-1).V(j-1)
//   before the softmax's exponentials in every entry; forcing them
//   under it (a branch between them) made every entry slower (PERF.md
//   §6).  A consumer releases a K or V stage as soon as the wgmma that
//   read it retires;
// - the bias row: producer warp 0 stages each K tile's 128 values (f32,
//   times log2 e) beside it in the ring with ordinary loads -- a row
//   shared by the batch has batch stride 0, which a tensor map cannot
//   step -- and arrives on the stage's full barrier; the consumers form
//   S c + bias log2 e (one FFMA) before the mask, as the reference adds
//   the bias to the scaled scores, and release K after the softmax has
//   read the row;
// - dropout: each tile's 4,096 Philox calls (one a 2 x 2 group of
//   scores, keep_groups_mma: rows are queries) are split between the
//   warpgroups.  The producer's 128 threads form the group words of keys
//   64..127 (16 calls each) once the tile's loads are out, write them
//   beside K and arrive on K's full barrier; each consumer thread forms
//   its own word of keys 0..63 (8 calls) once its products are issued,
//   reads the other, and one shuffle with its lane pair gives each word's
//   fragment bits (keep_bits_of_groups).  Philox left to the consumers
//   alone did not overlap their products (their two warps a
//   sub-partition are latency-bound: ptxas schedules it before the wgmma
//   issue, or after the wait), and left to the producer's one warp a
//   sub-partition it was slower still; the split runs on all three
//   (setmaxnreg 56 / 224: other splits spill).  The denominator and the
//   LSE keep the undropped P; kept values are multiplied by f32(1 /
//   f32(1 - p)), not divided (as the backward, at most an f32 ulp apart
//   before the bf16 rounding), and P.V takes them in bf16;
// - the epilogue normalises, stages O through shared memory in the
//   swizzled layout and stores it with one TMA store a 64-column panel
//   and warpgroup (rows past Sq clipped); one thread a row writes the
//   LSE.
// ptxas -v (nvcc 12.9, sm_90a), all four entries: 168 registers (the
// count at entry, 65,536 / 384), 0 bytes of spills; dynamic shared
// memory 197,712 bytes at head_dim 128, 165,008 at 64 (167,056 with the
// bias rows, 169,104 with the mask words).  Registers are what limit
// the design: the in-flight S, O and P fragments take 160 of them at
// head_dim 128 (128 at 64), and ptxas serialises the wgmmas (C7512,
// "insufficient register resources") unless each commit is followed by
// operand fences.
//
// f32, at every head_dim, with or without an option, takes both
// products to the tensor cores as 3xTF32: flash_fwd_tf32x3<D, kBias,
// kDrop>.  A TF32 product keeps 10 of f32's 23 mantissa bits (about 3
// decimal digits, beyond the f32 limit of 1e-4), so each operand x is
// split into hi = rna_tf32(x) and lo = x - hi (read as TF32), and a.b is
// formed as lo_a hi_b + hi_a lo_b + hi_a hi_b with f32 accumulation
// (about 21 bits; lo_a lo_b falls below f32's last bit of the product).
// The FMA kernel it replaces ran at 0.19 of an H100's 67 TFLOP/s of f32
// FMA, held by shared-memory instruction throughput: a K or V load and 8
// broadcast loads for every 8 FMAs.  Three TF32 products at 495 TFLOP/s
// bound the translation encoder's shape (B 8, H 8, S 1,024, D 64) at
// 0.104 ms, against 0.256 for the products on the FMA pipe.  The design:
// - mma.sync m16n8k8: its f32 accumulator has the layout of the bf16
//   route's m16n8k16, so keep_bits_mma gives a fragment's dropout bits
//   unchanged (wgmma takes tf32 only K-major: V would have to be
//   transposed and split in shared memory);
// - blocks of 64 query rows (4 warps of 16) against key tiles of 64 at
//   head_dim 64 (2 blocks an SM) and 32 above (the shared memory), which
//   stream through a 2-stage cp.async ring; rows are padded so that
//   every fragment load is free of bank conflicts;
// - head_dim is permuted within each 16-column chunk, so that a
//   thread's Q and K values of two k-steps are one 16-byte load; Q is
//   split once a block (at head_dim 64 its split fragments stay in
//   registers, above it Q stays in shared memory and is split as read),
//   each K and V value once a tile by the warp that reads it, P in
//   registers;
// - S stays in registers: an n-tile of S (8 keys) is one k-step of P.V
//   with its keys permuted (fragment columns t and t + 4 are keys 2t and
//   2t + 1), so S's accumulator is P's A fragment as it stands, and V's B
//   fragment reads keys 2t and 2t + 1 of column g;
// - the online softmax in log2 units: one FFMA and one ex2 a score (the
//   bias row staged beside each K tile, times log2 e), the row max and
//   sum reduced over the quad, the mask only on the diagonal and ragged
//   tiles; dropout's bits from keep_bits_mma, kept values divided by
//   f32(1 - p) as the reference divides.
//
// The other bf16 routes keep the first design: head_dim 256, and 128
// with an option, on mma.sync m16n8k16 (K/V staged synchronously through
// padded shared memory, P re-packed in registers, 64-row query tiles of
// 4 warps).  Their options run in <D, true> instantiations (the
// option-free ones are the code they were): the bias row in q's dtype, a
// tile's 64 values staged with K and V; dropout from the same keep mask,
// kept values divided by f32(1 - p).
//
// The keep mask is Philox4x32-10 of (seed, b, h, q, k) (dropout.cuh),
// the seed an int64 read from device memory, so the backward and a
// recomputed forward regenerate the same mask on any route.
//
// Numerics follow the Pallas kernel: s = (q.k)*scale in f32 (+ the bias
// row), masked scores -1e30, running max/denominator in f32, on the bf16
// routes probabilities rounded to bf16 for the P.V product (against the
// running max of each key tile: 128 keys on the sm90 route, 64 on the
// mma.sync route), out = acc / max(l, 1e-30), lse = m + log(max(l,
// 1e-30)).
// Ragged sequence ends are masked here; no length needs to divide the
// tiles.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

#include "dropout.cuh"
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
  // the options (the <D, true> kernels only): an additive [B, 1, 1, Sk]
  // bias row in q's dtype (null: none; bias_sb its batch stride), and
  // dropout (drop.seed null: none)
  const void* bias;
  long long bias_sb;
  Dropout drop;
};

// ---------------------------------------------------------------------
// bf16 mma.sync route (head_dim 256, and 128 with an option)
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

// kOpt: the instantiation that takes the bias row and dropout (the
// option-free one keeps the first kernel's code as it was)
template <int D, bool kOpt>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * (D + kPad);
  __nv_bfloat16* Vs = Ks + kBK * (D + kPad);
  float* Bs = reinterpret_cast<float*>(Vs + kBK * (D + kPad));   // bias

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
  const __nv_bfloat16* bg = reinterpret_cast<const __nv_bfloat16*>(p.bias)
                            + b * p.bias_sb;
  PhiloxKey key{0u, 0u};
  if (kOpt && p.drop.seed != nullptr) key = philox_key(p.drop.seed);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // previous tile fully consumed
    load_tile_bf16<D>(Ks, kg, p.k_ss, k0, kBK, p.Sk);
    load_tile_bf16<D>(Vs, vg, p.v_ss, k0, kBK, p.Sk);
    if (kOpt && p.bias != nullptr) {
      for (int i = threadIdx.x; i < kBK; i += kThreads)
        Bs[i] = k0 + i < p.Sk ? __bfloat162float(bg[k0 + i]) : 0.f;
    }
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
        if (kOpt && p.bias != nullptr) s += Bs[j * 8 + 2 * t + (e & 1)];
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
    if (kOpt && p.drop.seed != nullptr) {
      // the denominator keeps the undropped P; P.V takes P * keep / (1-p)
      const uint32_t keep = keep_bits_mma(key, b, h, row_a, k0, g, t, true,
                                          p.drop.thresh);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[j][e] = (keep >> (4 * j + e)) & 1u
                           ? sacc[j][e] / p.drop.keep_p : 0.f;
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
// f32 route: both products on the tensor cores as 3xTF32 (mma.sync)
// ---------------------------------------------------------------------

namespace tf32 {

constexpr int kBQ = 16 * kWarps;   // query rows per block: 16 a warp
constexpr int kStages = 2;         // K/V tiles in flight (cp.async)
constexpr float kLn2 = 0.6931471805599453f;

// The route's tiles at head_dim D.  Keys come in tiles of 64 at head_dim
// 64 and of 32 above it (the ring's shared memory).  At head_dim 64 Q's
// split fragments stay in registers for the whole block; above it Q is
// staged once in shared memory and split as it is read.  Row pitches
// (floats) keep every fragment load free of bank conflicts: K and Q are
// read 16 bytes a thread, rows g and g + 1 of a quarter warp 16 banks
// apart (D + 16); V 4 bytes a thread at keys 2t, 2t + 1 and column g,
// the two keys 8 banks apart (D + 4).
template <int D>
struct Tiles {
  static constexpr int kBK = D == 64 ? 64 : 32;     // keys per tile
  static constexpr int kNT = kBK / 8;               // S's n-tiles
  static constexpr bool kQRegs = D == 64;
  static constexpr int kKPitch = D + 16;
  static constexpr int kVPitch = D + 4;
  static constexpr int kQPitch = D + 16;
  static constexpr int kQFloats = kQRegs ? 0 : kBQ * kQPitch;
  static constexpr int kStageFloats = kBK * (kKPitch + kVPitch);
  // blocks an SM holds: 2 below head_dim 256 (shared memory would take 3
  // at 64, but 3 cap the registers at 168, where the options spill and
  // every entry ran slower: PERF.md section 6), 1 at 256
  static constexpr int kMinBlocks = D == 256 ? 1 : 2;
  // Q (above head_dim 64), the ring's K and V stages and, with the bias
  // row, each stage's kBK values (f32, times log2 e)
  static constexpr int kSmemBytes = 4 * (kQFloats + kStages * kStageFloats);
  static constexpr int kSmemBiasBytes = kSmemBytes + 4 * kStages * kBK;
  static_assert(kSmemBiasBytes <= 232448, "a block's shared memory");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  // `bytes` < 16 fills the rest of the 16 with zeros (0: reads nothing)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest,
// ties away: the bits plus half the last kept bit, the low 13 cleared),
// lo = x - hi exactly, of which the tensor cores read the top 19 bits
// (TF32 truncation).  The add and the mask are two integer instructions;
// cvt.rna.tf32.f32 is no single instruction on sm_90a: ptxas expands
// each into about three (a compare, a select, integer arithmetic), and
// with it for hi and lo the kernel ran 1.28x slower (PERF.md section 6)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_1688(float (&c)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: lo.hi + hi.lo + hi.hi, the small terms first (the
// dropped lo.lo is below f32's last bit of the product)
__device__ __forceinline__ void mma_3x(float (&c)[4], const uint32_t* ah,
                                       const uint32_t* al, uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0,
                                       uint32_t bl1) {
  mma_1688(c, al, bh0, bh1);
  mma_1688(c, ah, bl0, bl1);
  mma_1688(c, ah, bh0, bh1);
}

// A k-step pair's split A fragments of Q from rows g (qa) and g + 8 (qb),
// columns 4t .. 4t + 3 of a 16-column chunk: head_dim is permuted within
// the chunk so that step s's fragment columns t and t + 4 are columns
// 4t + 2s and 4t + 2s + 1 (K's B fragments are read the same way), which
// makes a thread's four columns one 16-byte load.  A fragment order:
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
__device__ __forceinline__ void split_q(float4 qa, float4 qb,
                                        uint32_t (&hi)[2][4],
                                        uint32_t (&lo)[2][4]) {
  split_tf32(qa.x, hi[0][0], lo[0][0]);
  split_tf32(qb.x, hi[0][1], lo[0][1]);
  split_tf32(qa.y, hi[0][2], lo[0][2]);
  split_tf32(qb.y, hi[0][3], lo[0][3]);
  split_tf32(qa.z, hi[1][0], lo[1][0]);
  split_tf32(qb.z, hi[1][1], lo[1][1]);
  split_tf32(qa.w, hi[1][2], lo[1][2]);
  split_tf32(qb.w, hi[1][3], lo[1][3]);
}

// One block: 64 query rows of one (head, batch), 16 a warp, against the
// key tiles of the causal range (kBias: the bias row; kDrop: dropout).
template <int D, bool kBias, bool kDrop>
__global__ void __launch_bounds__(kThreads, Tiles<D>::kMinBlocks)
flash_fwd_tf32x3(Params p) {
  static_assert(!(kBias && kDrop), "dropout does not take a bias");
  using T = Tiles<D>;
  constexpr int kBK = T::kBK, kNT = T::kNT, kOT = D / 8, kChunks = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);    // [kBQ][kQPitch]
  float* Ks = Qs + T::kQFloats;                      // [stage][kBK][kKPitch]
  float* Vs = Ks + kStages * kBK * T::kKPitch;       // [stage][kBK][kVPitch]
  float* Bs = Vs + kStages * kBK * T::kVPitch;       // [stage][kBK]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;       // fragment row group
  const int t = lane % 4;       // thread in the quad
  const int wrow0 = q0 + warp * 16;
  const int row_a = wrow0 + g;  // this thread's rows row_a, row_a + 8
  const int row_b = row_a + 8;

  const float* qg = reinterpret_cast<const float*>(p.q) + b * p.q_sb
                    + h * p.q_sh;
  const float* kg = reinterpret_cast<const float*>(p.k) + b * p.k_sb
                    + hk * p.k_sh;
  const float* vg = reinterpret_cast<const float*>(p.v) + b * p.v_sb
                    + hk * p.v_sh;
  const float* bg = reinterpret_cast<const float*>(p.bias) + b * p.bias_sb;
  const int kv_end = p.causal ? min(p.Sk, q0 + kBQ) : p.Sk;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  // tile kt's K and V rows into stage kt % kStages (rows past Sk read
  // nothing and are zero), and with the bias row its values times log2 e
  // (ordinary loads: a row shared by the batch has batch stride 0)
  auto load_tile = [&](int kt) {
    const int s = kt % kStages, k0 = kt * kBK;
    float* kd = Ks + s * kBK * T::kKPitch;
    float* vd = Vs + s * kBK * T::kVPitch;
    for (int c = threadIdx.x; c < kBK * (D / 4); c += kThreads) {
      const int r = c / (D / 4), c4 = (c % (D / 4)) * 4;
      const bool ok = k0 + r < p.Sk;
      const long long row = ok ? k0 + r : 0;
      cp_async16(sm90::smem_u32(kd + r * T::kKPitch + c4),
                 kg + row * p.k_ss + c4, ok ? 16 : 0);
      cp_async16(sm90::smem_u32(vd + r * T::kVPitch + c4),
                 vg + row * p.v_ss + c4, ok ? 16 : 0);
    }
    if constexpr (kBias) {
      for (int i = threadIdx.x; i < kBK; i += kThreads)
        Bs[s * kBK + i] = k0 + i < p.Sk ? bg[k0 + i] * sm90::kLog2e : 0.f;
    }
  };

  // Q: at head_dim 64 each thread loads its own fragments' values from
  // device memory and keeps them split for the whole block; above it the
  // block stages Q in shared memory with tile 0, split as it is read
  uint32_t qh[T::kQRegs ? kChunks : 1][2][4];
  uint32_t ql[T::kQRegs ? kChunks : 1][2][4];
  if constexpr (!T::kQRegs) {
    for (int c = threadIdx.x; c < kBQ * (D / 4); c += kThreads) {
      const int r = c / (D / 4), c4 = (c % (D / 4)) * 4;
      const bool ok = q0 + r < p.Sq;
      cp_async16(sm90::smem_u32(Qs + r * T::kQPitch + c4),
                 qg + (ok ? (long long)(q0 + r) : 0) * p.q_ss + c4,
                 ok ? 16 : 0);
    }
  }
  // the ring's first kStages - 1 tiles (a group each, Q's in the first)
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < n_tiles) load_tile(kt);
    cp_async_commit();
  }
  if constexpr (T::kQRegs) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 16 * c + 4 * t;
      const float4 qa = row_a < p.Sq ? __ldg(reinterpret_cast<const float4*>(
                            qg + (long long)row_a * p.q_ss + col)) : zero;
      const float4 qb = row_b < p.Sq ? __ldg(reinterpret_cast<const float4*>(
                            qg + (long long)row_b * p.q_ss + col)) : zero;
      split_q(qa, qb, qh[c], ql[c]);
    }
  }

  float o[kOT][4];
#pragma unroll
  for (int n = 0; n < kOT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf;   // running max (log2 units with a bias)
  float l_a = 0.f, l_b = 0.f;           // the thread's partial sums of P
  // the softmax's factor: scores with the bias row are formed in log2
  // units first (S scale log2 e + bias log2 e), so theirs is 1
  const float scale_log2 = p.scale * sm90::kLog2e;
  const float cf = kBias ? 1.f : scale_log2;
  PhiloxKey key{0u, 0u};
  if constexpr (kDrop) key = philox_key(p.drop.seed);

  for (int kt = 0; kt < n_tiles; ++kt) {
    // tile kt + kStages - 1 into the stage tile kt - 1 left
    if (kt + kStages - 1 < n_tiles) load_tile(kt + kStages - 1);
    cp_async_commit();         // (empty past the last tile)
    cp_async_wait<kStages - 1>();   // tile kt (and Q) landed here
    __syncthreads();           // ... and for every thread
    const int s = kt % kStages, k0 = kt * kBK;
    // a warp whose 16 rows precede every key of the tile skips it
    if (!(p.causal && k0 > wrow0 + 15)) {
      const float* kt_s = Ks + s * kBK * T::kKPitch;
      const float* vt_s = Vs + s * kBK * T::kVPitch;

      // S = Q K^T: 16 x kBK a warp, kNT n-tiles of 8 keys; each chunk of
      // 16 head_dim columns is two k-steps (columns permuted, split_q)
      float sc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      // one chunk's two k-steps against every n-tile
      auto qk_chunk = [&](int c, const uint32_t (&ah)[2][4],
                          const uint32_t (&al)[2][4]) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              kt_s + (j * 8 + g) * T::kKPitch + 16 * c + 4 * t);
          uint32_t bh[4], bl[4];
          split_tf32(kv.x, bh[0], bl[0]);
          split_tf32(kv.y, bh[1], bl[1]);
          split_tf32(kv.z, bh[2], bl[2]);
          split_tf32(kv.w, bh[3], bl[3]);
          mma_3x(sc[j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
          mma_3x(sc[j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
        }
      };
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if constexpr (T::kQRegs) {
          qk_chunk(c, qh[c], ql[c]);
        } else {
          const float* qw = Qs + (warp * 16 + g) * T::kQPitch + 16 * c
                            + 4 * t;
          uint32_t ah[2][4], al[2][4];
          split_q(*reinterpret_cast<const float4*>(qw),
                  *reinterpret_cast<const float4*>(qw + 8 * T::kQPitch),
                  ah, al);
          qk_chunk(c, ah, al);
        }
      }

      // the online softmax: element e of n-tile j is row row_a (+8 if e
      // > 1), key k0 + 8j + 2t + (e & 1); rows reduce over the quad
      if constexpr (kBias) {
        const float* brow = Bs + s * kBK + 2 * t;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float2 b2 = *reinterpret_cast<const float2*>(brow + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[j][e] = fmaf(sc[j][e], scale_log2, (e & 1) ? b2.y : b2.x);
        }
      }
      if (k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > wrow0)) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            if (kp >= p.Sk || (p.causal && kp > (e < 2 ? row_a : row_b)))
              sc[j][e] = kNegInf;
          }
      }
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[j][0], sc[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[j][2], sc[j][3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      // exactly 1 where the running max did not move
      const float alpha_a = sm90::ex2((m_a - mx_a) * cf);
      const float alpha_b = sm90::ex2((m_b - mx_b) * cf);
      m_a = mx_a;
      m_b = mx_b;
      const float mc_a = mx_a * cf, mc_b = mx_b * cf;
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = sm90::ex2(fmaf(sc[j][e], cf, e < 2 ? -mc_a : -mc_b));
          sc[j][e] = pe;
          if (e < 2) rs_a += pe;
          else rs_b += pe;
        }
      }
      l_a = l_a * alpha_a + rs_a;
      l_b = l_b * alpha_b + rs_b;
#pragma unroll
      for (int n = 0; n < kOT; ++n) {
        o[n][0] *= alpha_a;
        o[n][1] *= alpha_a;
        o[n][2] *= alpha_b;
        o[n][3] *= alpha_b;
      }
      if constexpr (kDrop) {
        // the denominator and the LSE keep the undropped P; P.V takes P
        // keep / (1 - p)
        const uint32_t keep = keep_bits_mma<kNT>(key, b, h, row_a, k0, g, t,
                                                 true, p.drop.thresh);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[j][e] = (keep >> (4 * j + e)) & 1u
                           ? sc[j][e] / p.drop.keep_p : 0.f;
      }

      // O += P V: n-tile j of S (8 keys) is one k-step, its keys permuted
      // so that S's accumulator is P's A fragment: fragment columns t and
      // t + 4 are keys 2t and 2t + 1, V's B fragment rows alike
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(sc[j][0], ph[0], pl[0]);
        split_tf32(sc[j][2], ph[1], pl[1]);
        split_tf32(sc[j][1], ph[2], pl[2]);
        split_tf32(sc[j][3], ph[3], pl[3]);
        const float* vr = vt_s + (8 * j + 2 * t) * T::kVPitch + g;
#pragma unroll
        for (int n = 0; n < kOT; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[8 * n], bh0, bl0);
          split_tf32(vr[T::kVPitch + 8 * n], bh1, bl1);
          mma_3x(o[n], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();           // stage s read before it is refilled
  }

  // full row sums, normalise, store (rows past Sq are not written)
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  float* og = reinterpret_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < kOT; ++n) {
    const int col = 8 * n + 2 * t;
    if (row_a < p.Sq)
      *reinterpret_cast<float2*>(og + (long long)row_a * p.o_ss + col) =
          make_float2(o[n][0] / l_a, o[n][1] / l_a);
    if (row_b < p.Sq)
      *reinterpret_cast<float2*>(og + (long long)row_b * p.o_ss + col) =
          make_float2(o[n][2] / l_b, o[n][3] / l_b);
  }
  if (p.lse != nullptr && t == 0) {
    const float ls = kBias ? kLn2 : p.scale;
    float* lg = p.lse + ((long long)b * p.H + h) * p.Sq;
    if (row_a < p.Sq) lg[row_a] = m_a * ls + logf(l_a);
    if (row_b < p.Sq) lg[row_b] = m_b * ls + logf(l_b);
  }
}

}  // namespace tf32

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem,
                   cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// `opt`: a bias row or dropout, taken by the bf16 <D, true> kernels (bf16
// at head_dim 64, and at 128 without options, is the sm90 route's); f32
// takes the 3xTF32 kernel of its option
template <int D>
cudaError_t run(const Params& p, int B, int is_bf16, bool opt,
                cudaStream_t stream) {
  if (is_bf16) {
    if constexpr (D == 64) {
      return cudaErrorInvalidValue;
    } else {
      const size_t smem = (size_t)(kBQ + 2 * kBK) * (D + kPad)
                              * sizeof(__nv_bfloat16)
                          + (opt ? kBK * sizeof(float) : 0);
      dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
      if (opt) return launch(flash_fwd_bf16<D, true>, grid, smem, stream, p);
      if constexpr (D == 128) {
        return cudaErrorInvalidValue;
      } else {
        return launch(flash_fwd_bf16<D, false>, grid, smem, stream, p);
      }
    }
  }
  using T = tf32::Tiles<D>;
  dim3 grid((p.Sq + tf32::kBQ - 1) / tf32::kBQ, p.H, B);
  if (p.bias != nullptr && p.drop.seed != nullptr)
    return cudaErrorInvalidValue;   // the reference refuses both
  if (p.bias != nullptr)
    return launch(tf32::flash_fwd_tf32x3<D, true, false>, grid,
                  T::kSmemBiasBytes, stream, p);
  if (p.drop.seed != nullptr)
    return launch(tf32::flash_fwd_tf32x3<D, false, true>, grid,
                  T::kSmemBytes, stream, p);
  return launch(tf32::flash_fwd_tf32x3<D, false, false>, grid,
                T::kSmemBytes, stream, p);
}

// ---------------------------------------------------------------------
// bf16 Hopper route (sm_90a): TMA, mbarriers, wgmma; head_dim 128
// without options, head_dim 64 with or without them
// ---------------------------------------------------------------------

namespace sm90 {

constexpr int kBQ = 128;          // query rows per work item
constexpr int kBK = 128;          // keys per K/V tile
constexpr int kThreads = 384;     // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kPanelBytes = 128 * kPanel * 2;   // 128 rows x 128 B
constexpr float kLn2 = 0.6931471805599453f;

// The route's shared memory at head_dim D (128 rows of D bf16 a tile):
// Q, a ring of kStages K and V stages (2 at head_dim 128; 4 at 64, whose
// tiles are half the size), the O staging tile, beside each K stage
// either the bias row's 128 values (f32, times log2 e) or half the keep
// mask's group words (dropout: 256), and the mbarriers.
template <int D, bool kBias, bool kDrop>
struct Tiles {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kTileBytes = kPanels * kPanelBytes;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kSideBytes = kBias ? kBK * 4 : kDrop ? 256 * 4 : 0;
  static constexpr int kSmemBytes = 1024                 // alignment slack
                                    + kTileBytes         // Q
                                    + 2 * kStages * kTileBytes   // K, V
                                    + kTileBytes         // O staging
                                    + kStages * kSideBytes
                                    + 8 * (2 + 4 * kStages);   // mbarriers
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

struct Params {
  float* lse;
  int B, H, Hkv, Sq, Sk;
  int n_qt;           // query tiles per (head, batch)
  int causal;
  float scale;        // for the LSE
  float scale_log2;   // scale * log2(e), for the exponentials
  // the options (head_dim 64 only): the bias row, bf16 [B, 1, 1, Sk]
  // with batch stride bias_sb (elements; 0: one row for the batch), and
  // dropout: the int64 seed in device memory, the keep threshold and
  // f32(1 / f32(1 - p)), by which kept values are multiplied
  const __nv_bfloat16* bias;
  long long bias_sb;
  const long long* seed;
  uint32_t thresh;
  float inv_keep_p;
};

// S = Q K^T for this warpgroup's 64 rows against a 128-key tile, D / 16
// steps of 16 over head_dim (the first step overwrites S).  Descriptors
// of step 0; step kk adds (kk / 4) panels and (kk % 4) 32-byte columns.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t off = ((kk / 4) * kPanelBytes + (kk % 4) * 32) >> 4;
    wgmma_ss(sc, dq + off, dk + off, kk > 0);
  }
}

// O += P V, 8 steps of 16 keys; P in registers, V MN-major; step kk adds
// 16 key rows of 128 bytes.  O is 64 x D: N = D / 2 floats a thread
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N],
                                         const uint32_t (&pa)[32],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_rs(o, &pa[4 * kk], dv + ((kk * 16 * 128) >> 4));
}

// Accumulator element r of a thread: row row_a (+8 if bit 1 of r),
// column 8 * (r / 4) + 2 * t + (r & 1), t = lane % 4.
struct RowState {
  float m_a, m_b;   // running max, raw q.k units (log2 units with a bias)
  float l_a, l_b;   // the thread's partial sums of P
};

// One key tile's online softmax on the scores `sc`: masks where `mask`
// says (the diagonal or ragged tile), updates the running max and the
// thread's partial sums, returns each row's rescale factor and leaves P
// (f32) in `sc`.  One FFMA and one ex2 a score: the scale and log2(e)
// are folded into c (1 for scores already in log2 units).
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

// The route's one template: head_dim 128 without options (the first
// Hopper kernel), head_dim 64 without options, with the bias row or
// with dropout (not both: the reference refuses dropout with a bias).
template <int D, bool kBias, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to, const Params p) {
  static_assert(!(kBias && kDrop), "dropout does not take a bias");
  static_assert(D == 64 || !(kBias || kDrop), "options at head_dim 64");
  using T = Tiles<D, kBias, kDrop>;
  constexpr int kStages = T::kStages;
  constexpr int kTileBytes = T::kTileBytes;
  extern __shared__ __align__(128) unsigned char smem_sm90[];
  // swizzled tiles need 1024-byte alignment
  const uint32_t sQ = (smem_u32(smem_sm90) + 1023u) & ~1023u;
  const uint32_t sK = sQ + kTileBytes;                // [stage]
  const uint32_t sV = sK + kStages * kTileBytes;      // [stage]
  const uint32_t sO = sV + kStages * kTileBytes;      // [warpgroup]
  const uint32_t sB = sO + kTileBytes;    // bias rows or mask [stage]
  const uint32_t bar_q = sB + kStages * T::kSideBytes;   // Q full
  const uint32_t bar_qe = bar_q + 8;                  // Q empty
  const uint32_t bar_k = bar_qe + 8;                  // K full, [stage]
  const uint32_t bar_v = bar_k + 8 * kStages;         // V full, [stage]
  const uint32_t bar_ek = bar_v + 8 * kStages;        // K empty, [stage]
  const uint32_t bar_ev = bar_ek + 8 * kStages;       // V empty, [stage]
  // with the bias row: stage s's 128 values (f32, times log2 e); with
  // dropout: stage s's 256 keep-mask group words of its keys k0 + 64 ..
  // k0 + 127, word 128 cw + i for consumer warpgroup cw's thread i
  float* brow = reinterpret_cast<float*>(smem_sm90
                                         + (sB - smem_u32(smem_sm90)));
  uint32_t* mwords = reinterpret_cast<uint32_t*>(brow);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qe, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      // with the bias row K's stage also waits for producer warp 0's
      // arrival after it has staged the row, with dropout for the four
      // producer warps' after they have written their half of the mask
      mbar_init(bar_k + 8 * s, kBias ? 2 : kDrop ? 5 : 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, kConsumerWarps);
      mbar_init(bar_ev + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every load; with the
    // bias row all of warp 0 walks the tiles and stages each tile's row
    // beside K; with dropout all four warps walk them and form half of
    // each tile's keep mask beside K (56 registers, the consumers 224:
    // the consumers' own Philox spills at 216, the producer's at 56 with
    // all of the mask) ----
    if constexpr (kDrop)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    PhiloxKey key{0u, 0u};
    if constexpr (kDrop) key = philox_key(p.seed);
    if (kDrop || (warp == 0 && (kBias || lane == 0))) {
      const bool issue = (!kBias && !kDrop) || (warp == 0 && lane == 0);
      int kv_it = 0;   // K/V tiles loaded so far: the ring's position
      Item it;
      for (int round = 0; item_of(p, round, it); ++round) {
        const int hk = it.h / (p.H / p.Hkv);
        // Q's previous item released (passes at once on the first)
        mbar_wait(bar_qe, (round & 1) ^ 1);
        if (issue) {
          mbar_expect_tx(bar_q, kTileBytes);
#pragma unroll
          for (int c = 0; c < T::kPanels; ++c)
            tma_load(sQ + c * kPanelBytes, &tq, bar_q, c * kPanel,
                     it.qt * kBQ, it.h, it.b);
        }
        for (int j = 0; j < it.n_tiles; ++j, ++kv_it) {
          const int s = kv_it % kStages;
          // the slot's previous tile released (passes at once at first)
          const uint32_t par = ((kv_it / kStages) & 1) ^ 1;
          const int k0 = j * kBK;
          const uint32_t dk = sK + s * kTileBytes;
          const uint32_t dv = sV + s * kTileBytes;
          mbar_wait(bar_ek + 8 * s, par);
          if (issue) {
            mbar_expect_tx(bar_k + 8 * s, kTileBytes);
#pragma unroll
            for (int c = 0; c < T::kPanels; ++c)
              tma_load(dk + c * kPanelBytes, &tk, bar_k + 8 * s, c * kPanel,
                       k0, hk, it.b);
          }
          if constexpr (kBias) {
            // ordinary loads: a row shared by the batch has batch stride
            // 0, which a tensor map cannot step; keys past Sk get 0
            // (their scores are masked)
            const __nv_bfloat16* row = p.bias + it.b * p.bias_sb;
            float* dst = brow + s * kBK;
            for (int i = lane; i < kBK; i += 32)
              dst[i] = k0 + i < p.Sk
                           ? __bfloat162float(row[k0 + i]) * kLog2e : 0.f;
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_k + 8 * s);
          }
          mbar_wait(bar_ev + 8 * s, par);
          if (issue) {
            mbar_expect_tx(bar_v + 8 * s, kTileBytes);
#pragma unroll
            for (int c = 0; c < T::kPanels; ++c)
              tma_load(dv + c * kPanelBytes, &tv, bar_v + 8 * s, c * kPanel,
                       k0, hk, it.b);
          }
          if constexpr (kDrop) {
            // the tile's keep mask for keys k0 + 64 .. k0 + 127, once its
            // loads are out: producer thread i forms the group word
            // (keep_groups_mma, rows are queries) of consumer thread i of
            // each warpgroup; the consumers form the other half
            const int i = threadIdx.x, gi = (i % 32) / 4, ti = i % 4;
#pragma unroll
            for (int cw = 0; cw < 2; ++cw)
              mwords[s * 256 + 128 * cw + i] = keep_groups_mma(
                  key, it.b, it.h,
                  it.qt * kBQ + cw * 64 + (i / 32) * 16 + gi, k0 + 64, gi,
                  ti, true, p.thresh);
            __syncwarp();
            if (lane == 0) mbar_arrive(bar_k + 8 * s);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    if constexpr (kDrop)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    constexpr int kO = D / 2;             // O's floats a thread
    const int cw = warp / 4 - 1;          // consumer warpgroup 0 or 1
    const int wl = warp % 4;              // warp within it: 16 rows
    const int g = lane / 4;               // accumulator row group
    const int t = lane % 4;               // thread in the quad
    const int tid = threadIdx.x % 128;
    // with the bias row the scores are formed in log2 units first (S c +
    // bias log2 e), so the softmax's factor is 1 and the LSE's ln 2
    const float c = kBias ? 1.f : p.scale_log2;
    const float lse_scale = kBias ? kLn2 : p.scale;
    PhiloxKey key{0u, 0u};
    if constexpr (kDrop) key = philox_key(p.seed);
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
      // the keep bits of tile j's 64 scores of this thread (bit r of
      // keep[r / 32] for element r), a group word a half and one shuffle
      // with the lane pair: keys k0 .. k0 + 63 from this thread's own
      // Philox (keep_groups_mma, rows are queries), k0 + 64 .. from the
      // word the producer warps wrote beside K in stage s.  Formed once
      // the products are issued (ptxas schedules the Philox before the
      // issue; formed a tile ahead, after the softmax, it spilled and ran
      // no faster: PERF.md §6)
      auto own_word = [&](int j) {
        return keep_groups_mma(key, it.b, it.h, row_a, j * kBK, g, t, true,
                               p.thresh);
      };
      auto keep_bits = [&](uint32_t (&keep)[2], uint32_t own, int s) {
        keep[0] = keep_bits_of_groups(own, g, true);
        keep[1] = keep_bits_of_groups(mwords[s * 256 + 128 * cw + tid], g,
                                      true);
      };
      // the diagonal tile and the ragged last tile need the mask; with
      // the bias row the scores take their tile's values first (K's stage
      // is released only after this, so its row stays)
      auto softmax = [&](float (&sc)[64], RowState& st, float& alpha_a,
                         float& alpha_b, int j, int s) {
        const int k0 = j * kBK;
        if constexpr (kBias) {
          const float* bl = brow + s * kBK + 2 * t;
#pragma unroll
          for (int c8 = 0; c8 < 16; ++c8) {
            const float2 b2 = *reinterpret_cast<const float2*>(bl + 8 * c8);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 4 * c8 + e;
              sc[r] = fmaf(sc[r], p.scale_log2, (e & 1) ? b2.y : b2.x);
            }
          }
        }
        softmax_tile(sc, st, alpha_a, alpha_b, c,
                     k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > wg_row0),
                     k0, p.Sk, p.causal, row_a, t);
      };
      // the denominator and the LSE keep the undropped P; P.V takes P
      // keep / (1 - p)
      auto drop = [&](float (&sc)[64], const uint32_t (&keep)[2]) {
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          const float kept = __fmul_rn(sc[r], p.inv_keep_p);
          sc[r] = (keep[r / 32] >> (r % 32)) & 1u ? kept : 0.f;
        }
      };
      float o[kO], sc[64];
#pragma unroll
      for (int r = 0; r < 64; ++r) sc[r] = 0.f;
#pragma unroll
      for (int r = 0; r < kO; ++r) o[r] = 0.f;
      uint32_t pa[32];
      uint32_t keep[2] = {0u, 0u};   // with dropout: the tile's keep bits
      RowState st{kNegInf, kNegInf, 0.f, 0.f};
      float alpha_a, alpha_b;

      // S(j) and P(j-1).V(j-1) are issued together; the softmax of S(j)
      // runs while P(j-1).V(j-1) is on the tensor cores.  A consumer
      // releases K(j) once S(j) has retired (with the bias row: once its
      // softmax has read the row), V(j-1) once P(j-1).V(j-1) has, and Q
      // after the item's last S.
      mbar_wait(bar_q, round & 1);
      turn_wait();
      {
        const int s = kv_it % kStages;
        mbar_wait(bar_k + 8 * s, (kv_it / kStages) & 1);
        wgmma_fence();
        issue_qk<D>(sc, dq, k_desc(s));
        wgmma_commit();
        fence_regs(sc);
        turn_pass();
        if constexpr (kDrop) keep_bits(keep, own_word(0), s);
        wgmma_wait<0>();
        fence_regs(sc);
        if constexpr (!kBias) release(bar_ek + 8 * s);
        if (n == 1) release(bar_qe);
        softmax(sc, st, alpha_a, alpha_b, 0, s);
        if constexpr (kBias) release(bar_ek + 8 * s);
        if constexpr (kDrop) drop(sc, keep);
        pack_p(sc, pa);
      }
      for (int j = 1; j < n; ++j) {
        const int s = (kv_it + j) % kStages;
        const int sp = (kv_it + j - 1) % kStages;
        turn_wait();
        mbar_wait(bar_k + 8 * s, ((kv_it + j) / kStages) & 1);
        mbar_wait(bar_v + 8 * sp, ((kv_it + j - 1) / kStages) & 1);
        wgmma_fence();
        issue_qk<D>(sc, dq, k_desc(s));
        wgmma_commit();
        issue_pv(o, pa, v_desc(sp));
        wgmma_commit();
        fence_regs(sc);
        fence_regs(o);
        fence_regs(pa);
        turn_pass();
        if constexpr (kDrop) keep_bits(keep, own_word(j), s);
        wgmma_wait<1>();
        fence_regs(sc);
        if constexpr (!kBias) release(bar_ek + 8 * s);
        if (j == n - 1) release(bar_qe);
        softmax(sc, st, alpha_a, alpha_b, j, s);
        if constexpr (kBias) release(bar_ek + 8 * s);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        release(bar_ev + 8 * sp);
#pragma unroll
        for (int r = 0; r < kO; ++r) o[r] *= (r & 2) ? alpha_b : alpha_a;
        if constexpr (kDrop) drop(sc, keep);
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
        if (row_a < p.Sq) lg[row_a] = st.m_a * lse_scale + logf(l_a);
        if (row_b < p.Sq) lg[row_b] = st.m_b * lse_scale + logf(l_b);
      }

      // O (bf16) to this warpgroup's staging tile, 64-column panels in
      // the 128-byte swizzle (conflict-free, and the layout the store map
      // reads), once the previous item's store has read it; then one TMA
      // store a panel, which clips rows past Sq
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync<128>(1 + cw);
      const int lr_a = wl * 16 + g, lr_b = lr_a + 8;   // local rows
#pragma unroll
      for (int r = 0; r < kO; r += 2) {
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
#pragma unroll
        for (int pc = 0; pc < T::kPanels; ++pc)
          tma_store(&to, oa + pc * (kTileBytes / 4), pc * kPanel, wg_row0,
                    cur.h, cur.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (!more)
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      }
    }
  }
}

}  // namespace sm90

// the sm90 route has no instantiation for the head_dim and options asked
constexpr int kErrRoute = 99998;

// the sm90 entry's arguments, as its launch takes them
struct FwdArgs {
  const void* const* ptrs;   // q, k, v, o
  float* lse;
  int B, H, Hkv, Sq, Sk;
  const long long* tma_strides;
  const int* plan;
  int causal;
  float scale;
  const __nv_bfloat16* bias;
  long long bias_sb;
  const long long* seed;
  unsigned int thresh;
  float inv_keep_p;
  cudaStream_t stream;
};

// the sm90 route's launch: tensor maps from the caller's byte strides,
// the plan checked against the instantiation's tiles
template <int D, bool kBias, bool kDrop>
int run_sm90(const FwdArgs& a) {
  using T = sm90::Tiles<D, kBias, kDrop>;
  const int n_qt = (a.Sq + sm90::kBQ - 1) / sm90::kBQ;
  // plan: block_q, block_k, stages, threads, shared memory, and the grid
  // (blocks, 1, 1): one block per work item, or fewer that loop
  const int* plan = a.plan;
  if (plan[0] != sm90::kBQ || plan[1] != sm90::kBK
      || plan[2] != T::kStages || plan[3] != sm90::kThreads
      || plan[4] != T::kSmemBytes || plan[5] < 1
      || plan[5] > n_qt * a.H * a.B || plan[6] != 1 || plan[7] != 1)
    return kErrPlan;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  CUtensorMap maps[4];
  const int seqs[4] = {a.Sq, a.Sk, a.Sk, a.Sq};
  const int heads[4] = {a.H, a.Hkv, a.Hkv, a.H};
  for (int i = 0; i < 4; ++i) {
    // loads take 128-row boxes, the store a warpgroup's 64 rows
    const int rc = encode_map(fn, &maps[i], a.ptrs[i], seqs[i], heads[i],
                              a.B, a.tma_strides + 3 * i,
                              i < 3 ? sm90::kBK : 64, D);
    if (rc != 0) return kErrEncode + rc * 16 + i;
  }
  const auto kernel = sm90::flash_fwd_sm90<D, kBias, kDrop>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const sm90::Params p{a.lse, a.B, a.H, a.Hkv, a.Sq, a.Sk, n_qt, a.causal,
                       a.scale, a.scale * sm90::kLog2e, a.bias, a.bias_sb,
                       a.seed, a.thresh, a.inv_keep_p};
  kernel<<<plan[5], sm90::kThreads, T::kSmemBytes, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  static char buf[160];
  if (err == kErrPlan)
    return "the launch plan names tiles this library was not built with";
  if (err == kErrRoute)
    return "the sm90 route has no kernel for this head_dim and these "
           "options (head_dim 128 takes none; head_dim 64 takes the bias "
           "row or dropout, not both)";
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

// The mma.sync and 3xTF32 routes: q/k/v/o (B, H, S, D) views with unit
// stride on D, 16-byte aligned rows; strides in elements.  lse:
// contiguous (B, H, Sq) f32, or null.  The options: `bias`, a [B, 1, 1,
// Sk] row in q's dtype with unit stride on Sk and batch stride `bias_sb`
// (elements), added to the scaled scores, or null; `seed`, an int64 in
// device memory, or null: with it each probability is kept iff its
// Philox bits are >= `thresh` (floor(p * 2^32)) and a kept one divided
// by `keep_p` (f32(1 - p)) before P.V, while the denominator and the LSE
// keep the undropped P.  f32 takes one option at most.  bf16 is taken
// here at head_dim 256, and at 128 only with an option: head_dim 64, and
// 128 without options, are the sm90 route's.  Returns the CUDA error of
// the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, void* lse, int B, int H, int Hkv, int Sq,
                        int Sk, int D, const void* bias, long long bias_sb,
                        const void* seed, unsigned int thresh, float keep_p,
                        long long q_sb, long long q_sh,
                        long long q_ss, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh,
                        long long v_ss, long long o_sb, long long o_sh,
                        long long o_ss, int causal, float scale, int is_bf16,
                        void* stream) {
  const bool opt = bias != nullptr || seed != nullptr;
  // f32 rows of 16 bytes (the 3xTF32 kernel's cp.async and vector
  // loads): the start aligned, the stride of a dimension longer than one
  // a multiple of 4 floats
  auto rows16 = [&](const void* ptr, long long sb, long long sh,
                    long long ss, int h, int s) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0
           && (B == 1 || sb % 4 == 0) && (h == 1 || sh % 4 == 0)
           && (s == 1 || ss % 4 == 0);
  };
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0
      || (is_bf16 && (D == 64 || (D == 128 && !opt)))
      || (!is_bf16 && ((bias != nullptr && seed != nullptr)
                       || !rows16(q, q_sb, q_sh, q_ss, H, Sq)
                       || !rows16(k, k_sb, k_sh, k_ss, Hkv, Sk)
                       || !rows16(v, v_sb, v_sh, v_ss, Hkv, Sk)))
      || (seed != nullptr && !(keep_p > 0.f && keep_p <= 1.f)))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, static_cast<float*>(lse), H, Hkv, Sq, Sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, causal, scale, bias, bias_sb,
           Dropout{static_cast<const long long*>(seed), thresh, keep_p}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)run<64>(p, B, is_bf16, opt, s);
    case 128: return (int)run<128>(p, B, is_bf16, opt, s);
    case 256: return (int)run<256>(p, B, is_bf16, opt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The keep mask as the kernels define it (dropout.cuh), one element a
// thread: out[b, h, i, j] (uint8, contiguous [B, H, Sq, Sk]) = 1 iff
// score (q0 + i, k0 + j) of head h in batch b is kept at `thresh`.  A
// debug entry: chip_smoke.py holds it bitwise against the plain version.
int flash_dropout_keep_mask(const void* seed, int B, int H, int Sq, int Sk,
                            int q0, int k0, unsigned int thresh, void* out,
                            void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || q0 < 0 || k0 < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * Sq * Sk;
  const int blocks = (int)std::min<long long>((n + 255) / 256, 132 * 16);
  dropout_keep_mask_kernel<<<blocks, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seed), B, H, Sq, Sk, q0, k0, thresh,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// The sm90 route: bf16 at head_dim 128 without options, and at head_dim
// 64 without options, with the bias row or with dropout.  q/k/v: (B, H,
// S, D) views with unit stride on D, 16-byte aligned; o: the (B, H, Sq,
// D) output, same rules.  `tma_strides`: the byte strides (seq, head,
// batch) of q, k, v and o, 12 values, multiples of 16.  lse: contiguous
// (B, H, Sq) f32, or null.  `plan`: block_q, block_k, stages, threads,
// shared-memory bytes and the grid (blocks, 1, 1) as the Python launch
// plan computed them; the tiles must be those of the instantiation
// launched, and the blocks at most the work items.  The options: `bias`,
// a bf16 [B, 1, 1, Sk] row with unit stride on Sk and batch stride
// `bias_sb` (elements; 0 for one row shared by the batch), added to the
// scaled scores, or null; `seed`, an int64 in device memory, or null:
// with it a probability is kept iff its Philox bits are >= `thresh`
// (floor(p * 2^32)) and a kept one multiplied by `inv_keep_p` (f32(1 /
// f32(1 - p))) before P.V, while the denominator and the LSE keep the
// undropped P.  Not both.  Returns the CUDA error of the launch (0 on
// success), kErrPlan for another plan, kErrRoute for a head_dim and
// options this route has no kernel for.
int flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Hkv,
                             int Sq, int Sk, const long long* tma_strides,
                             const int* plan, int causal, float scale, int D,
                             const void* bias, long long bias_sb,
                             const void* seed, unsigned int thresh,
                             float inv_keep_p, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0
      || bias_sb < 0
      || (seed != nullptr && !(inv_keep_p >= 1.f && inv_keep_p < 1e30f)))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  const FwdArgs a{ptrs, static_cast<float*>(lse), B, H, Hkv, Sq, Sk,
                  tma_strides, plan, causal, scale,
                  static_cast<const __nv_bfloat16*>(bias), bias_sb,
                  static_cast<const long long*>(seed), thresh, inv_keep_p,
                  static_cast<cudaStream_t>(stream)};
  if (bias != nullptr && seed != nullptr) return kErrRoute;
  if (D == 128 && bias == nullptr && seed == nullptr)
    return run_sm90<128, false, false>(a);
  if (D != 64) return kErrRoute;
  if (bias != nullptr) return run_sm90<64, true, false>(a);
  if (seed != nullptr) return run_sm90<64, false, true>(a);
  return run_sm90<64, false, false>(a);
}

}  // extern "C"

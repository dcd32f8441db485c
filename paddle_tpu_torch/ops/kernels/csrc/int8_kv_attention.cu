// Int8 paged attention for Hopper (sm_90a), with a plain C interface:
// one kernel, `int8_kv_rows<q type, head_dim, slabs>` (entry
// `int8_kv_attention_rows`), for every call: decode and draft steps (S =
// 1), speculative verify blocks and prefix-sharing suffix prefills of up
// to max_model_len query rows (S > 1).
//
// Replaces: paddle_tpu/ops/pallas/kv_attention.py:84
// `_int8_kv_attn_kernel` (launched by `int8_paged_attention`): attention
// of the S*R query rows that share one kv head over a sequence's int8
// K/V pool blocks, found through its block table, with per-(block, slot)
// f32 scales, the `slot <= position` mask and an f32 online softmax.
//
// One arithmetic for every S.  A query row's output bits depend only on
// its q, its position and its sequence's blocks -- not on S, the row
// tile it lands in or the key split -- so a decode step, a draft step,
// a verify block and a prefill give a position the same bits, and
// speculative decoding emits what plain decode emits, token for token.
// (The first port had a second kernel for S = 1, an FMA body over
// plan-sized chunks with another order of sums; a self-draft's proposals
// parted from its verify blocks at near-ties on the card.)
//
// What bounds it on this card: bytes at a decode step and a verify
// block (a query row does about 4 D flops a cached token against 2 D
// bytes of int8 K/V), the bf16 tensor-core rate at a prefill; each
// kind's figures are beside the kernel below.
//
// What the design does about it: query rows tiled in 16-row slabs over
// the grid, key tiles gathered by `cp.async` into a ring and converted
// once a block to exact bf16, products on the tensor cores, 256-slot
// chunks folded in order and, where the row tiles leave the card idle
// (decode steps, verify blocks), split one chunk a block (below).
//
// Numerics: s = (q . code) * k_scale * 1/sqrt(D) (the reference: q .
// (code * k_scale) * 1/sqrt(D)), masked s = -1e30, m_new = max(m, max
// s), masked p exactly 0 (never exp of a huge negative), l = l*alpha +
// sum p, acc = acc*alpha + sum (p * v_scale) * code (the reference: p .
// (code * v_scale)), out = acc / max(l, 1e-30) rounded once to the query
// dtype; the chunk folds re-associate f32 sums and products, within the
// registered tolerance.  Idle decode slots (table all trash block 0,
// position 0) produce finite output.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>
#include <stdio.h>

#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr long long kSmemLimit = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------
// The kernel, `int8_kv_rows<q type, head_dim, warps>`: every S (decode
// and draft steps, verify blocks, prefix-sharing suffix prefills)
// ---------------------------------------------------------------------
//
// What bounds it: operations at a prefill (4 D flops a valid (query row,
// slot) pair at the bf16 tensor-core rate, against the valid tokens'
// int8 K/V once), bytes at a verify block (5 rows a kv head do 20 flops
// a byte) and at a decode step (one to four rows a kv head: a 16-row
// slab of which the rest are idle rows, whose products the tensor cores
// do for nothing).  The first design ran scores and P.V on the FMA pipe, whose
// f32 rate alone puts a cold 2,048-row prefill at 15x its bound.
//
// What the design does:
// - Tiles.  A block owns W 16-row slabs of the S*R query rows of one (kv
//   head, sequence): 8 slabs (256 threads) above 64 rows, 4 above 32, 2
//   above 16, else 1 (128 threads; at most 2 at head_dim 256).  Below 8
//   slabs a slab's output dims are split over 4 / W warps (at least two
//   at head_dim 256), each computing the slab's scores and softmax and
//   its own dims of P.V, so every warp of a block works.  Keys come in
//   tiles of kRowKeys = 64 slots at fixed absolute slots [64 t, 64 t +
//   64), from slot 0 up to the table block holding the row tile's
//   largest position.  Row tiles are spread over the grid, longest
//   first, so no S is too large.
// - Loads.  Every thread gathers 16-byte pieces of the tile's K and V
//   rows (and 4-byte scales) through the block table with `cp.async`
//   into a ring of 2-4 int8 stages (zero past the table block holding
//   the largest position).  Codes stay int8 in the ring; once a tile the
//   block converts them exactly into bf16 tiles [64][D + 8] (a byte
//   spread, two masks and an `add.rn.bf16x2` a code pair), which every
//   warp reads with `ldmatrix` (rows 16 bytes apart modulo 128: no bank
//   conflict).
// - Products on the tensor cores, `mma.sync.m16n8k16` bf16 with f32
//   sums, not `wgmma`: a verify block has 5 rows a kv head, which a
//   64-row `wgmma` tile would mostly waste, and a 16-row slab a warp
//   gives a row the same instructions whatever the block's slab count.
//   Scores: q . code, where a bf16 query is one piece and an f32 query
//   three (hi = q rounded to bf16, then the rest likewise; their sum is
//   q exactly), each piece a product of its own, the smallest first;
//   the codes need no split.  Then s = (q . code) * k_scale * 1/sqrt(D)
//   per slot in f32.  P.V: P' = p * v_scale in f32, split into two bf16
//   pieces (hi, then lo = P' - hi rounded), two products against the
//   codes, the smaller first; S's accumulator is P's A fragment.  (P
//   rounded once to bf16 missed CARD_TOL[bf16] many times over at the
//   cold prefill on an H100: PERF.md section 6.)
// - Chunks and the split.  The keys are cut into chunks of
//   kChunkTiles = 4 key tiles (256 absolute slots).  A chunk's state (m,
//   l, acc) starts fresh at (-1e30, 0, 0) and folds its key tiles as an
//   online softmax; a row's result is its chunks' states folded in chunk
//   order by `fold_ml` / `fold_a` from (-1e30, 0, 0), then out = acc /
//   max(l, 1e-30).  A block runs K consecutive chunks of its row tile
//   (`chunks_a_block`): where it runs them all (prefills) it folds each
//   chunk into the warp's running state at the chunk's end (acc in the
//   workspace, read and written once a chunk; m and l in registers) and
//   writes the output; where a row tile's chunks are spread over blocks
//   (verify blocks: one chunk a block) each block writes its chunks'
//   states to the workspace, takes a ticket (every thread fences, one
//   acq_rel atomic at GPU scope) and the last block of the row tile
//   folds them all in chunk order with the same two functions, writes
//   the output and resets the ticket.  Both folds give a row the same
//   bits.  On an H100 the split over blocks takes 1.8x as long as the
//   in-block fold at a cold 2,048-row prefill and 2.4x at a warm suffix
//   (one chunk's ring fill and state write a block), and the in-block
//   fold 1.6x as long as the split at a verify block (256 blocks for
//   132 SMs, each walking its whole sequence): phase 36 (a) of
//   chip_smoke.py times the plan's fold and the other one.
// - Occupancy.  The route is latency-bound: no one part of a tile (the
//   conversion, the loads, the QK or the P.V products) takes most of its
//   time, and verify blocks at two an SM instead of three take longer
//   (PERF.md section 6).  So a
//   prefill block of 8 slabs fills an SM's registers alone, 4 slabs take
//   two blocks an SM, and a verify block (one slab, 69,136 bytes at
//   head_dim 128) is held to 168 registers for three.
//
// Row independence (the bit contract prefix sharing rests on): a row's
// output depends only on its q, its position and its sequence's blocks.
// The first fold gives the chunk's state exactly (exp(0) = 1, the
// running terms times exp(-1e30) = 0), and a chunk wholly past a row's
// position ((-1e30, 0, 0)) leaves the running state exactly as it was;
// within a chunk a key tile wholly past the row's position leaves (m,
// l, acc) bitwise unchanged (max(m, -1e30) = m, alpha = exp(0) = 1,
// every p an exact 0).  So the chunks a block walks past a row's
// position, and whether its chunks fold in its own block or in the last
// block of a split row tile, change nothing.  Inside a tile a row's sums run over the lanes
// of its fragment in an order the fragment layout fixes, the same for
// every row (l: each quad lane sums its 16 slots, j ascending, then
// (l0 + l1) + (l2 + l3) at the chunk's end; the tensor core sums a
// row's products from its own A row alone), and every f32 operation is
// an explicit round-to-nearest intrinsic, so no contraction differs
// between instantiations.  A cold prefill, a warm suffix prefill and a
// verify block give the same bits at the positions they share.
// `paged_attention_rows_ref` in kv_attention.py is the CPU model of
// this order.

constexpr int kRowKeys = 64;                        // slots a key tile
constexpr int kChunkTiles = 4;                      // key tiles a chunk
constexpr int kRowChunk = kRowKeys * kChunkTiles;   // slots a chunk
constexpr int kRowPad = 8;   // bf16 padding of a row of the bf16 tiles

// Byte offsets of the kernel's dynamic shared memory, computed
// the same way by kv_attention._rows_smem: the ring's stages (K and V
// codes [64][D] int8, K and V scales [64] f32), the converted tile (bf16
// K and V [64][D + 8], their scales [64] f32 each), the queries' bf16
// pieces [pieces][16 W][D + 8] (none where a bf16 query of head_dim <=
// 128 stays in registers: it is staged in the converted tile first) and
// 16 bytes (the block's largest position, the ticket's verdict).
struct RowsLayout {
  long long stage, conv, conv_bytes, q, misc, total;
};

__host__ __device__ inline RowsLayout rows_layout(int D, int W, int pieces,
                                                  int stages) {
  RowsLayout L;
  L.stage = 2LL * kRowKeys * D + 8LL * kRowKeys;
  L.conv = stages * L.stage;
  L.conv_bytes = 4LL * kRowKeys * (D + kRowPad) + 8LL * kRowKeys;
  L.q = L.conv + L.conv_bytes;
  const bool qregs = pieces == 1 && D <= 128;
  L.misc = L.q + (qregs ? 0 : 2LL * pieces * 16 * W * (D + kRowPad));
  L.total = L.misc + 16;
  return L;
}

struct RowsParams {
  const void* q;
  const int8_t* kpool;
  const int8_t* vpool;
  const float* kscale;
  const float* vscale;
  const int* tbl;
  const int* pos;
  void* out;
  float* ws;       // split: [B][G][row tiles][nc][QT][D + 2] chunk
                   // states; else [B][G][row tiles][QT * D] running acc
  int* tickets;    // [B][G][row tiles], zero between launches
  int B, S, H, G, R, bs, M;
  int nc;          // chunks of the table
  int K;           // chunks a block
  int groups;      // chunk groups a row tile: ceil(nc / K)
  int row_tiles, stages;
  long long q_sb, q_ss, q_sh;
  float scale;
  float inv_bs;    // 1 / bs, for div_bs
  RowsLayout lay;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  // `bytes` 0 reads nothing and fills the 16 with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest n (0, 1 or 2) landed
__device__ __forceinline__ void cp_async_wait_all_but(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2 (rounded to nearest), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// codes k and k + 1 (k = 0 or 2) of a word of four int8 codes as two
// exact bf16, with integer and bf16x2 operations only: for a code x
// spread into a 16-bit lane, t = 128 + (x & 0x7f) has the bits 0x4300 |
// (x & 0x7f), and x = t - 256 + 128 (x >= 0) = t + c with c = -128 or
// -256 (0xc300 | (x & 0x80)); t + c is exact in bf16 (|x| <= 128)
__device__ __forceinline__ uint32_t bf16x2_codes(uint32_t w, int k) {
  const uint32_t x = __byte_perm(w, 0u, k == 0 ? 0x4140 : 0x4342);
  const uint32_t t = (x & 0x007f007fu) | 0x43004300u;
  const uint32_t c = (x & 0x00800080u) | 0xc300c300u;
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(t), "r"(c));
  return r;
}

// x, as a value the compiler must take to be made anew where this runs:
// the shared-memory addresses derived from it inside the tile loop are
// not hoisted out of it (with every k-step's and n-tile's address live
// across the loop, the head_dim-256 and f32 entries spilled)
__device__ __forceinline__ uint32_t fresh(uint32_t x) {
  uint32_t y;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// e^x as the route takes it everywhere (the softmax, alpha and the
// chunk fold): 2^(x log2 e) on the special-function unit.  exp(0) is
// exactly 1 and exp(-1e30 - m) exactly 0, which the folds' identities
// need.
__device__ __forceinline__ float exp_f(float x) {
  return sm90::ex2(__fmul_rn(x, sm90::kLog2e));
}

// A chunk's (m, l) folded into the running (M, L) in chunk order, and
// the factors the chunk's acc takes: A' = fold_a(A, acc, f, g).  The
// in-block fold and the last block's fold of a split row tile call these
// two and nothing else, so both give a row the same bits.
__device__ __forceinline__ void fold_ml(float& M, float& L, float m, float l,
                                        float& f, float& g) {
  const float Mn = fmaxf(M, m);
  f = exp_f(__fsub_rn(M, Mn));
  g = exp_f(__fsub_rn(m, Mn));
  L = __fadd_rn(__fmul_rn(L, f), __fmul_rn(l, g));
  M = Mn;
}

__device__ __forceinline__ float fold_a(float A, float a, float f, float g) {
  return __fadd_rn(__fmul_rn(A, f), __fmul_rn(a, g));
}

template <typename QT>
__device__ __forceinline__ QT* out_row(const RowsParams& p, int b, int g,
                                       int j, int D) {
  return static_cast<QT*>(p.out)
         + (((long long)b * p.S + j / p.R) * p.H + g * p.R + j % p.R) * D;
}

// x / bs for 0 <= x < 2^24 (the entry refuses longer tables): a float
// estimate off by at most one, corrected
__device__ __forceinline__ int div_bs(int x, int bs, float inv_bs) {
  int q = __float2int_rz(__fmul_rn(__int2float_rn(x), inv_bs));
  const int r = x - q * bs;
  return q + (r >= bs) - (r < 0);
}

// One block a (row tile, chunk group) x kv head x sequence: blockIdx
// (row tile * groups + group, kv head, sequence).  Warp w owns slab w /
// kSplit of the row tile and share w % kSplit of the output's dims (at
// head_dim 256 at least two shares: a chunk's acc of all 256 dims a
// thread spilled).
template <typename QT, int D, int W>
__global__ void __launch_bounds__(W == 8 ? 256 : 128,
                                  W == 1 && D <= 128 ? 3 : 1)
int8_kv_rows(const RowsParams p) {
  using namespace sm90;
  constexpr int kP = sizeof(QT) == 4 ? 3 : 1;   // bf16 pieces a query
  constexpr bool kQRegs = kP == 1 && D <= 128;  // q's fragments in registers
  constexpr int kSplitMin = D == 256 ? 2 : 1;
  constexpr int kSplit =                        // warps a slab
      W == 8 ? 1 : (4 / W > kSplitMin ? 4 / W : kSplitMin);
  constexpr int kCW = W * kSplit;               // warps: 4, or 8 slabs
  constexpr int kQT = 16 * W;                   // query rows a block
  constexpr int kKS = D / 16;                   // k-steps of a score
  constexpr int kNA = D / 8 / kSplit;           // n-tiles of a warp's acc
  constexpr int kPitch = D + kRowPad;           // bf16 a tile row
  constexpr int kParts = D / 16;                // 16-byte pieces a code row
  constexpr int kThreads = 32 * kCW;
  static_assert(kThreads == (W == 8 ? 256 : 128), "warps a block");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RowsLayout& L = p.lay;
  // the converted tile: bf16 K [64][kPitch], V [64][kPitch], scales
  __nv_bfloat16* const kb =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + L.conv);
  __nv_bfloat16* const qs = kQRegs
      ? kb
      : reinterpret_cast<__nv_bfloat16*>(smem_raw + L.q);
  int* const misc = reinterpret_cast<int*>(smem_raw + L.misc);
  const int g = blockIdx.y, b = blockIdx.z;
  const int grp = blockIdx.x % p.groups;
  const int rt = p.row_tiles - 1 - blockIdx.x / p.groups;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slab = warp / kSplit, share = warp % kSplit;
  const int gr = lane >> 2, tq = lane & 3;   // fragment row, quad lane
  const int SR = p.S * p.R;
  const int row0 = rt * kQT;
  const int last_slot = p.M * p.bs - 1;      // the table's last slot

  // the row tile's largest position: keys up to the table block holding
  // it; chunks from the group's first, the live ones only
  if (tid == 0) misc[0] = -1;
  __syncthreads();
  {
    int mine = -1;
    for (int r = tid; r < kQT; r += kThreads) {
      const int j = row0 + r;
      if (j < SR)
        mine = max(mine, __ldg(p.pos + (long long)b * p.S + j / p.R));
    }
    if (mine >= 0) atomicMax(misc, mine);
  }
  __syncthreads();
  const int maxpos = misc[0];
  const int lim = maxpos < 0 ? 0 : min(p.M, maxpos / p.bs + 1) * p.bs;
  const int n_live = max(1, (lim + kRowChunk - 1) / kRowChunk);
  const int c0 = grp * p.K;
  if (c0 >= n_live) return;
  const int c1 = min(c0 + p.K, n_live);
  const bool split = (n_live + p.K - 1) / p.K > 1;
  const int kt0 = c0 * kChunkTiles;
  const int kt1 = min(c1 * kChunkTiles, (lim + kRowKeys - 1) / kRowKeys);
  const int n_tiles = max(0, kt1 - kt0);
  const int* const tbl_b = p.tbl + (long long)b * p.M;

  // A thread's share of a tile's loads: kIssue 16-byte pieces of K and
  // of V (slot (tid + kThreads n) / kParts, piece tid % kParts) and, in
  // the first 128 threads, one scale (K's below thread 64, V's above,
  // slot tid % 64).  Their table
  // entries are all read first (`fetch`), then every copy is issued: the
  // copies' memory clobbers would otherwise make each read wait for the
  // copy before it.  (Read a tile ahead, they held registers across the
  // tile's products and spilled, for no gain on the card.)
  constexpr int kIssue = kRowKeys * kParts / kThreads;
  int phys[kIssue], phys_s;   // the tile's entries (-1: past lim)
  auto fetch = [&](int i) {
    const int base = (kt0 + i) * kRowKeys;
#pragma unroll
    for (int n = 0; n < kIssue; ++n) {
      const int slot = base + (tid + n * kThreads) / kParts;
      phys[n] = slot < lim ? __ldg(tbl_b + div_bs(slot, p.bs, p.inv_bs))
                           : -1;
    }
    const int slot = base + tid % kRowKeys;
    phys_s = slot < lim ? __ldg(tbl_b + div_bs(slot, p.bs, p.inv_bs)) : -1;
  };
  // tile i (absolute key tile kt0 + i) into stage i % stages: codes and
  // scales of the slots before lim, zeros past it
  auto issue = [&](int i) {
    fetch(i);
    const int base = (kt0 + i) * kRowKeys;
    const uint32_t sk = smem_u32(smem_raw + (i % p.stages) * L.stage);
    const uint32_t sv = sk + kRowKeys * D, ssc = sv + kRowKeys * D;
    const int part = tid % kParts;
#pragma unroll
    for (int n = 0; n < kIssue; ++n) {
      const int sl = (tid + n * kThreads) / kParts, slot = base + sl;
      const int8_t* srck = p.kpool;
      const int8_t* srcv = p.vpool;
      int bytes = 0;
      if (phys[n] >= 0) {
        const long long at =
            (((long long)phys[n] * p.bs
              + (slot - div_bs(slot, p.bs, p.inv_bs) * p.bs)) * p.G + g) * D
            + part * 16;
        srck += at;
        srcv += at;
        bytes = 16;
      }
      cp_async16(sk + sl * D + part * 16, srck, bytes);
      cp_async16(sv + sl * D + part * 16, srcv, bytes);
    }
    if (tid < 2 * kRowKeys) {
      const int slot = base + tid % kRowKeys;
      const float* src = tid < kRowKeys ? p.kscale : p.vscale;
      if (phys_s >= 0)
        src += (long long)phys_s * p.bs
               + (slot - div_bs(slot, p.bs, p.inv_bs) * p.bs);
      cp_async4(ssc + tid * 4, src, phys_s >= 0 ? 4 : 0);
    }
  };
  // stage i % stages as exact bf16 codes, and its scales, into the
  // converted tile: [K tile | V tile | K scales | V scales]
  auto convert = [&](int i) {
    const unsigned char* st = smem_raw + (i % p.stages) * L.stage;
#pragma unroll 2
    for (int n = 0; n < 2 * kIssue; ++n) {
      const int c = tid + n * kThreads;
      const int side = c / (kRowKeys * kParts), cc = c % (kRowKeys * kParts);
      const int sl = cc / kParts, part = cc % kParts;
      const uint4 w = *reinterpret_cast<const uint4*>(
          st + side * kRowKeys * D + sl * D + part * 16);
      uint4* const dst = reinterpret_cast<uint4*>(
          kb + (side * kRowKeys + sl) * kPitch + part * 16);
      dst[0] = make_uint4(bf16x2_codes(w.x, 0), bf16x2_codes(w.x, 2),
                          bf16x2_codes(w.y, 0), bf16x2_codes(w.y, 2));
      dst[1] = make_uint4(bf16x2_codes(w.z, 0), bf16x2_codes(w.z, 2),
                          bf16x2_codes(w.w, 0), bf16x2_codes(w.w, 2));
    }
    if (tid < 2 * kRowKeys)
      reinterpret_cast<float*>(kb + 2 * kRowKeys * kPitch)[tid] =
          reinterpret_cast<const float*>(st + 2 * kRowKeys * D)[tid];
  };

  // the ring's first tiles in flight, a group each
  for (int i = 0; i < p.stages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // the tile's query rows as bf16 pieces [kP][kQT][kPitch], the smallest
  // first (zero past S*R)
  for (int e = tid; e < kQT * (D / 4); e += kThreads) {
    const int r = e / (D / 4), d = (e % (D / 4)) * 4;
    const int j = row0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < SR) {
      const QT* src = static_cast<const QT*>(p.q) + b * p.q_sb
                      + (j / p.R) * p.q_ss + (g * p.R + j % p.R) * p.q_sh + d;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = to_f32(src[k]);
    }
#pragma unroll
    for (int k = kP - 1; k >= 0; --k) {
      float h[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        h[u] = bf16_round(v[u]);
        v[u] = __fsub_rn(v[u], h[u]);
      }
      *reinterpret_cast<uint2*>(qs + (k * kQT + r) * kPitch + d) =
          make_uint2(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]));
    }
  }
  // the slab's rows ra = 16 slab + gr and rb = ra + 8: the last slot each
  // sees (-1: a row past S*R), and the slab's least and largest
  const int ra = slab * 16 + gr;
  auto qlim_of = [&](int r) {
    const int j = row0 + r;
    return j < SR
               ? min(__ldg(p.pos + (long long)b * p.S + j / p.R), last_slot)
               : -1;
  };
  const int qa = qlim_of(ra), qb = qlim_of(ra + 8);
  int wmax = max(qa, qb), wmin = min(qa, qb);
#pragma unroll
  for (int x = 1; x < 32; x <<= 1) {
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, x));
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, x));
  }
  __syncthreads();   // the query pieces staged; maxpos read by all
  // ldmatrix rows and columns: A (query rows, and V's B fragments read
  // transposed) and the K tile's B fragments; V from this warp's share
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int k_row = (lane & 7) + 8 * (lane >> 4), k_col = 8 * ((lane >> 3) & 1);
  const uint32_t q_at = smem_u32(qs + (slab * 16 + a_row) * kPitch + a_col);
  const uint32_t k_at = smem_u32(kb + k_row * kPitch + k_col);
  const uint32_t v_at = smem_u32(kb + (kRowKeys + a_row) * kPitch + a_col
                                 + share * (D / kSplit));
  uint32_t qf[kQRegs ? kKS : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) ldsm4(qf[kk], q_at + 32 * kk);
  }
  // the running acc of a row tile whose chunks all fold here (in the
  // workspace, read and written once a chunk): float4 (warp, n, lane)
  float4* const arun = split || p.ws == nullptr ? nullptr
      : reinterpret_cast<float4*>(
            p.ws + (((long long)b * p.G + g) * p.row_tiles + rt) * kQT * D)
        + warp * kNA * 32 + lane;

  float Mr[2] = {kNeg, kNeg}, Lr[2] = {0.f, 0.f};   // rows ra, rb
  int i = 0;   // the block's tile
  for (int c = c0; c < c1; ++c) {
    // the chunk's state, fresh
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    float acc[kNA][4];
#pragma unroll
    for (int n = 0; n < kNA; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const int t_end = min((c + 1) * kChunkTiles, kt1);
    for (int kt = c * kChunkTiles; kt < t_end; ++kt, ++i) {
      cp_async_wait_all_but(p.stages - 2);   // tile i landed (this thread's)
      __syncthreads();   // ... every thread's; tile i - 1 scored by all
      if (i + p.stages - 1 < n_tiles) issue(i + p.stages - 1);
      cp_async_commit();   // (empty past the last tile)
      convert(i);
      __syncthreads();
      const int k0 = kt * kRowKeys;
      // the tile wholly past the slab's rows: an identity
      if (k0 <= wmax) {
        const float* const ks_t =
            reinterpret_cast<const float*>(kb + 2 * kRowKeys * kPitch);
        const float* const vs_t = ks_t + kRowKeys;
        const uint32_t qt_at = fresh(q_at), kt_at = fresh(k_at);
        const uint32_t vt_at = fresh(v_at);

        // S = Q K^T: 16 x 64 a warp, 8 n-tiles of 8 slots
        float s[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
          uint32_t a[kP][4];
          if constexpr (kQRegs) {
#pragma unroll
            for (int u = 0; u < 4; ++u) a[0][u] = qf[kk][u];
          } else {
#pragma unroll
            for (int k = 0; k < kP; ++k)
              ldsm4(a[k], qt_at + 2 * (k * kQT * kPitch + 16 * kk));
          }
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            uint32_t bk[4];
            ldsm4(bk, kt_at + 2 * (16 * jp * kPitch + 16 * kk));
#pragma unroll
            for (int k = 0; k < kP; ++k) {
              mma_bf16(s[2 * jp], a[k], bk[0], bk[1]);
              mma_bf16(s[2 * jp + 1], a[k], bk[2], bk[3]);
            }
          }
        }

        // the online softmax of the chunk: element e of n-tile j is row
        // ra (e < 2) or rb, slot k0 + 8 j + 2 tq + (e & 1); a row's max
        // over its quad.  A tile wholly before the slab's positions takes
        // no mask (the same values: every select would keep the score)
        const bool whole = k0 + kRowKeys - 1 <= wmin;
        float mx[2] = {kNeg, kNeg};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 ks2 =
              *reinterpret_cast<const float2*>(ks_t + 8 * j + 2 * tq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int slot = k0 + 8 * j + 2 * tq + (e & 1);
            const float v = __fmul_rn(
                __fmul_rn(s[j][e], (e & 1) ? ks2.y : ks2.x), p.scale);
            s[j][e] = whole || slot <= (e < 2 ? qa : qb) ? v : kNeg;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          mx[h] = fmaxf(m[h], mx[h]);
          alpha[h] = exp_f(__fsub_rn(m[h], mx[h]));
          m[h] = mx[h];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int slot = k0 + 8 * j + 2 * tq + (e & 1);
            // masked slots add an exact 0, never exp of a huge negative
            const float pe = whole || slot <= (e < 2 ? qa : qb)
                                 ? exp_f(__fsub_rn(s[j][e], mx[e >> 1]))
                                 : 0.f;
            rs[e >> 1] = __fadd_rn(rs[e >> 1], pe);
            s[j][e] = pe;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), rs[h]);
#pragma unroll
        for (int n = 0; n < kNA; ++n) {
          acc[n][0] = __fmul_rn(acc[n][0], alpha[0]);
          acc[n][1] = __fmul_rn(acc[n][1], alpha[0]);
          acc[n][2] = __fmul_rn(acc[n][2], alpha[1]);
          acc[n][3] = __fmul_rn(acc[n][3], alpha[1]);
        }

        // acc += P' V, P' = p * v_scale in two bf16 pieces (lo, then
        // hi): k-step kk is n-tiles 2 kk and 2 kk + 1 of S (16 slots)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 2 * kk + (u >> 1), e = 2 * (u & 1);
            const float2 vs2 =
                *reinterpret_cast<const float2*>(vs_t + 8 * j + 2 * tq);
            const float x0 = __fmul_rn(s[j][e], vs2.x);
            const float x1 = __fmul_rn(s[j][e + 1], vs2.y);
            const float h0 = bf16_round(x0), h1 = bf16_round(x1);
            ahi[u] = pack_bf16(h0, h1);
            alo[u] = pack_bf16(__fsub_rn(x0, h0), __fsub_rn(x1, h1));
          }
#pragma unroll
          for (int np = 0; np < kNA / 2; ++np) {
            uint32_t bv[4];
            ldsm4_t(bv, vt_at + 2 * (16 * kk * kPitch + 16 * np));
            mma_bf16(acc[2 * np], alo, bv[0], bv[1]);
            mma_bf16(acc[2 * np + 1], alo, bv[2], bv[3]);
            mma_bf16(acc[2 * np], ahi, bv[0], bv[1]);
            mma_bf16(acc[2 * np + 1], ahi, bv[2], bv[3]);
          }
        }
      }
    }

    // the chunk's end: its l over the quad, (l0 + l1) + (l2 + l3)
    float lc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lc[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 1));
      lc[h] = __fadd_rn(lc[h], __shfl_xor_sync(0xffffffffu, lc[h], 2));
    }
    const int col = share * (D / kSplit) + 2 * tq;   // this thread's dims
    if (split) {
      // the chunk's state for the last block of the row tile
      float* const part = p.ws
          + ((((long long)b * p.G + g) * p.row_tiles + rt) * p.nc + c)
            * (kQT * (D + 2));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 8 * h;
        if (row0 + r >= SR) continue;
#pragma unroll
        for (int n = 0; n < kNA; ++n)
          store2(part + r * D + 8 * n + col, acc[n][2 * h],
                 acc[n][2 * h + 1]);
        if (tq == 0 && share == 0) {
          part[kQT * D + 2 * r] = m[h];
          part[kQT * D + 2 * r + 1] = lc[h];
        }
      }
      continue;
    }
    // fold the chunk into the warp's running state (from zero at the
    // first chunk: the same operations as on a zero read back); at the
    // last chunk, the output
    float f[2], fg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) fold_ml(Mr[h], Lr[h], m[h], lc[h], f[h], fg[h]);
    const bool first = c == c0;
    if (c + 1 < c1) {
#pragma unroll
      for (int n = 0; n < kNA; ++n) {
        float4 A = first ? make_float4(0.f, 0.f, 0.f, 0.f) : arun[n * 32];
        A.x = fold_a(A.x, acc[n][0], f[0], fg[0]);
        A.y = fold_a(A.y, acc[n][1], f[0], fg[0]);
        A.z = fold_a(A.z, acc[n][2], f[1], fg[1]);
        A.w = fold_a(A.w, acc[n][3], f[1], fg[1]);
        arun[n * 32] = A;
      }
    } else {
      const float den[2] = {fmaxf(Lr[0], 1e-30f), fmaxf(Lr[1], 1e-30f)};
      QT* const oa = row0 + ra < SR ? out_row<QT>(p, b, g, row0 + ra, D)
                                    : nullptr;
      QT* const ob = row0 + ra + 8 < SR
                         ? out_row<QT>(p, b, g, row0 + ra + 8, D)
                         : nullptr;
#pragma unroll
      for (int n = 0; n < kNA; ++n) {
        const float4 A =
            first ? make_float4(0.f, 0.f, 0.f, 0.f) : arun[n * 32];
        if (oa != nullptr)
          store2(oa + 8 * n + col,
                 __fdiv_rn(fold_a(A.x, acc[n][0], f[0], fg[0]), den[0]),
                 __fdiv_rn(fold_a(A.y, acc[n][1], f[0], fg[0]), den[0]));
        if (ob != nullptr)
          store2(ob + 8 * n + col,
                 __fdiv_rn(fold_a(A.z, acc[n][2], f[1], fg[1]), den[1]),
                 __fdiv_rn(fold_a(A.w, acc[n][3], f[1], fg[1]), den[1]));
      }
    }
  }
  if (!split) return;

  // ---- the ticket: the last block of the row tile folds its chunks ----
  __threadfence();   // this block's chunk states, visible card-wide
  __syncthreads();
  if (tid == 0) {
    int* const ticket =
        p.tickets + ((long long)b * p.G + g) * p.row_tiles + rt;
    const int n_ctas = (n_live + p.K - 1) / p.K;
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(ticket) : "memory");
    misc[1] = prev == n_ctas - 1;
    if (prev == n_ctas - 1) *ticket = 0;   // for the next launch
  }
  __syncthreads();
  if (!misc[1]) return;
  __threadfence();
  const float* const parts = p.ws
      + (((long long)b * p.G + g) * p.row_tiles + rt) * p.nc
        * (kQT * (D + 2));
  const int rows = min(kQT, SR - row0);
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float M = kNeg, Ls = 0.f, A = 0.f;
    for (int cc = 0; cc < n_live; ++cc) {
      const float* const pc = parts + (long long)cc * (kQT * (D + 2));
      float f, fg;
      fold_ml(M, Ls, __ldcg(pc + kQT * D + 2 * r),
              __ldcg(pc + kQT * D + 2 * r + 1), f, fg);
      A = fold_a(A, __ldcg(pc + r * D + d), f, fg);
    }
    store(out_row<QT>(p, b, g, row0 + r, D) + d,
          __fdiv_rn(A, fmaxf(Ls, 1e-30f)));
  }
}

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------

template <typename QT, int D, int W>
cudaError_t launch_rows(const RowsParams& p, int grid_x, int smem,
                        cudaStream_t stream) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(int8_kv_rows<QT, D, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemLimit);
    if (err != cudaSuccess) return err;
    // all of the SM's unified memory as shared memory: the plan counts
    // on two or three blocks an SM
    err = cudaFuncSetAttribute(int8_kv_rows<QT, D, W>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  int8_kv_rows<QT, D, W><<<dim3(grid_x, p.G, p.B), W == 8 ? 256 : 128, smem,
                           stream>>>(p);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_rows_d(const RowsParams& p, int D, int W, int grid_x,
                          int smem, cudaStream_t stream) {
  switch (W == 8 ? D * 9 + 8 : D * 8 + W) {
    case 64 * 8 + 1: return launch_rows<QT, 64, 1>(p, grid_x, smem, stream);
    case 64 * 8 + 2: return launch_rows<QT, 64, 2>(p, grid_x, smem, stream);
    case 64 * 8 + 4: return launch_rows<QT, 64, 4>(p, grid_x, smem, stream);
    case 64 * 9 + 8: return launch_rows<QT, 64, 8>(p, grid_x, smem, stream);
    case 128 * 8 + 1: return launch_rows<QT, 128, 1>(p, grid_x, smem, stream);
    case 128 * 8 + 2: return launch_rows<QT, 128, 2>(p, grid_x, smem, stream);
    case 128 * 8 + 4: return launch_rows<QT, 128, 4>(p, grid_x, smem, stream);
    case 128 * 9 + 8: return launch_rows<QT, 128, 8>(p, grid_x, smem, stream);
    case 256 * 8 + 1: return launch_rows<QT, 256, 1>(p, grid_x, smem, stream);
    case 256 * 8 + 2: return launch_rows<QT, 256, 2>(p, grid_x, smem, stream);
    default: return (cudaError_t)kErrPlan;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  if (err == kErrPlan)
    return "the launch plan is not one this library can run";
  return cudaGetErrorString((cudaError_t)err);
}

// q: (B, S, H, D) with unit stride on D (strides in elements); pools
// (nb, bs, G, D) int8 and scales (nb, bs) f32, contiguous, the pools
// starting on 16 bytes; tbl (B, M) and pos (B, S) int32, contiguous; out
// (B, S, H, D) contiguous in q's dtype.  ws and tickets sized for the
// plan (tickets zero; the launch leaves them zero): where it splits a row
// tile's chunks over blocks, chunk states of B * G * row tiles * chunks *
// q_tile * (D + 2) floats and B * G * row tiles tickets; else, where the
// table has more than one chunk, running accs of B * G * row tiles *
// q_tile * D floats.  `plan`: query rows a block, ring stages, threads,
// shared-memory bytes, chunks of the table, chunks a block and the grid's
// x, as int8_kv_plan computed them; the entry refuses a plan it cannot
// run.  Returns the CUDA error of the launch (0 on success) or
// kErrPlan.
int int8_kv_attention_rows(const void* q, const void* kpool,
                           const void* vpool, const void* kscale,
                           const void* vscale, const void* tbl,
                           const void* pos, void* out, void* ws,
                           void* tickets, int B, int S, int H, int G, int D,
                           int bs, int M, long long nb, long long q_sb,
                           long long q_ss, long long q_sh, const int* plan,
                           float scale, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || bs <= 0 || bs % 8 != 0
      || M <= 0 || nb <= 0 || (D != 64 && D != 128 && D != 256) ||
      (long long)M * bs > (1 << 24))
    return (int)cudaErrorInvalidValue;
  for (const void* t : {kpool, vpool})
    if ((reinterpret_cast<uintptr_t>(t) & 15) != 0)
      return (int)cudaErrorInvalidValue;
  const int qt = plan[0], stages = plan[1], nc = plan[4], K = plan[5];
  const int W = qt / 16;
  const long long SR = (long long)S * (H / G);
  const long long row_tiles = (SR + qt - 1) / qt;
  const long long groups = K >= 1 ? (nc + K - 1) / K : 0;
  const RowsLayout lay = rows_layout(D, W, is_bf16 ? 1 : 3, stages);
  if (qt < 16 || qt % 16 != 0 || (W != 1 && W != 2 && W != 4 && W != 8) ||
      (D == 256 && W > 2) || stages < 2 || stages > 4 ||
      plan[2] != (W == 8 ? 256 : 128) || plan[3] != lay.total ||
      lay.total > kSmemLimit ||
      nc != ((long long)M * bs + kRowChunk - 1) / kRowChunk || K < 1 ||
      plan[6] != row_tiles * groups || row_tiles * groups > INT_MAX ||
      B > 65535 || G > 65535 ||
      (groups > 1 && (ws == nullptr || tickets == nullptr)) ||
      (nc > 1 && ws == nullptr))
    return kErrPlan;
  RowsParams p{q, static_cast<const int8_t*>(kpool),
               static_cast<const int8_t*>(vpool),
               static_cast<const float*>(kscale),
               static_cast<const float*>(vscale),
               static_cast<const int*>(tbl), static_cast<const int*>(pos),
               out, static_cast<float*>(ws), static_cast<int*>(tickets), B,
               S, H, G, H / G, bs, M, nc, K, (int)groups, (int)row_tiles,
               stages, q_sb, q_ss, q_sh, scale, 1.f / (float)bs, lay};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch_rows_d<__nv_bfloat16>(p, D, W, plan[6],
                                                  (int)lay.total, s)
                   : launch_rows_d<float>(p, D, W, plan[6], (int)lay.total,
                                          s));
}

}  // extern "C"

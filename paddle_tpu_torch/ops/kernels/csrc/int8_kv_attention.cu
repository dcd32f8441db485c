// Int8 paged decode/verify attention for Hopper (sm_90a), with a plain C
// interface: two routes.  The decode route (`int8_kv_attn_sm90`, entry
// `int8_kv_attention`) takes every S = 1 call and is described first;
// the many-row route (`int8_kv_rows`, entry `int8_kv_attention_rows`,
// described beside its kernel below: tensor cores, a cp.async ring and
// 256-slot chunks folded in order, split over blocks for verify blocks)
// takes every S > 1 call: verify blocks and prefix-sharing suffix
// prefills of up to max_model_len query rows.
//
// Replaces: paddle_tpu/ops/pallas/kv_attention.py:84
// `_int8_kv_attn_kernel` (launched by `int8_paged_attention`): attention
// of the S*R query rows that share one kv head over a sequence's int8
// K/V pool blocks, found through its block table, with per-(block, slot)
// f32 scales, the `slot <= position` mask and an f32 online softmax.
//
// What bounds it on this card (the decode route; the many-row route's
// below): bytes.  Each decode query row does about 4*D flops per cached
// token against 2*D bytes of int8 K/V, two flops per byte, far below
// the H100's ~295; the least time is the valid tokens' int8 K/V (plus
// their scales) over 3.35 TB/s.
//
// What the design does about it (flash-decoding):
// - Split.  A sequence is cut into chunks of C = ceil(C0 / bs) * bs slots
//   (`int8_kv_plan` in kv_attention.py; C0 = 256, one constant), so a
//   long sequence spreads over many SMs and a batch of one still fills
//   the card.  A block runs K consecutive chunks of one (sequence, kv
//   head): the grid is (chunk group, kv head, sequence), K = 2 where the
//   chunks outnumber the blocks the card holds at once, else 1.  C
//   depends on nothing but bs and C0, and a chunk is computed the same
//   whatever K is (below): a sequence's output bits depend only on its
//   own queries, positions and blocks, whatever batch it is served in.
//   A block reads the sequence's largest position and exits before any
//   load when its chunks start past it.
// - Loads.  One producer thread streams the chunks through a ring of four
//   tiles of at most 32 slots in shared memory with TMA: K and V by 4-D
//   maps over the pools [nb, bs, KH, D] (box {D, 1, bs or 32, 1} at (0,
//   g, slot, phys), phys from the chunk's table entries staged in shared
//   memory), the two scale rows by 2-D maps over [nb, bs].  Four blocks
//   fit on an SM (39 KB of shared memory each at head_dim 128).  The
//   entry keeps encoded maps (1,024 of them, keyed on all a map
//   encodes), so a steady decode step of a 32-layer model (64 pools, 64
//   scale tensors) encodes none.
// - Compute, on CUDA cores (two flops a byte: tensor cores add nothing).
//   A chunk's tile k goes to consumer warp k % 4 (the chunk's own tile
//   index), each warp keeping its own online softmax (m, l and acc in
//   shared memory); a chunk's tiles are padded to a multiple of the warps
//   in the ring (padding tiles carry no data), so a stage always serves
//   the same warp.  A score is one slot's dot over eight lanes: each
//   holds D/8 dims of q in registers, reads the slot's codes with one 8-
//   or 16-byte shared load and converts them exactly (code ^ 0x80 placed
//   under the exponent of 2^23 by `__byte_perm`, minus 2^23 + 128), so a
//   warp scores four slots at once.  The K scale and 1/sqrt(D) multiply
//   each dot once; the V scale is folded into p, as (p * v_scale) *
//   code, in P.V, where each lane owns D/32 consecutive dims.
// - Merge, in the same launch.  The warps' states combine in warp order
//   into the chunk's (m, l, acc).  A sequence with one live chunk writes
//   its output at once.  Otherwise each chunk's partial goes to an f32
//   workspace; a sequence's block takes a ticket (every thread fences,
//   one acq_rel atomic at GPU scope) when the sequence has more than one
//   live block, and the last to take one (or the only block) reads the
//   partials back and merges them in chunk order 0, 1, ... (so a rerun
//   is bitwise equal), writes the output and resets the ticket, so the
//   tickets are zero between launches.
//
// Numerics follow the Pallas kernel: s = (q . code) * k_scale * 1/sqrt(D)
// (the reference: q . (code * k_scale) * 1/sqrt(D)), masked s = -1e30,
// m_new = max(m, max s), masked p exactly 0 (never exp of a huge
// negative), l = l*alpha + sum p, acc = acc*alpha + sum (p * v_scale) *
// code (the reference: p . (code * v_scale)), out = acc / max(l, 1e-30)
// rounded once to the query dtype.  The two folds, the per-warp states
// and the chunk merge (M = max m_c, l = sum l_c exp(m_c - M), acc = sum
// acc_c exp(m_c - M)) re-associate f32 sums and products, within the
// registered tolerance.  A row whose position lies before a live chunk
// (a verify row) leaves that chunk at m = -1e30, l = 0, acc = 0, and adds
// exactly zero to the merge; chunk 0 always holds slot 0, which every row
// sees.  Idle decode slots (table all trash block 0, position 0) produce
// finite output.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>
#include <stdio.h>

#include <initializer_list>
#include <mutex>

#include "sm90.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxWarps = 4;     // consumer warps, plus one producer warp
constexpr int kMaxStages = 4;    // tiles in the ring
constexpr int kTileSlots = 32;   // slots a tile at most
constexpr int kBoxSlots = 32;    // slots a TMA box at most
constexpr int kIt = kTileSlots / 4;   // score slots a lane holds
constexpr long long kSmemLimit = 232448;

// What C and bs fix, computed the same way by int8_kv_plan: a unit is one
// TMA box (a whole block when bs <= 32, else 32 slots of one; a box past
// the block's end reads zeros, masked); a tile is `tu` units.
struct Geo {
  int bx;      // slots a unit
  int ppb;     // units a block
  int tu;      // units a tile
  int ts;      // slots a tile
  int sp;      // bytes of a unit's scale row in shared memory (128-aligned)
  int cb;      // table blocks a chunk
};

__host__ __device__ inline Geo geo_of(int bs, int chunk) {
  Geo g;
  g.bx = bs <= kBoxSlots ? bs : kBoxSlots;
  g.ppb = (bs + g.bx - 1) / g.bx;
  g.tu = kTileSlots / g.bx;
  g.ts = g.tu * g.bx;
  g.sp = (g.bx * 4 + 127) / 128 * 128;
  g.cb = chunk / bs;
  return g;
}

// Byte offsets in the dynamic shared memory (from a 128-aligned base):
// the ring of stages, each K [tu][bx][D] int8, V the same, then the units'
// K and V scale rows; q [SR][D] f32; the warps' acc [warps][SR][D] f32;
// their p * v_scale rows [warps][ts] f32; their tile's slot positions
// and scale offsets [warps][2][ts] int; their (m, l) [warps][SR][2];
// the rows' positions [SR]; the chunk's table entries [cb]; the full and
// empty barriers [stages] each; the ticket's verdict.
struct Layout {
  long long stage, q, acc, pbuf, slot, ml, qpos, tbl, bar, flag, total;
};

__host__ __device__ inline Layout layout_of(const Geo& g, int D, int SR,
                                            int warps, int stages) {
  Layout L;
  L.stage = 2LL * g.tu * g.bx * D + 2LL * g.tu * g.sp;
  long long o = stages * L.stage;
  L.q = o;
  o += 4LL * SR * D;
  L.acc = o;
  o += 4LL * warps * SR * D;
  L.pbuf = o;
  o += 4LL * warps * g.ts;
  L.slot = o;
  o += 8LL * warps * g.ts;
  L.ml = o;
  o += 8LL * warps * SR;
  L.qpos = o;
  o += 4LL * SR;
  L.tbl = o;
  o += 4LL * g.cb;
  o = (o + 7) / 8 * 8;
  L.bar = o;
  o += 16LL * stages;
  L.flag = o;
  o += 16;
  L.total = o + 128;   // slack to align the base
  return L;
}

struct Params {
  const void* q;
  const int* tbl;
  const int* pos;
  void* out;
  float* ws;       // [B][G][nc][SR][D + 2] partials (acc, then m, l)
  int* tickets;    // [B][G], zero between launches
  int B, S, H, G, R, bs, M, nc;
  int K;           // chunks a block (consecutive, of one sequence and head)
  int warps, stages;
  Geo geo;
  Layout lay;
  long long q_sb, q_ss, q_sh;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// byte k of w (four int8 codes) as an exact f32: (code + 128) under the
// exponent of 2^23, minus 2^23 + 128
__device__ __forceinline__ float code_f32(uint32_t biased, int k) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + k))
         - 8388736.f;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// q's D/8 dims that lane `li` of a slot's eight lanes multiplies: one
// 8-byte piece at li * 8 (D = 64), else a 16-byte piece at li * 16 of
// each 128 bytes of the row (conflict-free shared loads)
template <int D>
__device__ __forceinline__ void load_q(const float* qrow, int li,
                                       float (&qv)[D / 8]) {
  if constexpr (D == 64) {
    const float4* s = reinterpret_cast<const float4*>(qrow + li * 8);
    const float4 a = s[0], b = s[1];
    qv[0] = a.x; qv[1] = a.y; qv[2] = a.z; qv[3] = a.w;
    qv[4] = b.x; qv[5] = b.y; qv[6] = b.z; qv[7] = b.w;
  } else {
#pragma unroll
    for (int seg = 0; seg < D / 128; ++seg) {
      const float4* s =
          reinterpret_cast<const float4*>(qrow + seg * 128 + li * 16);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 a = s[k];
        qv[seg * 16 + 4 * k + 0] = a.x;
        qv[seg * 16 + 4 * k + 1] = a.y;
        qv[seg * 16 + 4 * k + 2] = a.z;
        qv[seg * 16 + 4 * k + 3] = a.w;
      }
    }
  }
}

// this lane's part of q . codes over the same dims as load_q
template <int D>
__device__ __forceinline__ float dot_part(const int8_t* krow, int li,
                                          const float (&qv)[D / 8]) {
  constexpr int kW = D / 32;   // 32-bit words of codes a lane
  uint32_t w[kW];
  if constexpr (D == 64) {
    const uint2 x = *reinterpret_cast<const uint2*>(krow + li * 8);
    w[0] = x.x;
    w[1] = x.y;
  } else {
#pragma unroll
    for (int seg = 0; seg < D / 128; ++seg) {
      const uint4 x =
          *reinterpret_cast<const uint4*>(krow + seg * 128 + li * 16);
      w[seg * 4 + 0] = x.x;
      w[seg * 4 + 1] = x.y;
      w[seg * 4 + 2] = x.z;
      w[seg * 4 + 3] = x.w;
    }
  }
  // two sums (even and odd words) halve the chain of dependent FMAs
  float acc[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const uint32_t b = w[i] ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[i & 1] = fmaf(qv[4 * i + k], code_f32(b, k), acc[i & 1]);
  }
  return acc[0] + acc[1];
}

// the codes of this lane's D/32 consecutive dims of one V row
template <int D>
__device__ __forceinline__ void v_codes(const int8_t* vrow, int lane,
                                        float (&f)[D / 32]) {
  if constexpr (D == 64) {
    const uint32_t b =
        (uint32_t)*reinterpret_cast<const uint16_t*>(vrow + lane * 2)
        ^ 0x8080u;
    f[0] = code_f32(b, 0);
    f[1] = code_f32(b, 1);
  } else if constexpr (D == 128) {
    const uint32_t b =
        *reinterpret_cast<const uint32_t*>(vrow + lane * 4) ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = code_f32(b, k);
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(vrow + lane * 8);
    const uint32_t b0 = x.x ^ 0x80808080u, b1 = x.y ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = code_f32(b0, k);
      f[4 + k] = code_f32(b1, k);
    }
  }
}

template <typename QT>
__device__ __forceinline__ void store_out(const Params& p, int b, int g,
                                          int j, int d, int D, float v) {
  const int s = j / p.R, h = g * p.R + j % p.R;
  QT* og = static_cast<QT*>(p.out);
  store(og + (((long long)b * p.S + s) * p.H + h) * D + d, v);
}

// Where a chunk of the sequence reaches, up to its largest position
struct Chunk {
  int blk0;    // first table block
  int units;   // TMA boxes it needs
  int tiles;
  int nblk;    // table entries it reads
};

__device__ __forceinline__ Chunk chunk_of(const Params& p, int c, int maxpos,
                                          int n_blocks) {
  const Geo& ge = p.geo;
  Chunk k;
  k.blk0 = c * ge.cb;
  // the chunk's last slot needed, relative to its first
  const int last = min(maxpos, min(k.blk0 + ge.cb, n_blocks) * p.bs - 1)
                   - k.blk0 * p.bs;
  k.units = (last / p.bs) * ge.ppb + (last % p.bs) / ge.bx + 1;
  k.tiles = (k.units + ge.tu - 1) / ge.tu;
  k.nblk = last / p.bs + 1;
  return k;
}

// One block a (group of K chunks, kv head, sequence): blockIdx (x, y, z).
// A chunk's tiles go to warps by the chunk's own tile index, and the ring
// takes each chunk's tiles padded to a multiple of the warps (padding
// tiles carry no data), so a stage always serves the same warp and a
// chunk is computed the same whatever K is.  The launch bounds ask for
// four blocks an SM (at most 102 registers): without the second bound
// ptxas gave head_dim 256 96 registers and 28 bytes of spills.
template <typename QT, int D>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 4)
int8_kv_attn_sm90(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tks,
                  const __grid_constant__ CUtensorMap tvs, const Params p) {
  using namespace sm90;
  constexpr int kQ = D / 8, kV = D / 32;
  constexpr int kU = D == 256 ? 4 : 8;   // slots a step of P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* const sm = smem_raw + (base - raw);
  const Geo& ge = p.geo;
  const Layout& L = p.lay;
  const int g = blockIdx.y, b = blockIdx.z;
  const int SR = p.S * p.R;

  // the chunks up to the block holding the sequence's largest position
  // are live; a block whose chunks start past it exits before any load
  int maxpos = 0;
  for (int s = 0; s < p.S; ++s)
    maxpos = max(maxpos, __ldg(p.pos + (long long)b * p.S + s));
  const int n_blocks = min(p.M, maxpos / p.bs + 1);
  const int n_live = (n_blocks + ge.cb - 1) / ge.cb;
  const int c0 = blockIdx.x * p.K;
  if (c0 >= n_live) return;
  const int c1 = min(c0 + p.K, n_live);
  const int n_ctas = (n_live + p.K - 1) / p.K;   // live blocks of (b, g)

  float* const q_s = reinterpret_cast<float*>(sm + L.q);
  float* const acc_s = reinterpret_cast<float*>(sm + L.acc);
  float* const pbuf = reinterpret_cast<float*>(sm + L.pbuf);
  int* const slot_s = reinterpret_cast<int*>(sm + L.slot);
  float* const ml_s = reinterpret_cast<float*>(sm + L.ml);
  int* const qpos_s = reinterpret_cast<int*>(sm + L.qpos);
  int* const tbl_s = reinterpret_cast<int*>(sm + L.tbl);
  int* const flag_s = reinterpret_cast<int*>(sm + L.flag);
  const uint32_t bar_full = base + (uint32_t)L.bar;
  const uint32_t bar_empty = bar_full + 8 * p.stages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nct = p.warps * 32;   // consumer threads

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp < p.warps) {
    // q rows in f32 and their positions
    const QT* qg = static_cast<const QT*>(p.q) + b * p.q_sb;
    for (int e = threadIdx.x; e < SR * D; e += nct) {
      const int j = e / D, d = e % D;
      q_s[e] = to_f32(qg[(j / p.R) * p.q_ss + (g * p.R + j % p.R) * p.q_sh
                         + d]);
    }
    for (int j = threadIdx.x; j < SR; j += nct)
      qpos_s[j] = __ldg(p.pos + (long long)b * p.S + j / p.R);
  }
  __syncthreads();

  const int ring_k = ge.tu * ge.bx * D;   // bytes of a stage's K (and V)
  if (warp == p.warps) {
    // ---- producer: lane 0 issues every load, chunk after chunk ----
    int s = 0;
    uint32_t ph = 0;
    const uint32_t unit_bytes = 2u * ge.bx * D + 8u * ge.bx;
    for (int c = c0; c < c1; ++c) {
      const Chunk ch = chunk_of(p, c, maxpos, n_blocks);
      // the chunk's table entries, staged once (the previous chunk's
      // loads were issued with their coordinates in registers)
      __syncwarp();
      for (int i = lane; i < ch.nblk; i += 32)
        tbl_s[i] = __ldg(p.tbl + (long long)b * p.M + ch.blk0 + i);
      __syncwarp();
      if (lane != 0) continue;
      const int padded = (ch.tiles + p.warps - 1) / p.warps * p.warps;
      for (int k = 0; k < padded; ++k) {
        const uint32_t dst = base + (uint32_t)(s * L.stage);
        const uint32_t full = bar_full + 8 * s;
        // the stage's previous tile released (passes at once at first)
        mbar_wait(bar_empty + 8 * s, ph ^ 1);
        if (k < ch.tiles) {
          const int u0 = k * ge.tu, nu = min(ge.tu, ch.units - u0);
          mbar_expect_tx(full, nu * unit_bytes);
          for (int i = 0; i < nu; ++i) {
            const int u = u0 + i;
            const int phys = tbl_s[u / ge.ppb];
            const int slot = (u % ge.ppb) * ge.bx;
            tma_load(dst + i * ge.bx * D, &tk, full, 0, g, slot, phys);
            tma_load(dst + ring_k + i * ge.bx * D, &tv, full, 0, g, slot,
                     phys);
            tma_load_2d(dst + 2 * ring_k + i * ge.sp, &tks, full, slot,
                        phys);
            tma_load_2d(dst + 2 * ring_k + (ge.tu + i) * ge.sp, &tvs, full,
                        slot, phys);
          }
        } else {
          mbar_arrive(full);   // a padding tile
        }
        if (++s == p.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warps: chunk after chunk, each folds its tiles into its
  // own state; the states combine into the chunk's partial ----
  const int gi = lane >> 3, li = lane & 7;   // slot group, lane in it
  const int spf = ge.sp / 4;
  const int tid = threadIdx.x;
  const int rs = SR * (D + 2);   // floats of one partial
  float* const acc_w = acc_s + warp * SR * D;
  float* const ml_w = ml_s + warp * 2 * SR;
  float* const pb = pbuf + warp * ge.ts;
  int* const spos = slot_s + warp * 2 * ge.ts;
  int* const sscl = spos + ge.ts;
  int kt = 0;   // the ring's tiles before this chunk's
  for (int c = c0; c < c1; ++c) {
    const Chunk ch = chunk_of(p, c, maxpos, n_blocks);
    for (int e = lane; e < SR * D; e += 32) acc_w[e] = 0.f;
    for (int j = lane; j < SR; j += 32) {
      ml_w[2 * j] = kNeg;
      ml_w[2 * j + 1] = 0.f;
    }
    __syncwarp();
    const int padded = (ch.tiles + p.warps - 1) / p.warps * p.warps;
    for (int k = warp; k < padded; k += p.warps) {
      const int gk = kt + k;
      const int st = gk % p.stages;
      mbar_wait(bar_full + 8 * st, (uint32_t)((gk / p.stages) & 1));
      if (k < ch.tiles) {
        const int u0 = k * ge.tu;
        const int ns = min(ge.tu, ch.units - u0) * ge.bx;   // slots loaded
        const int8_t* const ks8 =
            reinterpret_cast<const int8_t*>(sm + st * L.stage);
        const int8_t* const vs8 = ks8 + ring_k;
        const float* const ksc =
            reinterpret_cast<const float*>(vs8 + ring_k);
        const float* const vsc = ksc + ge.tu * spf;
        // the tile's slots: absolute positions (INT_MAX past a block's
        // end) and scale offsets, once a tile
        for (int t = lane; t < ns; t += 32) {
          const int ul = t / ge.bx, i = t % ge.bx, u = u0 + ul;
          const int inb = (u % ge.ppb) * ge.bx + i;
          spos[t] = inb < p.bs ? (ch.blk0 + u / ge.ppb) * p.bs + inb
                               : INT_MAX;
          sscl[t] = ul * spf + i;
        }
        __syncwarp();
        for (int j = 0; j < SR; ++j) {
          const int qp = qpos_s[j];
          float qv[kQ];
          load_q<D>(q_s + j * D, li, qv);
          float sc[kIt];
          uint32_t ok = 0;   // bit it: slot 4 it + gi is valid for row j
          float mx = kNeg;
#pragma unroll
          for (int it = 0; it < kIt; ++it) {
            if (4 * it < ns) {
              const int t = 4 * it + gi;
              float dot = dot_part<D>(ks8 + t * D, li, qv);
              dot += __shfl_xor_sync(0xffffffffu, dot, 1);
              dot += __shfl_xor_sync(0xffffffffu, dot, 2);
              dot += __shfl_xor_sync(0xffffffffu, dot, 4);
              const float v = dot * ksc[sscl[t]] * p.scale;
              const bool valid = spos[t] <= qp;
              ok |= (uint32_t)valid << it;
              sc[it] = valid ? v : kNeg;
              mx = fmaxf(mx, sc[it]);
            }
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float m_prev = ml_w[2 * j], l_prev = ml_w[2 * j + 1];
          const float m_new = fmaxf(m_prev, mx);
          float sum = 0.f;
#pragma unroll
          for (int it = 0; it < kIt; ++it) {
            if (4 * it < ns) {
              const int t = 4 * it + gi;
              const bool valid = (ok >> it) & 1u;
              // masked slots add an exact 0, never exp of a huge negative
              const float pe = valid ? expf(sc[it] - m_new) : 0.f;
              sum += pe;
              if (li == 0) pb[t] = valid ? pe * vsc[sscl[t]] : 0.f;
            }
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
          const float alpha = expf(m_prev - m_new);
          __syncwarp();
          // P.V: (p * v_scale) * code over the tile's slots (a multiple of
          // 8), this lane's dims; kU slots' loads in flight at once, and
          // two sums (even and odd slots) to halve the chains of FMAs
          float pv[2][kV];
#pragma unroll
          for (int e = 0; e < kV; ++e) pv[0][e] = pv[1][e] = 0.f;
          for (int t = 0; t < ns; t += kU) {
            float pw[kU];
#pragma unroll
            for (int r = 0; r < kU; r += 4) {
              const float4 x = *reinterpret_cast<const float4*>(pb + t + r);
              pw[r] = x.x;
              pw[r + 1] = x.y;
              pw[r + 2] = x.z;
              pw[r + 3] = x.w;
            }
            float f[kU][kV];
#pragma unroll
            for (int r = 0; r < kU; ++r)
              v_codes<D>(vs8 + (t + r) * D, lane, f[r]);
#pragma unroll
            for (int r = 0; r < kU; ++r)
#pragma unroll
              for (int e = 0; e < kV; ++e)
                pv[r & 1][e] = fmaf(pw[r], f[r][e], pv[r & 1][e]);
          }
          float* const a = acc_w + j * D + lane * kV;
#pragma unroll
          for (int e = 0; e < kV; ++e)
            a[e] = a[e] * alpha + (pv[0][e] + pv[1][e]);
          __syncwarp();   // p's row and (m, l) read before rewritten
          if (lane == 0) {
            ml_w[2 * j] = m_new;
            ml_w[2 * j + 1] = l_prev * alpha + sum;
          }
          __syncwarp();
        }
      }
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }
    kt += padded;

    // the warps' states, combined in warp order into the chunk's: the
    // output of a sequence with one live chunk, else its partial
    bar_sync(1, nct);
    float* const part = p.ws + (((long long)b * p.G + g) * p.nc + c) * rs;
    for (int e = tid; e < SR * D; e += nct) {
      const int j = e / D, d = e % D;
      float m = kNeg;
      for (int w = 0; w < p.warps; ++w)
        m = fmaxf(m, ml_s[2 * (w * SR + j)]);
      float l = 0.f, a = 0.f;
      for (int w = 0; w < p.warps; ++w) {
        const float f = expf(ml_s[2 * (w * SR + j)] - m);
        l += ml_s[2 * (w * SR + j) + 1] * f;
        a += acc_s[(w * SR + j) * D + d] * f;
      }
      if (n_live == 1) {
        store_out<QT>(p, b, g, j, d, D, a / fmaxf(l, 1e-30f));
      } else {
        part[e] = a;
        if (d == 0) {
          part[SR * D + 2 * j] = m;
          part[SR * D + 2 * j + 1] = l;
        }
      }
    }
    bar_sync(1, nct);   // the states read before the next chunk's reset
  }
  if (n_live == 1) return;

  // ---- the ticket: the last live block of (sequence, head) merges ----
  __threadfence();   // this block's partials, visible card-wide
  bar_sync(1, nct);
  if (n_ctas > 1) {
    if (tid == 0) {
      int* const ticket = p.tickets + (long long)b * p.G + g;
      int prev;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(prev) : "l"(ticket) : "memory");
      flag_s[0] = prev == n_ctas - 1;
      if (prev == n_ctas - 1) *ticket = 0;   // for the next launch
    }
    bar_sync(1, nct);
    if (!flag_s[0]) return;
    __threadfence();
  }
  const float* const parts = p.ws + ((long long)b * p.G + g) * p.nc * rs;
  for (int e = tid; e < SR * D; e += nct) {
    const int j = e / D, d = e % D;
    float m = kNeg;
    for (int cc = 0; cc < n_live; ++cc)
      m = fmaxf(m, __ldcg(parts + cc * rs + SR * D + 2 * j));
    float l = 0.f, a = 0.f;
    for (int cc = 0; cc < n_live; ++cc) {
      const float* const pc = parts + cc * rs;
      const float f = expf(__ldcg(pc + SR * D + 2 * j) - m);
      l += __ldcg(pc + SR * D + 2 * j + 1) * f;
      a += __ldcg(pc + e) * f;
    }
    store_out<QT>(p, b, g, j, d, D, a / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------
// The many-row route: S > 1 (speculative verify blocks, prefix-sharing
// suffix prefills), `int8_kv_rows<q type, head_dim, warps>`
// ---------------------------------------------------------------------
//
// What bounds it: operations at a prefill (4 D flops a valid (query row,
// slot) pair at the bf16 tensor-core rate, against the valid tokens'
// int8 K/V once), bytes at a verify block (5 rows a kv head do 20 flops
// a byte).  The first design ran scores and P.V on the FMA pipe, whose
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

// Byte offsets of the many-row route's dynamic shared memory, computed
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

// Everything cuTensorMapEncodeTiled encodes: a map holds an address and
// a geometry, nothing of the allocation, so an equal key gives an equal
// map and a cached one is never stale.
struct MapKey {
  const void* ptr;
  int dtype, rank;
  cuuint64_t dims[4];
  cuuint64_t strides[3];
  cuuint32_t box[4];

  bool operator==(const MapKey& o) const {
    if (ptr != o.ptr || dtype != o.dtype || rank != o.rank) return false;
    for (int i = 0; i < 4; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i]) return false;
    for (int i = 0; i < 3; ++i)
      if (strides[i] != o.strides[i]) return false;
    return true;
  }
};

uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// 128 sets of 8 maps, each set replaced round robin: the 128 maps of a
// 32-layer model's decode step stay cached
int cached_map(EncodeTiledFn fn, CUtensorMap* map, const MapKey& key) {
  constexpr int kSets = 128, kWays = 8;
  struct Slot {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  static Slot slots[kSets][kWays];
  static int next[kSets];
  static std::mutex mu;
  uint64_t h = mix64(reinterpret_cast<uintptr_t>(key.ptr));
  for (int i = 0; i < 4; ++i) h = mix64(h ^ key.dims[i] ^ (key.box[i] << 20));
  const int set = (int)(h % kSets);
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int w = 0; w < kWays; ++w) {
      if (slots[set][w].used && slots[set][w].key == key) {
        *map = slots[set][w].map;
        return 0;
      }
    }
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const int rc = (int)fn(map, (CUtensorMapDataType)key.dtype, key.rank,
                         const_cast<void*>(key.ptr), key.dims, key.strides,
                         key.box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc == 0) {
    std::lock_guard<std::mutex> lock(mu);
    Slot& s = slots[set][next[set]];
    next[set] = (next[set] + 1) % kWays;
    s.key = key;
    s.map = *map;
    s.used = true;
  }
  return rc;
}

// a pool [nb, bs, G, D] int8 as (D, G, bs, nb), box {D, 1, bx, 1}
MapKey pool_key(const void* ptr, long long nb, int bs, int G, int D,
                int bx) {
  MapKey k{};
  k.ptr = ptr;
  k.dtype = (int)CU_TENSOR_MAP_DATA_TYPE_UINT8;
  k.rank = 4;
  k.dims[0] = D;
  k.dims[1] = G;
  k.dims[2] = bs;
  k.dims[3] = nb;
  k.strides[0] = D;
  k.strides[1] = (cuuint64_t)G * D;
  k.strides[2] = (cuuint64_t)bs * G * D;
  k.box[0] = D;
  k.box[1] = 1;
  k.box[2] = bx;
  k.box[3] = 1;
  return k;
}

// a scale tensor [nb, bs] f32 as (bs, nb), box {bx, 1}
MapKey scale_key(const void* ptr, long long nb, int bs, int bx) {
  MapKey k{};
  k.ptr = ptr;
  k.dtype = (int)CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  k.rank = 2;
  k.dims[0] = bs;
  k.dims[1] = nb;
  k.strides[0] = (cuuint64_t)bs * 4;
  k.box[0] = bx;
  k.box[1] = 1;
  return k;
}

// The kernel's shared-memory limit is raised once a device, to the most
// any plan takes
template <typename QT, int D>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p,
                   const int* plan, cudaStream_t stream) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(int8_kv_attn_sm90<QT, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemLimit);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  int8_kv_attn_sm90<QT, D><<<dim3((p.nc + p.K - 1) / p.K, p.G, p.B),
                             plan[3], plan[4], stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_d(const CUtensorMap (&maps)[4], const Params& p, int D,
                     const int* plan, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<QT, 64>(maps, p, plan, stream);
    case 128: return launch<QT, 128>(maps, p, plan, stream);
    case 256: return launch<QT, 256>(maps, p, plan, stream);
    default: return cudaErrorInvalidValue;
  }
}

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
  static char buf[160];
  if (err == kErrPlan)
    return "the launch plan is not one this library can run";
  if (err == kErrNoEncode)
    return "cuTensorMapEncodeTiled not found through the CUDA runtime";
  if (err >= kErrEncode) {
    static const char* names[4] = {"k_pool", "v_pool", "k_scale",
                                   "v_scale"};
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed for %s "
             "(CUresult %d)", names[((err - kErrEncode) % 16) & 3],
             (err - kErrEncode) / 16);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}

// q: (B, S, H, D) with unit stride on D (strides in elements); pools
// (nb, bs, G, D) int8 and scales (nb, bs) f32, contiguous, each starting
// on 16 bytes; tbl (B, M) and pos (B, S) int32, contiguous; out (B, S, H,
// D) contiguous in q's dtype.  ws: f32 partials of at least B * G *
// chunks * S * (H / G) * (D + 2) floats; tickets: B * G int32, zero (the
// launch leaves them zero).  `plan`: chunk slots, consumer warps, ring
// stages, threads, shared-memory bytes, chunks and chunks a block, as
// `int8_kv_plan` computed them; the entry refuses a plan it cannot run.
// Returns the CUDA error of the launch (0 on success) or one of this
// library's codes.
int int8_kv_attention(const void* q, const void* kpool, const void* vpool,
                      const void* kscale, const void* vscale,
                      const void* tbl, const void* pos, void* out, void* ws,
                      void* tickets, int B, int S, int H, int G, int D,
                      int bs, int M, long long nb, long long q_sb,
                      long long q_ss, long long q_sh, const int* plan,
                      float scale, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || bs <= 0 || bs % 8 != 0
      || M <= 0 || nb <= 0 || (D != 64 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  for (const void* t : {kpool, vpool, kscale, vscale})
    if ((reinterpret_cast<uintptr_t>(t) & 15) != 0)
      return (int)cudaErrorInvalidValue;
  const int chunk = plan[0], warps = plan[1], stages = plan[2];
  const int K = plan[6];
  if (chunk <= 0 || chunk % bs != 0 || warps < 1 || warps > kMaxWarps ||
      K < 1)
    return kErrPlan;
  const Geo ge = geo_of(bs, chunk);
  const int SR = S * (H / G);
  const Layout lay = layout_of(ge, D, SR, warps, stages);
  const long long nc = (M + ge.cb - 1) / ge.cb;
  // a stage serves one warp: the tile a warp waits on is never a stage's
  // next fill while its current one is in flight (a parity wait would
  // pass at once)
  if (stages < 1 || stages > kMaxStages || stages % warps != 0 ||
      plan[3] != (warps + 1) * 32 || plan[4] != lay.total ||
      lay.total > kSmemLimit || plan[5] != nc || nc > INT_MAX ||
      B > 65535 || G > 65535 ||
      (nc > 1 && (ws == nullptr || tickets == nullptr)))
    return kErrPlan;
  using namespace sm90;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  CUtensorMap maps[4] = {};
  const MapKey keys[4] = {pool_key(kpool, nb, bs, G, D, ge.bx),
                          pool_key(vpool, nb, bs, G, D, ge.bx),
                          scale_key(kscale, nb, bs, ge.bx),
                          scale_key(vscale, nb, bs, ge.bx)};
  for (int i = 0; i < 4; ++i) {
    const int rc = cached_map(fn, &maps[i], keys[i]);
    if (rc != 0) return kErrEncode + rc * 16 + i;
  }
  Params p{q, static_cast<const int*>(tbl), static_cast<const int*>(pos),
           out, static_cast<float*>(ws), static_cast<int*>(tickets), B, S,
           H, G, H / G, bs, M, (int)nc, K, warps, stages, ge, lay, q_sb,
           q_ss, q_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_d<__nv_bfloat16>(maps, p, D, plan, s)
                       : launch_d<float>(maps, p, D, plan, s));
}

// The many-row route (S > 1).  Same tensors and sizes as
// int8_kv_attention; ws and tickets as there, sized for the plan: where
// it splits a row tile's chunks over blocks, chunk states of B * G * row
// tiles * chunks * q_tile * (D + 2) floats and B * G * row tiles
// tickets; else, where the table has more than one chunk, running accs
// of B * G * row tiles * q_tile * D floats.  `plan`: query rows a block, ring stages, threads,
// shared-memory bytes, chunks of the table, chunks a block and the
// grid's x, as int8_kv_plan computed them (route "rows"); the entry
// refuses a plan it cannot run.
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

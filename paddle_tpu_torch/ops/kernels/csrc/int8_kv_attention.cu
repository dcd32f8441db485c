// Int8 paged decode/verify attention for Hopper (sm_90a), with a plain C
// interface: two routes.  The decode route (`int8_kv_attn_sm90`, entry
// `int8_kv_attention`) takes every S = 1 call and is described first;
// the many-row route (`int8_kv_rows`, entry `int8_kv_attention_rows`,
// described beside its kernel below) takes every S > 1 call: verify
// blocks and prefix-sharing suffix prefills of up to max_model_len
// query rows.
//
// Replaces: paddle_tpu/ops/pallas/kv_attention.py:84
// `_int8_kv_attn_kernel` (launched by `int8_paged_attention`): attention
// of the S*R query rows that share one kv head over a sequence's int8
// K/V pool blocks, found through its block table, with per-(block, slot)
// f32 scales, the `slot <= position` mask and an f32 online softmax.
//
// What bounds it on this card: bytes.  Each decode query row does about
// 4*D flops per cached token against 2*D bytes of int8 K/V, two flops
// per byte, far below the H100's ~295; the least time is the valid
// tokens' int8 K/V (plus their scales) over 3.35 TB/s.
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
// suffix prefills), `int8_kv_rows<q type, head_dim, rows a thread>`
// ---------------------------------------------------------------------
//
// A block owns a tile of QT = 16 * RM of the S*R query rows of one (kv
// head, sequence): blockIdx (row tile, kv head, sequence).  The rows are
// tiled over the grid, so no shape of S is too large.  Its 128 threads
// form 16 row groups (ty) of 8 lanes (tx); a thread owns rows ty * RM ..
// + RM - 1 of the tile.  Keys come in tiles of kRowKeys slots at fixed
// absolute slots [64 t, 64 t + 64), from slot 0 up to the block that
// holds the tile's largest position, gathered through the table with
// plain 16-byte loads (the next tile's bytes are loaded into registers
// while the current one is scored), their codes converted exactly to
// f32 in shared memory.  Scores and P.V run on the FMA pipe: a score is
// q . code in f32 (exact products for bf16 queries; f32 queries keep
// their bits), so this route has the decode route's numerics:
// s = (q . code) * k_scale * 1/sqrt(D), masked s = -1e30, masked p
// exactly 0, l = l * alpha + sum p, acc = acc * alpha + (p * v_scale) *
// code, out = acc / max(l, 1e-30).  Thread (ty, tx) scores slots
// tx + 8 i of its rows and owns their output dims tx * D/8 .. + D/8 - 1.
//
// Row independence (the bit contract prefix sharing rests on): a row's
// output depends only on its q, its position and its sequence's blocks.
// Every operation of a row runs in an order fixed by its own lane
// position within the row (the dot over d ascending, the 8 lanes' max and
// sum by xor-shuffle 1, 2, 4, P.V over the tile's slots ascending), the
// same in every instantiation of RM, and every row walks the key tiles
// from slot 0 in order.  A key tile past a row's position is fully
// masked for it and leaves (m, l, acc) bitwise unchanged (max(m, -1e30)
// = m, alpha = exp(0) = 1, every p an exact 0).  So the row's bits do not
// depend on S, the suffix's start or the tile it lands in: a cold prefill
// and a warm suffix prefill give the same bits at the positions they
// share.  Every product, sum and quotient is an explicit round-to-nearest
// intrinsic, so no contraction differs between instantiations.

constexpr int kRowKeys = 64;       // slots a key tile
constexpr int kRowThreads = 128;   // 16 row groups x 8 lanes

// Byte offsets of the many-row route's dynamic shared memory, computed
// the same way by kv_attention._rows_smem: q [QT][D + 4] f32, K and V
// codes [64][D + 4] f32 each, p * v_scale [QT][68] f32, the K and V
// scales [64] f32 each, the block's largest position.
struct RowsLayout {
  long long q, k, v, p, ks, vs, maxpos, total;
};

__host__ __device__ inline RowsLayout rows_layout(int D, int QT) {
  RowsLayout L;
  const long long row = 4LL * (D + 4);
  L.q = 0;
  L.k = L.q + QT * row;
  L.v = L.k + kRowKeys * row;
  L.p = L.v + kRowKeys * row;
  L.ks = L.p + 4LL * QT * (kRowKeys + 4);
  L.vs = L.ks + 4LL * kRowKeys;
  L.maxpos = L.vs + 4LL * kRowKeys;
  L.total = L.maxpos + 16;
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
  int B, S, H, G, R, bs, M;
  long long q_sb, q_ss, q_sh;
  float scale;
};

// the 16 codes of a 16-byte piece as exact f32, stored at dst
__device__ __forceinline__ void store_codes(float* dst, uint4 w) {
  const uint32_t x[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                         w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 f;
    f.x = code_f32(x[i], 0);
    f.y = code_f32(x[i], 1);
    f.z = code_f32(x[i], 2);
    f.w = code_f32(x[i], 3);
    reinterpret_cast<float4*>(dst)[i] = f;
  }
}

template <typename QT, int D, int RM>
__global__ void __launch_bounds__(kRowThreads)
int8_kv_rows(const RowsParams p) {
  constexpr int kQT = 16 * RM;            // query rows a block
  constexpr int kRow = D + 4;             // floats a q / K / V row
  constexpr int kP = kRowKeys + 4;        // floats a p row
  constexpr int kParts = D / 16;          // 16-byte pieces a slot row
  constexpr int kPieces = kRowKeys * kParts / kRowThreads;   // a thread's
  constexpr int kDims = D / 8;            // output dims a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RowsLayout L = rows_layout(D, kQT);
  float* const q_s = reinterpret_cast<float*>(smem_raw + L.q);
  float* const k_s = reinterpret_cast<float*>(smem_raw + L.k);
  float* const v_s = reinterpret_cast<float*>(smem_raw + L.v);
  float* const p_s = reinterpret_cast<float*>(smem_raw + L.p);
  float* const ks_s = reinterpret_cast<float*>(smem_raw + L.ks);
  float* const vs_s = reinterpret_cast<float*>(smem_raw + L.vs);
  int* const maxpos_s = reinterpret_cast<int*>(smem_raw + L.maxpos);
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int SR = p.S * p.R;
  const int row0 = blockIdx.x * kQT;

  // the tile's q rows in f32 (rows past S*R are zero and never stored)
  if (tid == 0) *maxpos_s = -1;
  const QT* const qg = static_cast<const QT*>(p.q) + b * p.q_sb;
  for (int e = tid; e < kQT * D; e += kRowThreads) {
    const int lr = e / D, d = e % D, j = row0 + lr;
    q_s[lr * kRow + d] =
        j < SR ? to_f32(qg[(j / p.R) * p.q_ss + (g * p.R + j % p.R) * p.q_sh
                           + d])
               : 0.f;
  }
  // this thread's rows' positions (-1: a row past S*R, nothing valid)
  int qpos[RM];
  int mine = -1;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int j = row0 + ty * RM + r;
    qpos[r] = j < SR ? __ldg(p.pos + (long long)b * p.S + j / p.R) : -1;
    mine = max(mine, qpos[r]);
  }
  __syncthreads();
  if (tx == 0 && mine >= 0) atomicMax(maxpos_s, mine);
  __syncthreads();
  const int maxpos = *maxpos_s;
  // keys up to the table block holding the tile's largest position
  const int lim = min(p.M, maxpos / p.bs + 1) * p.bs;
  const int n_tiles = maxpos < 0 ? 0 : (lim + kRowKeys - 1) / kRowKeys;

  // a thread's pieces of a key tile: K and V codes, one scale
  uint4 kr[kPieces], vr[kPieces];
  float sc_r = 0.f;
  auto fetch = [&](int t) {
#pragma unroll
    for (int n = 0; n < kPieces; ++n) {
      const int c = tid + n * kRowThreads;
      const int slot = t * kRowKeys + c / kParts;
      kr[n] = vr[n] = make_uint4(0u, 0u, 0u, 0u);
      if (slot < lim) {
        const long long phys = __ldg(p.tbl + (long long)b * p.M + slot / p.bs);
        const long long at =
            ((phys * p.bs + slot % p.bs) * p.G + g) * D + (c % kParts) * 16;
        kr[n] = __ldg(reinterpret_cast<const uint4*>(p.kpool + at));
        vr[n] = __ldg(reinterpret_cast<const uint4*>(p.vpool + at));
      }
    }
    const int slot = t * kRowKeys + (tid % kRowKeys);
    sc_r = 0.f;
    if (slot < lim) {
      const long long phys = __ldg(p.tbl + (long long)b * p.M + slot / p.bs);
      const float* const src = tid < kRowKeys ? p.kscale : p.vscale;
      sc_r = __ldg(src + phys * p.bs + slot % p.bs);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int n = 0; n < kPieces; ++n) {
      const int c = tid + n * kRowThreads;
      const int off = (c / kParts) * kRow + (c % kParts) * 16;
      store_codes(k_s + off, kr[n]);
      store_codes(v_s + off, vr[n]);
    }
    (tid < kRowKeys ? ks_s : vs_s)[tid % kRowKeys] = sc_r;
  };

  float m[RM], l[RM], acc[RM][kDims];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[r][e] = 0.f;
  }
  if (n_tiles > 0) fetch(0);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();   // the previous tile's K, V and p read
    stash();
    __syncthreads();
    if (t + 1 < n_tiles) fetch(t + 1);   // in flight while this tile runs

    // scores: rows ty * RM + r, slots tx + 8 i
    float s[RM][8];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[r][i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RM], kv[8];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        qv[r] = *reinterpret_cast<const float4*>(
            q_s + (ty * RM + r) * kRow + d);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        kv[i] = *reinterpret_cast<const float4*>(k_s + (tx + 8 * i) * kRow
                                                 + d);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float a = s[r][i];
          a = __fmaf_rn(qv[r].x, kv[i].x, a);
          a = __fmaf_rn(qv[r].y, kv[i].y, a);
          a = __fmaf_rn(qv[r].z, kv[i].z, a);
          a = __fmaf_rn(qv[r].w, kv[i].w, a);
          s[r][i] = a;
        }
    }
    // the online softmax of each row over this tile
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float mx = kNeg;
      uint32_t ok = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int sl = tx + 8 * i;
        const bool valid = t * kRowKeys + sl <= qpos[r];
        ok |= (uint32_t)valid << i;
        s[r][i] = valid ? __fmul_rn(__fmul_rn(s[r][i], ks_s[sl]), p.scale)
                        : kNeg;
        mx = fmaxf(mx, s[r][i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
      float* const prow = p_s + (ty * RM + r) * kP;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int sl = tx + 8 * i;
        const bool valid = (ok >> i) & 1u;
        // masked slots add an exact 0, never exp of a huge negative
        const float pe = valid ? expf(__fsub_rn(s[r][i], m_new)) : 0.f;
        sum = __fadd_rn(sum, pe);
        prow[sl] = valid ? __fmul_rn(pe, vs_s[sl]) : 0.f;
      }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 4));
      const float alpha = expf(__fsub_rn(m[r], m_new));
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha), sum);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[r][e] = __fmul_rn(acc[r][e], alpha);
    }
    __syncwarp();   // a row's p written by the 8 lanes of its group
    // P.V over the tile's slots in order: (p * v_scale) * code
#pragma unroll 2
    for (int sl = 0; sl < kRowKeys; ++sl) {
      float pr[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) pr[r] = p_s[(ty * RM + r) * kP + sl];
      const float* const vrow = v_s + sl * kRow + tx * kDims;
#pragma unroll
      for (int e4 = 0; e4 < kDims; e4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(vrow + e4);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          acc[r][e4] = __fmaf_rn(pr[r], v.x, acc[r][e4]);
          acc[r][e4 + 1] = __fmaf_rn(pr[r], v.y, acc[r][e4 + 1]);
          acc[r][e4 + 2] = __fmaf_rn(pr[r], v.z, acc[r][e4 + 2]);
          acc[r][e4 + 3] = __fmaf_rn(pr[r], v.w, acc[r][e4 + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int j = row0 + ty * RM + r;
    if (j >= SR) continue;
    const float den = fmaxf(l[r], 1e-30f);
    QT* const o = static_cast<QT*>(p.out)
        + (((long long)b * p.S + j / p.R) * p.H + g * p.R + j % p.R) * D
        + tx * kDims;
#pragma unroll
    for (int e = 0; e < kDims; ++e) store(o + e, __fdiv_rn(acc[r][e], den));
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

template <typename QT, int D, int RM>
cudaError_t launch_rows(const RowsParams& p, int grid_x, int smem,
                        cudaStream_t stream) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(int8_kv_rows<QT, D, RM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemLimit);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  int8_kv_rows<QT, D, RM><<<dim3(grid_x, p.G, p.B), kRowThreads, smem,
                            stream>>>(p);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_rows_d(const RowsParams& p, int D, int RM, int grid_x,
                          int smem, cudaStream_t stream) {
  switch (D * 8 + RM) {
    case 64 * 8 + 1: return launch_rows<QT, 64, 1>(p, grid_x, smem, stream);
    case 64 * 8 + 2: return launch_rows<QT, 64, 2>(p, grid_x, smem, stream);
    case 64 * 8 + 4: return launch_rows<QT, 64, 4>(p, grid_x, smem, stream);
    case 128 * 8 + 1: return launch_rows<QT, 128, 1>(p, grid_x, smem, stream);
    case 128 * 8 + 2: return launch_rows<QT, 128, 2>(p, grid_x, smem, stream);
    case 128 * 8 + 4: return launch_rows<QT, 128, 4>(p, grid_x, smem, stream);
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
// int8_kv_attention, no workspace.  `plan`: query rows a block, slots a
// key tile, threads, shared-memory bytes and row tiles, as int8_kv_plan
// computed them (route "rows"); the entry refuses a plan it cannot run.
int int8_kv_attention_rows(const void* q, const void* kpool,
                           const void* vpool, const void* kscale,
                           const void* vscale, const void* tbl,
                           const void* pos, void* out, int B, int S, int H,
                           int G, int D, int bs, int M, long long nb,
                           long long q_sb, long long q_ss, long long q_sh,
                           const int* plan, float scale, int is_bf16,
                           void* stream) {
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || bs <= 0 || bs % 8 != 0
      || M <= 0 || nb <= 0 || (D != 64 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  for (const void* t : {kpool, vpool})
    if ((reinterpret_cast<uintptr_t>(t) & 15) != 0)
      return (int)cudaErrorInvalidValue;
  const int qt = plan[0], RM = qt / 16;
  const long long SR = (long long)S * (H / G);
  const RowsLayout lay = rows_layout(D, qt);
  if (qt % 16 != 0 || (RM != 1 && RM != 2 && RM != 4) ||
      (D == 256 && RM == 4) || plan[1] != kRowKeys ||
      plan[2] != kRowThreads || plan[3] != lay.total ||
      lay.total > kSmemLimit || plan[4] != (SR + qt - 1) / qt ||
      plan[4] > INT_MAX || B > 65535 || G > 65535)
    return kErrPlan;
  RowsParams p{q, static_cast<const int8_t*>(kpool),
               static_cast<const int8_t*>(vpool),
               static_cast<const float*>(kscale),
               static_cast<const float*>(vscale),
               static_cast<const int*>(tbl), static_cast<const int*>(pos),
               out, B, S, H, G, H / G, bs, M, q_sb, q_ss, q_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch_rows_d<__nv_bfloat16>(p, D, RM, plan[4],
                                                  (int)lay.total, s)
                   : launch_rows_d<float>(p, D, RM, plan[4], (int)lay.total,
                                          s));
}

}  // extern "C"

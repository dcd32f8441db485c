// Int8 matrix product with a per-column rescale for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces: paddle_tpu/ops/pallas/int8_matmul.py:62
// `_int8_matmul_kernel` (launched by `int8_matmul_pallas`): out[m, n] =
// f32(sum_k x[m, k] * w[k, n]) * scale[n] in the compute dtype, where x and
// w are int8 and the sum is int32 (dynamic mode), or out = x @ (w dequantised
// to the compute dtype) with f32 sums (weight-only mode).
//
// What bounds it on this card: bytes for most GEMMs of an int8 ResNet-50
// forward.  A conv's GEMM does 2*K operations per output element against
// about K bytes of int8 input row and 2-4 bytes of output, so below
// N ~ 300 it stays under the ~590 int8 operations per byte the H100 needs
// before its 1,979 TOP/s int8 tensor cores are the limit.  The 3x3
// convolutions of layer3 and layer4 at batch 32 (K 2,304 and 4,608) are
// near that line or above it (operations), and at batch 1 every GEMM past
// layer2 is a few weight bytes read by too few tiles to fill the card.
//
// What the design does about it, in dynamic mode (`int8_mm_sm90`, entry
// `int8_matmul_dynamic`):
// - a launch plan from Python (`int8_mm_plan`, from the card's SM count)
//   gives the tile (64 or 128 rows: one or two consumer warpgroups; 64 or
//   128 columns), the ring depth and the grid;
// - x [M, K] and w [N, K] (both K-major, the only layout 8-bit wgmma
//   takes) are loaded by TMA through 2-D tensor maps in 128-byte k-tiles
//   (one 128-byte swizzle row), into a ring in shared memory with full
//   and empty mbarriers; one producer warp issues every load.  TMA's zero
//   fill past the ends replaces the tail handling at the M and N edges
//   and past K; both maps end K at a multiple of 16 (a box that crosses
//   a row's end elsewhere loads several times slower: the stem's K = 147
//   in rows of pitch 160), and w is zero there, so whatever x holds in
//   its pad bytes adds nothing.  Zeros add nothing to integer sums;
// - each consumer warpgroup multiplies its 64 rows by wgmma m64n64k32 or
//   m64n128k32 s8.s8 -> s32 (four steps a k-tile), both operands from
//   shared memory, one commit group in flight, and releases a stage as
//   soon as the group that read it has retired;
// - persistent: at most one block an SM walks its items (i, i + grid,
//   ...), N tiles fastest so that neighbouring blocks share x's rows in
//   L2; the next item's loads run under the current item's products and
//   epilogue.  Each tile walks all of K: no split of K (a reduction of
//   split sums across blocks cost more than it saved at every GEMM of
//   the int8 ResNet-50, PERF.md section 6);
// - epilogue: __int2float_rn(acc) * scale[n] (one f32 rounding, as the
//   reference's f32 product), rounded to nearest even to bf16 or f32,
//   staged in shared memory in the 128-byte swizzle (conflict-free) and
//   written by TMA stores, which clip rows and columns past the ends; an
//   output whose row pitch is not a multiple of 16 bytes (TMA's rule; N =
//   33 at bf16) is copied out of the staging tile row by row with
//   coalesced stores instead.
// ptxas -v (nvcc 12.9, sm_90a): 164 (f32) and 168 (bf16) registers with
// 128 columns a tile, 108 and 106 with 64, no spill; up to 230,528 bytes
// of dynamic shared memory.
//
// Weight-only mode (`int8_wonly`, entry `int8_matmul_weight_only`): x is
// float, the weight int8; out = x @ cdt(cdt(q) * cdt(scale))^T with f32
// sums, rounded once to the compute dtype, as the reference.  At the
// weight-only ResNet-50's classifier (M = batch 1-128, K = 2,048, N =
// 1,000) the 2 MB of int8 weight bounds it (bytes; f32 at M = 128 is
// bound by its FMAs), and one 64-row tile of N alone leaves 16 blocks for
// 132 SMs.  What the design does about it:
// - a plan from Python (`int8_wonly_plan`) splits K into whole 64-wide
//   chunks across the blocks of a cluster (at most 8), so that tiles x
//   splits fill the card (16 x 8 = 128 blocks at the classifier); a block
//   is 64 weight rows by 8-128 rows of x (f32: 8-64; more rows of x:
//   more tiles);
// - each block streams its weight rows (16-byte pieces) and its rows of x
//   through a cp.async ring (8 chunks deep at up to 16 rows of x, else 4),
//   zero-filling past M, N and K;
// - bf16: the weight is dequantised in registers straight into the
//   tensor cores' A fragments (the weight as A, x as B: out^T = W x^T),
//   so no dequantised weight reaches shared or device memory.  At 8-64
//   rows of x by mma.sync m16n8k16 (N takes the 16-row side, M the 8-wide
//   one), K permuted alike in both operands so that each thread reads 16
//   consecutive weight bytes; at 128 by wgmma m64n128k16 with x as a
//   K-major B in 128-byte swizzled shared memory (1.11x faster than
//   mma.sync there on an H100);
// - f32: each chunk's weight is dequantised once into shared memory and
//   summed by FMA (up to 16 rows of x: dequantised in registers as bf16's
//   fragments, each quad of threads adding its four sums at the end; 32
//   and 64: dequantised once into shared memory, 8 x 2-4 outputs a
//   thread, k in order; no TF32: the registered tolerance is rtol 1e-5);
// - each block leaves its f32 partial tile in shared memory, the cluster
//   meets, and each block adds a slice of the tile across the cluster's
//   partials (distributed shared memory) in split order and writes it:
//   bitwise the same on a rerun, no float atomics and no workspace in
//   device memory (a ticket and one merging block took 5x as long at 128
//   rows of x and 8 splits on an H100: that block read the partials
//   alone).
// ptxas -v (nvcc 12.9, sm_90a): 64-128 registers (bf16, 8-128 rows of x)
// and 80-128 (f32, 8-64), no spill; up to 103,424 bytes of dynamic shared
// memory on the plan's blocks.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>
#include <stdio.h>

#include <mutex>

#include "sm90.cuh"

namespace {

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------
// dynamic mode: TMA, mbarriers, wgmma s8
// ---------------------------------------------------------------------

namespace sm90 {

constexpr int kBK = 128;           // int8 bytes of K a k-tile
constexpr int kMaxStages = 8;
constexpr int kMaxThreads = 2 * 128 + 32;   // two consumer warpgroups + one
                                            // producer warp
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may have
constexpr int kBarBytes = 2 * 8 * kMaxStages;   // full and empty mbarriers

// The dynamic shared memory of a plan (the Python plan computes the same):
// 1,024 bytes of slack to align the swizzled tiles, the ring of x and w
// k-tiles, a 64-row output staging tile a consumer warpgroup, mbarriers.
constexpr int smem_bytes(int bm, int bn, int stages, int elt) {
  return 1024 + stages * (bm + bn) * kBK + (bm / 64) * 64 * bn * elt
         + kBarBytes;
}

struct Params {
  const float* scale;   // [N] f32: x_scale * w_scale
  void* out;            // [M, N] f32 or bf16, contiguous
  int M, N;
  int tiles_n, k_tiles, items;
  int wgs;              // consumer warpgroups: block_m / 64
  int stages;
  int tma_store;
};

// Item i: the output tile (i / tiles_n, i % tiles_n), N tile fastest;
// its first row and column
struct Item {
  int m0, n0;
};

template <int BN>
__device__ __forceinline__ Item item_of(const Params& p, int i) {
  return Item{(i / p.tiles_n) * 64 * p.wgs, (i % p.tiles_n) * BN};
}

// Byte offset of (row r, column c) in a warpgroup's 64 x BN output
// staging tile: 128-byte panels of 64 rows, each row's 16-byte chunks
// swizzled by r % 8 (the layout of a 128-byte-swizzle TMA store box)
template <typename OT>
__device__ __forceinline__ uint32_t staged(int r, int c) {
  const int b = c * (int)sizeof(OT);
  return (b / 128) * (64 * 128) + r * 128
         + ((((b % 128) / 16) ^ (r % 8)) * 16) + b % 16;
}

template <int BN, typename OT>
__global__ void __launch_bounds__(kMaxThreads, 1)
int8_mm_sm90(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap to, const Params p) {
  constexpr int kAcc = BN / 2;                           // s32 a thread
  constexpr int kOutBytes = 64 * BN * (int)sizeof(OT);  // a warpgroup's
  constexpr int kPanelCols = 128 / (int)sizeof(OT);     // staging tile
  extern __shared__ __align__(128) unsigned char smem_i8[];
  // swizzled tiles need 1024-byte alignment
  const uint32_t base = (smem_u32(smem_i8) + 1023u) & ~1023u;
  unsigned char* const gbase = smem_i8 + (base - smem_u32(smem_i8));
  const uint32_t a_bytes = p.wgs * 64 * kBK;             // x's k-tile
  const uint32_t stage_bytes = a_bytes + BN * kBK;      // + w's
  const uint32_t sOut = base + p.stages * stage_bytes;  // [warpgroup]
  const uint32_t bar_full = sOut + p.wgs * kOutBytes;   // [stage]
  const uint32_t bar_empty = bar_full + 8 * kMaxStages; // [stage]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * p.wgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * p.wgs) {
    // ---- producer warp: one thread issues every load ----
    if (lane == 0) {
      int s = 0, ph = 0;   // ring slot and the parity of its phase
      for (int i = blockIdx.x; i < p.items; i += gridDim.x) {
        const Item w = item_of<BN>(p, i);
        for (int kb = 0; kb < p.k_tiles; ++kb) {
          const uint32_t dst = base + s * stage_bytes;
          // the slot's previous tile released (passes at once at first)
          mbar_wait(bar_empty + 8 * s, ph ^ 1);
          mbar_expect_tx(bar_full + 8 * s, stage_bytes);
          tma_load_2d(dst, &tx, bar_full + 8 * s, kb * kBK, w.m0);
          tma_load_2d(dst + a_bytes, &tw, bar_full + 8 * s, kb * kBK, w.n0);
          if (++s == p.stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each ----
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int g = lane / 4;                        // accumulator row group
  const int t = lane % 4;                        // thread in the quad
  const int lr_a = (warp % 4) * 16 + g;          // local rows lr_a, lr_a + 8
  const uint32_t so = sOut + wg * kOutBytes;     // its staging tile
  OT* const out = static_cast<OT*>(p.out);
  auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * slot);
  };
  int acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0;
  int s = 0, ph = 0, prev = 0;
  for (int i = blockIdx.x; i < p.items; i += gridDim.x) {
    const Item w = item_of<BN>(p, i);
    for (int kb = 0; kb < p.k_tiles; ++kb) {
      const uint32_t a = base + s * stage_bytes;
      const uint64_t da = sw128_desc(a + wg * 64 * kBK, 16, 1024);
      const uint64_t db = sw128_desc(a + a_bytes, 16, 1024);
      mbar_wait(bar_full + 8 * s, ph);
      wgmma_fence();
      // four k32 steps, 32 bytes apart; the item's first overwrites acc
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8_ss(acc, da + 2 * kk, db + 2 * kk, kb > 0 || kk > 0);
      wgmma_commit();
      fence_regs(acc);
      if (kb > 0) {
        // the previous k-tile's group has retired: release its stage
        wgmma_wait<1>();
        fence_regs(acc);
        release(prev);
      }
      prev = s;
      if (++s == p.stages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(prev);

    // accumulator element r: local row lr_a (+8 if bit 1 of r), local
    // column 8 * (r / 4) + 2 * t + (r & 1)
    const int row0 = w.m0 + wg * 64;

    // rescale and round into the staging tile, once the previous item's
    // TMA store has read it
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    named_sync<128>(1 + wg);
#pragma unroll
    for (int r = 0; r < kAcc; r += 2) {
      const int c = 8 * (r / 4) + 2 * t;
      const int col = w.n0 + c;
      const float s0 = col < p.N ? __ldg(p.scale + col) : 0.f;
      const float s1 = col + 1 < p.N ? __ldg(p.scale + col + 1) : 0.f;
      const float v0 = __int2float_rn(acc[r]) * s0;
      const float v1 = __int2float_rn(acc[r + 1]) * s1;
      const uint32_t addr = so + staged<OT>(lr_a + ((r & 2) ? 8 : 0), c);
      if constexpr (sizeof(OT) == 2) {
        asm volatile("st.shared.b32 [%0], %1;\n"
                     :: "r"(addr), "r"(pack_bf16x2(v0, v1)) : "memory");
      } else {
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                     :: "r"(addr), "f"(v0), "f"(v1) : "memory");
      }
    }
    // the writes must be visible to the async proxy before TMA reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync<128>(1 + wg);
    if (row0 >= p.M) continue;
    if (p.tma_store) {
      if (tid == 0) {
        for (int c = 0; c < BN && w.n0 + c < p.N; c += kPanelCols)
          tma_store_2d(&to, so + (c / kPanelCols) * (64 * 128), w.n0 + c,
                       row0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
      // consecutive threads take consecutive columns of a row
      const unsigned char* const sp = gbase + (so - base);
      for (int e = tid; e < 64 * BN; e += 128) {
        const int r = e / BN, c = e % BN;
        const int row = row0 + r, col = w.n0 + c;
        if (row < p.M && col < p.N)
          out[(long long)row * p.N + col] =
              *reinterpret_cast<const OT*>(sp + staged<OT>(r, c));
      }
    }
  }
  // the last TMA store has read its staging tile before the block exits
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The kernel's shared-memory limit is raised once a device, to the most
// any plan takes: setting it to each launch's own size every time costs
// the host far more than the launch (plans alternate between sizes)
template <int BN, typename OT>
cudaError_t launch_dyn(const CUtensorMap (&maps)[3], const Params& p,
                       const int* plan, cudaStream_t stream) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(int8_mm_sm90<BN, OT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  int8_mm_sm90<BN, OT><<<plan[5], plan[3], plan[4], stream>>>(
      maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

}  // namespace sm90

// The tensor maps of recent launches, by everything encoded into them: a
// map holds an address and a geometry, nothing of the allocation, so an
// equal key gives an equal map.  A forward sends the same weights, and
// the caching allocator gives each layer the same activation and output
// buffers forward after forward, so in a steady run a launch encodes
// nothing (an int8 forward at batch 1 is bound by the host's time a
// launch).
struct MapKey {
  const void* ptr;
  long long inner, outer, pitch;
  int dtype, box_inner, box_outer;

  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer &&
           pitch == o.pitch && dtype == o.dtype && box_inner == o.box_inner &&
           box_outer == o.box_outer;
  }
};

int cached_map_2d(EncodeTiledFn fn, CUtensorMap* map,
                  CUtensorMapDataType dtype, const void* ptr,
                  long long inner, long long outer, long long pitch,
                  int box_inner, int box_outer) {
  struct Slot {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  constexpr uint64_t kSlots = 256;
  static Slot slots[kSlots];
  static std::mutex mu;
  const MapKey key{ptr, inner, outer, pitch, (int)dtype, box_inner,
                   box_outer};
  uint64_t h = reinterpret_cast<uintptr_t>(ptr) >> 4;
  h = (h ^ (uint64_t)outer * 0x9E3779B97F4A7C15ull ^ (uint64_t)inner ^
       (uint64_t)box_outer << 32) * 0xC2B2AE3D27D4EB4Full;
  Slot& slot = slots[(h >> 32) % kSlots];
  {
    std::lock_guard<std::mutex> lock(mu);
    if (slot.used && slot.key == key) {
      *map = slot.map;
      return 0;
    }
  }
  const int rc = encode_map_2d(fn, map, dtype, ptr, inner, outer, pitch,
                               box_inner, box_outer);
  if (rc == 0) {
    std::lock_guard<std::mutex> lock(mu);
    slot.key = key;
    slot.map = *map;
    slot.used = true;
  }
  return rc;
}


// ---------------------------------------------------------------------
// weight-only mode: K split across the blocks of a cluster, int8 rows by
// cp.async, dequantised in registers, partials merged in split order
// through distributed shared memory
// ---------------------------------------------------------------------

namespace wonly {

constexpr int kBN = 64;             // weight rows (output columns) a block
constexpr int kKC = 64;             // K a chunk
constexpr int kThreads = 128;       // four warps
constexpr int kWBytes = kBN * kKC;  // a chunk of int8 weight rows (pitch 64)
constexpr int kCP = kBN + 4;        // f32 pitch of the epilogue's tile and
                                    // of the f32 route's dequantised chunk
constexpr int kMaxSplits = 8;       // a portable cluster
constexpr int kSmemLimit = 232448;

// x's pitch in shared memory: a chunk's row and 16 bytes, so that eight
// rows' 16-byte pieces at one k fall on distinct banks (f32: kCP floats)
template <typename T>
__host__ __device__ constexpr int x_pitch() {
  return kKC * (int)sizeof(T) + 16;
}

// bf16 at 128 rows of x multiplies by wgmma (mainloop_wgmma): x's rows
// are 128 bytes in the 128-byte swizzle that wgmma's descriptor reads, the
// weight's rows 80 bytes apart so that eight rows' 16-byte reads at one k
// fall on distinct banks; the tile starts on 1,024 bytes
template <typename T, int BM>
__host__ __device__ constexpr bool uses_wgmma() {
  return sizeof(T) == 2 && BM == 128;
}
template <typename T, int BM>
__host__ __device__ constexpr int w_pitch() {
  return uses_wgmma<T, BM>() ? 80 : kKC;
}
template <typename T, int BM>
__host__ __device__ constexpr int x_row() {
  return uses_wgmma<T, BM>() ? 128 : x_pitch<T>();
}

// chunks in the cp.async ring: 8 for blocks of at most 16 rows of x (a
// split's whole slab in flight at the classifier), else 4
__host__ __device__ constexpr int stages_of(int bm) { return bm <= 16 ? 8 : 4; }

// The dynamic shared memory of a block of `bm` rows of x (the Python plan
// computes the same): the ring of weight and x chunks and, for f32 at 32
// rows of x or more, the dequantised weight chunk (wgmma: 80-byte weight
// rows, 128-byte x rows and 1,024 bytes to align the tile).  The
// epilogue's f32 tile [bm][kCP] reuses the ring.
template <typename T>
__host__ __device__ constexpr int smem_bytes(int bm) {
  if (sizeof(T) == 2 && bm == 128)
    return 1024 + stages_of(bm) * (kBN * 80 + bm * 128);
  return stages_of(bm) * (kWBytes + bm * x_pitch<T>()) +
         (sizeof(T) == 4 && bm > 16 ? kBN * kCP * 4 : 0);
}

struct Params {
  const void* x;        // [M, K] f32 or bf16, row pitch ldx
  long long ldx;
  const int8_t* w;      // [N, K] int8, row pitch ldw
  long long ldw;
  const float* scale;   // [N] f32
  void* out;            // [M, N] contiguous, x's dtype
  int M, N, K;
  int tiles_n, splits, cps, chunks;
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

// every thread of every block of the cluster; orders shared-memory writes
// before the barrier with reads after it, cluster-wide
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of this block's shared `addr` in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// Byte i of `u` (a word of int8 codes xor 0x80808080) as an f32 code,
// exactly: the float with bits 0x4B0000uu is 2^23 + uu, uu = q + 128
__device__ __forceinline__ float code(uint32_t u, int i) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
         8388736.f;
}

// Start chunk c's loads into ring slot `slot`: the weight's 64 rows x 4
// pieces of 16 bytes (rows past N, and pieces at or past K, zero-filled:
// a piece that starts before K ends within the row's pitch, a multiple of
// 16 at least K) and x's bm rows x 64 values (rows past M and values past
// K zero-filled, so the weight's bytes there multiply zeros; for wgmma
// piece q of row r goes to place q ^ (r % 8) of the row)
template <typename T, int BM>
__device__ __forceinline__ void load_chunk(const Params& p, uint32_t base,
                                           int slot, int n0, int m0, int c,
                                           int tid) {
  constexpr int kE = 16 / (int)sizeof(T);   // values a piece
  constexpr int kPR = kKC / kE;             // pieces a row of x
  constexpr int S = stages_of(BM);
  constexpr int WS = kBN * w_pitch<T, BM>();
  const uint32_t sw = base + slot * WS;
  const uint32_t sx = base + S * WS + slot * BM * x_row<T, BM>();
  const int k0 = c * kKC;
  for (int e = tid; e < kBN * 4; e += kThreads) {
    const int r = e >> 2, q = e & 3;
    const int n = n0 + r, k = k0 + 16 * q;
    const bool ok = n < p.N && k < p.K;
    cp_async16(sw + r * w_pitch<T, BM>() + 16 * q,
               p.w + (ok ? (long long)n * p.ldw + k : 0), ok ? 16 : 0);
  }
  const T* const x = static_cast<const T*>(p.x);
  for (int e = tid; e < BM * kPR; e += kThreads) {
    const int r = e / kPR, q = e % kPR;
    const int m = m0 + r, k = k0 + q * kE;
    const int valid = m < p.M ? max(0, min(p.K - k, kE)) : 0;
    cp_async16(sx + r * x_row<T, BM>() +
                   16 * (uses_wgmma<T, BM>() ? q ^ (r & 7) : q),
               x + (valid ? (long long)m * p.ldx + k : 0),
               valid * (int)sizeof(T));
  }
}

// The ring: before chunk i is used, every thread waits for its own copies
// of it (and, for wgmma, makes them visible to the async proxy that reads
// the operands) and the block meets (so all copies have landed and the
// slot that the next load refills was read by everyone); then chunk i + S
// - 1 is started.  One commit group an iteration, empty or not.
template <typename T, int BM>
__device__ __forceinline__ void ring_step(const Params& p, uint32_t base,
                                          int n0, int m0, int c0, int nc,
                                          int i) {
  constexpr int S = stages_of(BM);
  cp_async_wait<S - 2>();
  if constexpr (uses_wgmma<T, BM>())
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (i + S - 1 < nc)
    load_chunk<T, BM>(p, base, (i + S - 1) % S, n0, m0, c0 + i + S - 1,
                      threadIdx.x);
  cp_async_commit();
}

// bf16: each warp multiplies 16 weight rows by the block's bm rows of x
// with mma.sync m16n8k16 (weight as A, x as B: out^T = W x^T).  Both
// operands come from registers, so K may be permuted as long as A and B
// agree: the thread of quad index t loads the 16 consecutive bytes
// 16t..16t+15 of a row's 64-byte chunk, and in k16 step j its fragment
// slots (columns 2t, 2t+1, 2t+8, 2t+9) take bytes 4j..4j+3 of them; its
// B fragment takes x at the same 16t + 4j + 0..3.  Sums run in f32 as the
// reference's.
template <int BM>
__device__ __forceinline__ void mainloop_bf16(const Params& p,
                                              unsigned char* smem, int n0,
                                              int m0, int c0, int nc,
                                              float (&acc)[BM / 8][4]) {
  constexpr int S = stages_of(BM);
  constexpr int XP = x_pitch<__nv_bfloat16>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = 16 * warp + g;   // local weight rows ra and ra + 8
  const uint32_t base = sm90::smem_u32(smem);
  // the reference's weight: bf16(bf16(q) * bf16(scale)); f32(q) * bf16
  // scale is exact in f32, so one rounding to bf16 gives it
  float s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + ra + 8 * h;
    s[h] = n < p.N ? __bfloat162float(__float2bfloat16_rn(__ldg(p.scale + n)))
                   : 0.f;
  }
  for (int i = 0; i < nc; ++i) {
    ring_step<__nv_bfloat16, BM>(p, base, n0, m0, c0, nc, i);
    const int slot = i % S;
    const unsigned char* const ws = smem + slot * kWBytes;
    uint32_t a[4][4];   // [k16 step][fragment register]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          ws + (ra + 8 * h) * kKC + 16 * t);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t u = words[j] ^ 0x80808080u;
        a[j][h] = sm90::pack_bf16x2(code(u, 0) * s[h], code(u, 1) * s[h]);
        a[j][2 + h] = sm90::pack_bf16x2(code(u, 2) * s[h],
                                        code(u, 3) * s[h]);
      }
    }
    // x row 8b + g, values 16t + 8h .. 16t + 8h + 7: one 16-byte read
    // feeds steps 2h and 2h + 1, and the products of one half-chunk run
    // over every accumulator before the next half's
    const unsigned char* const xs =
        smem + S * kWBytes + slot * BM * XP + g * XP + 32 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < BM / 8; ++b) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            xs + 8 * b * XP + 16 * h);
        const uint32_t b0[2] = {v.x, v.y}, b1[2] = {v.z, v.w};
        mma_bf16(acc[b], a[2 * h], b0);
        mma_bf16(acc[b], a[2 * h + 1], b1);
      }
  }
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (each warp
// holds the m16n8k16 A fragment of its 16 rows), B K-major in shared
// memory
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// bf16 at 128 rows of x: the warpgroup multiplies the 64 weight rows by
// the 128 rows of x with wgmma m64n128k16 (out^T = W x^T), the
// dequantised weight as A from registers and x as a K-major B in shared
// memory.  B fixes K's order, so A's is the standard one: in k16 step j
// each thread reads the step's 16 weight bytes and keeps bytes 2t, 2t+1,
// 2t+8, 2t+9.  The accumulators are laid out as mainloop_bf16's acc[b]
// (d[4b..4b+3]).  1.11x faster than mma.sync at this height on an H100
// (PERF.md section 6).
__device__ __forceinline__ void mainloop_wgmma(const Params& p,
                                               unsigned char* smem, int n0,
                                               int m0, int c0, int nc,
                                               float (&acc)[64]) {
  constexpr int BM = 128;
  constexpr int S = stages_of(BM);
  constexpr int WP = w_pitch<__nv_bfloat16, BM>(), WS = kBN * WP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = 16 * warp + g;   // local weight rows ra and ra + 8
  const uint32_t base = sm90::smem_u32(smem);
  // bytes 2t, 2t+1 of the step's words 0-1 and 2t+8, 2t+9 of words 2-3
  const uint32_t pick = (t & 1) ? 0x7632u : 0x5410u;
  float s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + ra + 8 * h;
    s[h] = n < p.N ? __bfloat162float(__float2bfloat16_rn(__ldg(p.scale + n)))
                   : 0.f;
  }
  for (int i = 0; i < nc; ++i) {
    ring_step<__nv_bfloat16, BM>(p, base, n0, m0, c0, nc, i);
    const int slot = i % S;
    const unsigned char* const ws = smem + slot * WS;
    uint32_t a[4][4];   // [k16 step][fragment register]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            ws + (ra + 8 * h) * WP + 16 * j);
        const uint32_t lo = (t >> 1) ? v.y : v.x;
        const uint32_t hi = (t >> 1) ? v.w : v.z;
        const uint32_t u = __byte_perm(lo, hi, pick) ^ 0x80808080u;
        a[j][h] = sm90::pack_bf16x2(code(u, 0) * s[h], code(u, 1) * s[h]);
        a[j][2 + h] = sm90::pack_bf16x2(code(u, 2) * s[h],
                                        code(u, 3) * s[h]);
      }
    const uint32_t sx = base + S * WS + slot * BM * 128;
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs_kmajor(acc, a[j], sm90::sw128_desc(sx + 32 * j, 0, 1024));
    sm90::wgmma_commit();
    // the next ring step refills a slot this chunk's products may read
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  }
}

// f32 at up to 16 rows of x: as bf16, each quad of threads reads two
// weight rows' 64-byte chunk 16 bytes a thread and dequantises it in
// registers (f32(q) * scale, the reference's f32 product); each thread
// sums its 16 values of k a chunk against every row of x with FMA, and
// the quad adds its four sums once, at the end (no tensor cores: they
// have no f32 product)
template <int BM>
__device__ __forceinline__ void mainloop_f32q(const Params& p,
                                              unsigned char* smem, int n0,
                                              int m0, int c0, int nc,
                                              float (&acc)[2][BM]) {
  constexpr int S = stages_of(BM);
  constexpr int MB = 4;                 // rows of x a step
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = 16 * warp + g;   // local weight rows ra and ra + 8
  const uint32_t base = sm90::smem_u32(smem);
  float s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + ra + 8 * h;
    s[h] = n < p.N ? __ldg(p.scale + n) : 0.f;
  }
  for (int i = 0; i < nc; ++i) {
    ring_step<float, BM>(p, base, n0, m0, c0, nc, i);
    const int slot = i % S;
    float wv[2][16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          smem + slot * kWBytes + (ra + 8 * h) * kKC + 16 * t);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t u = words[j] ^ 0x80808080u;
#pragma unroll
        for (int c = 0; c < 4; ++c) wv[h][4 * j + c] = code(u, c) * s[h];
      }
    }
    const float* const xs = reinterpret_cast<const float*>(
        smem + S * kWBytes + slot * BM * x_pitch<float>()) + 16 * t;
#pragma unroll
    for (int m0s = 0; m0s < BM; m0s += MB) {
      float xv[MB][16];
#pragma unroll
      for (int mm = 0; mm < MB; ++mm)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<float4*>(&xv[mm][4 * c]) =
              *reinterpret_cast<const float4*>(xs + (m0s + mm) * kCP +
                                               4 * c);
      // k in order for each sum; consecutive FMAs on distinct sums
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int mm = 0; mm < MB; ++mm)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            acc[h][m0s + mm] = fmaf(wv[h][c], xv[mm][c], acc[h][m0s + mm]);
    }
  }
}

// f32 at 32 and 64 rows of x: the chunk's weight is dequantised once
// into shared memory (f32(q) * scale, the reference's f32 product), then
// each thread sums a tile of RN weight rows x RM rows of x with FMA, k in
// order
template <int BM>
struct FmaTile {
  static constexpr int TM = BM < 16 ? BM : 16;   // threads along x's rows
  static constexpr int TN = kThreads / TM;       // threads along weight rows
  static constexpr int RN = kBN / TN;
  static constexpr int RM = BM / TM;
};

template <int BM>
__device__ __forceinline__ void mainloop_f32(
    const Params& p, unsigned char* smem, int n0, int m0, int c0, int nc,
    float (&acc)[FmaTile<BM>::RN][FmaTile<BM>::RM]) {
  using F = FmaTile<BM>;
  constexpr int S = stages_of(BM);
  const int tid = threadIdx.x;
  const int tm = tid % F::TM, tn = tid / F::TM;
  const uint32_t base = sm90::smem_u32(smem);
  float* const wf = reinterpret_cast<float*>(
      smem + S * (kWBytes + BM * x_pitch<float>()));
  // the dequant pass: word tid + 128u of a chunk is row tid / 16 + 8u
  float s[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int n = n0 + (tid >> 4) + 8 * u;
    s[u] = n < p.N ? __ldg(p.scale + n) : 0.f;
  }
  for (int i = 0; i < nc; ++i) {
    ring_step<float, BM>(p, base, n0, m0, c0, nc, i);
    const int slot = i % S;
    const unsigned char* const ws = smem + slot * kWBytes;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = tid + kThreads * u, r = idx >> 4, q = idx & 15;
      const uint32_t v =
          *reinterpret_cast<const uint32_t*>(ws + r * kKC + 4 * q) ^
          0x80808080u;
      *reinterpret_cast<float4*>(wf + r * kCP + 4 * q) =
          make_float4(code(v, 0) * s[u], code(v, 1) * s[u],
                      code(v, 2) * s[u], code(v, 3) * s[u]);
    }
    __syncthreads();
    const float* const xs = reinterpret_cast<const float*>(
        smem + S * kWBytes + slot * BM * x_pitch<float>());
#pragma unroll 2
    for (int q = 0; q < kKC / 4; ++q) {
      float4 wv[F::RN], xv[F::RM];
#pragma unroll
      for (int a = 0; a < F::RN; ++a)
        wv[a] = *reinterpret_cast<const float4*>(
            wf + (tn + F::TN * a) * kCP + 4 * q);
#pragma unroll
      for (int b = 0; b < F::RM; ++b)
        xv[b] = *reinterpret_cast<const float4*>(
            xs + (tm + F::TM * b) * kCP + 4 * q);
      // k in order for each sum; consecutive FMAs on distinct sums
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int a = 0; a < F::RN; ++a)
#pragma unroll
          for (int b = 0; b < F::RM; ++b)
            acc[a][b] = fmaf(reinterpret_cast<const float*>(&wv[a])[kk],
                             reinterpret_cast<const float*>(&xv[b])[kk],
                             acc[a][b]);
    }
  }
}

__device__ __forceinline__ void store_out(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// Block b: split b % splits (its rank in a cluster of `splits` blocks),
// which sums chunks [split * cps, split * cps + cps) of K, of tile b /
// splits: weight rows 64 * (tile % tiles_n), rows of x BM * (tile /
// tiles_n).  Each block leaves its f32 partial tile in its shared memory;
// after the cluster meets, block r adds every r-th group of four values
// across the cluster's partials in split order and writes them (bitwise
// the same on a rerun), and the cluster meets again before any block
// leaves.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
int8_wonly(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // wgmma's swizzled x tiles start on 1,024 bytes (smem_bytes counts the
  // slack)
  unsigned char* const smem_w =
      uses_wgmma<T, BM>()
          ? smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u)
          : smem_raw;
  const int tid = threadIdx.x;
  const int split = blockIdx.x % p.splits, tile = blockIdx.x / p.splits;
  const int n0 = (tile % p.tiles_n) * kBN, m0 = (tile / p.tiles_n) * BM;
  const int c0 = split * p.cps;
  const int nc = min(p.cps, p.chunks - c0);
  const uint32_t base = sm90::smem_u32(smem_w);

  for (int s = 0; s < stages_of(BM) - 1; ++s) {
    if (s < nc) load_chunk<T, BM>(p, base, s, n0, m0, c0 + s, tid);
    cp_async_commit();
  }
  float* const C = reinterpret_cast<float*>(smem_w);   // [BM][kCP]
  if constexpr (sizeof(T) == 2) {
    float acc[BM / 8][4] = {};
    if constexpr (uses_wgmma<T, BM>())
      mainloop_wgmma(p, smem_w, n0, m0, c0, nc,
                     *reinterpret_cast<float(*)[64]>(&acc[0][0]));
    else
      mainloop_bf16<BM>(p, smem_w, n0, m0, c0, nc, acc);
    cp_async_wait<0>();
    __syncthreads();
    // accumulator b: rows ra (c0, c1) and ra + 8 (c2, c3), x rows 8b + 2t
    // and 8b + 2t + 1
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int ra = 16 * (tid >> 5) + g;
#pragma unroll
    for (int b = 0; b < BM / 8; ++b) {
      const int m = 8 * b + 2 * t;
      C[m * kCP + ra] = acc[b][0];
      C[(m + 1) * kCP + ra] = acc[b][1];
      C[m * kCP + ra + 8] = acc[b][2];
      C[(m + 1) * kCP + ra + 8] = acc[b][3];
    }
  } else if constexpr (BM <= 16) {
    float acc[2][BM] = {};
    mainloop_f32q<BM>(p, smem_w, n0, m0, c0, nc, acc);
    cp_async_wait<0>();
    __syncthreads();
    // the quad's four sums of each (row, x row), (t0 + t1) + (t2 + t3) in
    // every lane; lane t writes the x rows m with m % 4 == t
    const int lane = tid & 31, t = lane & 3;
    const int ra = 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        float v = acc[h][m];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((m & 3) == t) C[m * kCP + ra + 8 * h] = v;
      }
  } else {
    using F = FmaTile<BM>;
    float acc[F::RN][F::RM] = {};
    mainloop_f32<BM>(p, smem_w, n0, m0, c0, nc, acc);
    cp_async_wait<0>();
    __syncthreads();
    const int tm = tid % F::TM, tn = tid / F::TM;
#pragma unroll
    for (int a = 0; a < F::RN; ++a)
#pragma unroll
      for (int b = 0; b < F::RM; ++b)
        C[(tm + F::TM * b) * kCP + tn + F::TN * a] = acc[a][b];
  }
  if (p.splits > 1)
    cluster_sync();
  else
    __syncthreads();

  const int mv = min(BM, p.M - m0);   // rows of x that exist
  T* const out = static_cast<T*>(p.out);
  // each block's partial in the cluster's shared-memory window (its own
  // at its own address: with one split there is no cluster)
  uint32_t src[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    src[s] = s == split ? base : s < p.splits ? map_rank(base, s) : 0u;
  for (int gi = split * kThreads + tid; gi < mv * (kBN / 4);
       gi += p.splits * kThreads) {
    const int m = gi / (kBN / 4), q = gi % (kBN / 4);
    const uint32_t off = (m * kCP + 4 * q) * 4;
    float4 v[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      if (s < p.splits) v[s] = ld_cluster(src[s] + off);
    float4 r = v[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s)
      if (s < p.splits) {
        r.x += v[s].x;
        r.y += v[s].y;
        r.z += v[s].z;
        r.w += v[s].w;
      }
    const float rv[4] = {r.x, r.y, r.z, r.w};
    T* const o = out + (long long)(m0 + m) * p.N + n0 + 4 * q;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n0 + 4 * q + c < p.N) store_out(o + c, rv[c]);
  }
  // no block's partial may go before every block has read it
  if (p.splits > 1) cluster_sync();
}

// The kernel's shared-memory limit is raised once a device (as the
// dynamic mode's launch_dyn does); several splits launch as clusters of
// `splits` blocks
template <typename T, int BM>
cudaError_t launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(int8_wonly<T, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, int8_wonly<T, BM>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bm(int bm, const Params& p, int grid, int smem,
                      cudaStream_t stream) {
  switch (bm) {
    case 8: return launch<T, 8>(p, grid, smem, stream);
    case 16: return launch<T, 16>(p, grid, smem, stream);
    case 32: return launch<T, 32>(p, grid, smem, stream);
    case 64: return launch<T, 64>(p, grid, smem, stream);
  }
  // 128 rows of x: bf16 only (the plan gives f32 at most 64)
  if constexpr (sizeof(T) == 2)
    return launch<T, 128>(p, grid, smem, stream);
  else
    return cudaErrorInvalidValue;
}

}  // namespace wonly

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  static char buf[160];
  if (err == kErrPlan)
    return "the launch plan is not one this library can run";
  if (err == kErrNoEncode)
    return "cuTensorMapEncodeTiled not found through the CUDA runtime";
  if (err >= kErrEncode) {
    const int which = (err - kErrEncode) % 16;
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed for %s "
             "(CUresult %d)", which == 0 ? "x" : which == 1 ? "w" : "out",
             (err - kErrEncode) / 16);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic mode.  x: [M, K] int8 with row pitch lda; w: [N, K] int8 with
// row pitch ldb (both pointers and pitches multiples of 16 bytes), and
// zero in its bytes from K to the next multiple of 16 (x's may hold
// anything there); scale: [N] f32; out: [M, N] contiguous, f32 or bf16
// (out_bf16).  `plan`: block_m, block_n, ring stages, threads,
// shared-memory bytes, grid and TMA store (0 or 1), as `int8_mm_plan`
// computed them; the entry refuses a plan it cannot run.  Returns the
// CUDA error of the launch (0 on success) or one of this library's codes.
int int8_matmul_dynamic(const void* x, long long lda, const void* w,
                        long long ldb, const void* scale, void* out, int M,
                        int N, int K, int out_bf16, const int* plan,
                        void* stream) {
  using namespace sm90;
  if (M <= 0 || N <= 0 || K <= 0 || lda < K || ldb < K || lda % 16 != 0 ||
      ldb % 16 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int bm = plan[0], bn = plan[1], stages = plan[2];
  const int elt = out_bf16 ? 2 : 4;
  const int k_tiles = (K + kBK - 1) / kBK;
  const long long tiles_m = (M + bm - 1) / bm, tiles_n = (N + bn - 1) / bn;
  const long long items = tiles_m * tiles_n;
  if ((bm != 64 && bm != 128) || (bn != 64 && bn != 128) || stages < 2 ||
      stages > kMaxStages || plan[3] != 2 * bm + 32 ||
      plan[4] != smem_bytes(bm, bn, stages, elt) || plan[4] > kSmemLimit ||
      plan[5] < 1 || plan[5] > items || items > INT_MAX ||
      (plan[6] != 0 && plan[6] != 1) ||
      (plan[6] && (((long long)N * elt) % 16 != 0 ||
                   (reinterpret_cast<uintptr_t>(out) & 15) != 0)))
    return kErrPlan;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  // both maps end K at a multiple of 16 (within the pitches): a box that
  // crosses the end of a row off a 16-byte boundary loads several times
  // slower.  w's bytes past K are zero, so x's there add nothing
  const long long kext = (K + 15) / 16 * 16;
  CUtensorMap maps[3] = {};
  int rc = cached_map_2d(fn, &maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, x,
                         kext, M, lda, kBK, bm);
  if (rc != 0) return kErrEncode + rc * 16;
  rc = cached_map_2d(fn, &maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, w, kext,
                     N, ldb, kBK, bn);
  if (rc != 0) return kErrEncode + rc * 16 + 1;
  if (plan[6]) {
    // 128-byte boxes of a warpgroup's 64 rows
    rc = cached_map_2d(fn, &maps[2],
                       out_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       out, N, M, (long long)N * elt, 128 / elt, 64);
    if (rc != 0) return kErrEncode + rc * 16 + 2;
  }
  const Params p{static_cast<const float*>(scale), out, M, N, (int)tiles_n,
                 k_tiles, (int)items, bm / 64, stages, plan[6]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bn == 64)
    err = out_bf16 ? launch_dyn<64, __nv_bfloat16>(maps, p, plan, s)
                   : launch_dyn<64, float>(maps, p, plan, s);
  else
    err = out_bf16 ? launch_dyn<128, __nv_bfloat16>(maps, p, plan, s)
                   : launch_dyn<128, float>(maps, p, plan, s);
  return (int)err;
}

// Weight-only mode.  x: [M, K] f32 or bf16 (is_bf16) with row pitch ldx
// (any for M = 1), 16-byte aligned, rows a multiple of 16 bytes apart; w:
// [N, K] int8 with row pitch ldw (a multiple of 16, 16-byte aligned);
// scale: [N] f32 (w_scale); out: [M, N] contiguous in x's dtype.  `plan`:
// block_m, splits, chunks a split, stages, threads, shared-memory bytes
// and grid, as `int8_wonly_plan` computed them; the entry refuses a plan
// it cannot run.  Returns the CUDA error of the launch (0 on success) or
// one of this library's codes.
int int8_matmul_weight_only(const void* x, long long ldx, const void* w,
                            long long ldw, const void* scale, void* out,
                            int M, int N, int K, int is_bf16,
                            const int* plan, void* stream) {
  using namespace wonly;
  const int elt = is_bf16 ? 2 : 4;
  if (M <= 0 || N <= 0 || K <= 0 || ldw < K || ldw % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (M > 1 && (ldx < K || (ldx * elt) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const int bm = plan[0], splits = plan[1], cps = plan[2];
  if ((bm != 8 && bm != 16 && bm != 32 && bm != 64 && bm != 128) ||
      (bm == 128 && !is_bf16))
    return kErrPlan;
  const int chunks = (K + kKC - 1) / kKC;
  const long long tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + bm - 1) / bm;
  const int smem = is_bf16 ? smem_bytes<__nv_bfloat16>(bm)
                           : smem_bytes<float>(bm);
  if (cps < 1 || splits < 1 || splits > kMaxSplits ||
      splits != (chunks + cps - 1) / cps || plan[3] != stages_of(bm) ||
      plan[4] != kThreads || plan[5] != smem ||
      tiles_n * tiles_m * splits > INT_MAX ||
      plan[6] != tiles_n * tiles_m * splits)
    return kErrPlan;
  const Params p{x, M > 1 ? ldx : K, static_cast<const int8_t*>(w), ldw,
                 static_cast<const float*>(scale), out, M, N, K,
                 (int)tiles_n, splits, cps, chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_bm<__nv_bfloat16>(bm, p, plan[6], smem, s)
                       : launch_bm<float>(bm, p, plan[6], smem, s));
}

}  // extern "C"

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
// Weight-only mode dequantises the int8 weight tile into shared memory as
// the reference's compute dtype holds it and never writes it to device
// memory: for bf16, bf16(q) * bf16(scale) (one rounding, as XLA gives)
// feeding mma.sync m16n8k16 bf16 -> f32 on a 64 x 64 tile per block; for
// f32, f32(q) * scale feeding a tiled FMA kernel (4 x 4 outputs a
// thread; the tensor cores have no exact f32 product).  Both sum in f32
// and round the output to the compute dtype.  Plain element loads, no
// pipelining: this mode is not on the int8 ResNet path; it serves
// Int8InferenceLinear(act_quant=None).

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

// Ordered segment sums of embedding-gradient rows for Hopper (sm_90a), with
// a plain C interface: kernels 7 and 8 of the port, one device routine.
//
// Replaces: paddle_tpu/ops/pallas/segment_sum.py:58
// `_segment_sum_kernel` (launched by `segment_sum_pallas`): out[inv[i]] +=
// g[i] for i = 0..n-1 in row order, out [nseg, dim] f32 starting at zero.
// The device cache's push merges the gradients of a batch's duplicate ids
// with it before the optimizer apply (paddle_tpu/distributed/fleet/
// heter.py:551).  Here: `segment_sum_f32`, kernel `segment_sum_kernel`.
//
// Replaces: paddle_tpu/ops/pallas/segment_sum.py:126
// `_segment_sum_sorted_kernel` (launched by `segment_sum_sorted_pallas`):
// the same sum for rows that arrive sorted by segment id, rows of no
// gradient 0.  The streaming trainer's pre-merge takes it through
// `merge_segments` once a batch has 4,096 unique ids or more
// (paddle_tpu/online/streaming.py:225-241).  Here: `segment_sum_sorted_f32`,
// kernel `segment_sum_sorted_kernel`.
//
// What bounds it on this card: bytes.  Each gradient row is read once, each
// index once and each output row written once, one add per gradient
// element.  At the wide&deep push (26,624 rows of dim 16 into 8,192
// segments) that is 1.70 MB of rows, 0.14 MB of row order and offsets and
// 0.52 MB of output, 0.7 us at 3.35 TB/s; at vocab scale (256 rows into
// 200,000 segments) the 12.8 MB of output alone is 3.8 us.  In practice
// the launch and the latency of dependent loads set the time.
//
// What the design does about it: the TPU kernels walk the rows in order
// into a VMEM-resident output; blocks here run in parallel and in no
// order, and an f32 sum in row order cannot be split without changing its
// rounding.  So the loads are made parallel, each (segment, column)'s adds
// stay serial, and every chain of dependent loads is cut to a few rounds:
// - a block of 256 threads owns tiles of 256 / width consecutive segments
//   (16 at dim 16: the 6,242- and 8,192-segment merges give 391 and 512
//   blocks for 132 SMs), several of them in turn where the tiles
//   outnumber the blocks the card holds at once (4 an SM; at most 16
//   tiles, which bounds the ranges a block keeps in shared memory), and
//   a slice of at most 128 columns.  It first stores zeros over all its
//   output, so a segment with no row needs nothing more;
// - the block's row ranges are found once, into shared memory: kernel 7
//   reads its offsets; kernel 8 finds its row range [lo, hi) by two
//   warp-wide searches (128 probes a round: 3 rounds of loads over 26,624
//   ids), then a thread per row in [lo, hi), 1,024 rows a round,
//   marks where its segment starts, empty segments getting empty ranges.
//   No thread searches for its own (segment, column);
// - all threads stream the block's rows through a 4-stage ring of
//   cp.async copies in shared memory (16 bytes where dim % 4 == 0 and the
//   rows are 16-byte aligned, 4 bytes otherwise; up to 192 rows a stage
//   at dim 16), the first three stages issued at once, kernel 7 loading a
//   stage's `order` entries together before its copies and a later
//   stage's under the fold: a ~550-row hot tile is one round of loads,
//   not 300 trips to memory;
// - each thread owns one column of one segment of the current tile and
//   adds that segment's rows from shared memory in ascending row order,
//   from 0.0, with __fadd_rn (16 rows' loads, then their adds), carrying
//   the sum across stages, so a segment of any length folds in row order:
//   the same additions in the same order as the reference and the plain
//   versions, and kernel 8 after merge_segments' stable sort adds as
//   kernel 7 does.  No atomics, so a rerun is bitwise equal.  Once a
//   stage passes the segment's end the thread stores the sum and moves on
//   to its segment of the next tile.
// The launch plan (tile, tiles a block, slice width, stage rows, copy
// width) is chosen in Python (`segment_tile_plan`, segment_sum.py) and
// checked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // a block: eight warps
constexpr int kMaxWidth = 128;      // columns of a block's slice
constexpr int kMaxReps = 16;        // tiles a block takes in turn
// a ring of 4 stages, 3 in flight while one is folded; a stage holds 768
// column groups of V floats (12 KB, 192 rows at dim 16 and V = 4), so a
// thread's share of a stage's copies is 3, and 4 blocks fit an SM
constexpr int kStages = 4;
constexpr int kStageGroups = 768;
constexpr int kPer = kStageGroups / kThreads;
constexpr int kMarkRows = 4;        // rows a thread marks per round

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int V>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The first index in seg[0, n) whose id is >= key (seg ascending), found
// by a whole warp: each round the lanes probe 128 points spread over
// [lo, hi) (4 each, all loads in flight together) and keep the gap around
// the answer, so a round divides the range by 129 where a binary search
// halves it: 3 rounds of loads over 26,624 ids.  Probe i sits at
// lo + (i + 1) * span / 129, so every lane computes the two it keeps.
__device__ int warp_lower_bound(const int* __restrict__ seg, int n,
                                int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;   // seg[< lo] < key <= seg[>= hi]
  while (hi - lo > 128) {
    const long long span = hi - lo;
    bool less[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      less[t] = seg[lo + (int)((4 * lane + t + 1) * span / 129)] < key;
    int below = 0;   // probes below the key: probes 0 .. below - 1
#pragma unroll
    for (int t = 0; t < 4; ++t)
      below += __popc(__ballot_sync(0xffffffffu, less[t]));
    const int nlo = below > 0 ? lo + (int)(below * span / 129) + 1 : lo;
    if (below < 128) hi = lo + (int)((below + 1) * span / 129);
    lo = nlo;
  }
  int below = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int p = lo + 4 * lane + t;
    below += __popc(__ballot_sync(0xffffffffu, p < hi && seg[p] < key));
  }
  return lo + below;
}

// the next U rows of one column of a stage: all U loads first, then their
// adds in row order
template <int U>
__device__ __forceinline__ float fold_rows(float acc, const float* p,
                                          int stride) {
  float x[U];
#pragma unroll
  for (int u = 0; u < U; ++u) x[u] = p[u * stride];
#pragma unroll
  for (int u = 0; u < U; ++u) acc = __fadd_rn(acc, x[u]);
  return acc;
}

// the last cnt < 2U rows: U at once if they are there, then U / 2, ...
template <int U>
__device__ __forceinline__ float fold_tail(float acc, const float* p,
                                           int stride, int cnt) {
  if (cnt >= U) {
    acc = fold_rows<U>(acc, p, stride);
    p += U * stride;
    cnt -= U;
  }
  if constexpr (U > 1) return fold_tail<U / 2>(acc, p, stride, cnt);
  return acc;
}

template <int V>
__device__ __forceinline__ void store_zeros(float* dst) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  else
    *dst = 0.0f;
}

// The rows of one block and where they are staged.  kSorted: `idx` holds
// the ascending segment ids and position p is gradient row p; else `idx`
// is the row order and position p is gradient row idx[p].  A chunk's
// copies are V floats each (16 bytes at V = 4); this thread's copies i
// are row cr[i], column group cv[i] of every chunk.
template <bool kSorted, int V>
struct Rows {
  const float* g;       // column col0 of row 0
  const int* idx;
  float* ring;          // kStages x chunk x width
  int dim, width, chunk;
  int cr[kPer], cv[kPer];

  // kernel 7: the gradient row of each of this thread's copies of the
  // chunk at position c0 (`rows` rows), the `order` loads all in flight
  // together; kernel 8 needs none
  __device__ __forceinline__ void rows_of(int c0, int rows,
                                          int (&src)[kPer]) const {
    if constexpr (!kSorted) {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        src[i] = cr[i] < rows ? idx[c0 + cr[i]] : 0;
    }
  }

  // copy the chunk at position c0 into ring stage k % kStages and close
  // the copy group
  __device__ __forceinline__ void copy(int k, int c0, int rows,
                                       const int (&src)[kPer]) const {
    float* buf = ring + (k % kStages) * (chunk * width);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (cr[i] < rows) {
        const int row = kSorted ? c0 + cr[i] : src[i];
        cp_async<V>(buf + cr[i] * width + cv[i] * V,
                    g + (long long)row * dim + cv[i] * V);
      }
    }
    cp_async_commit();
  }
};

// One block: `reps` tiles of `tile` consecutive segments from
// s0 = blockIdx.x * tile * reps (ns segments in all), columns
// [col0, col0 + w).  Segment s0 + i owns positions [starts[i],
// starts[i + 1]); the block's rows are positions [P0, P1), streamed
// through the ring in chunks.  Thread (j, c) folds column c of segment j
// of one tile after another: one add chain a thread, so the shared-memory
// loads of the next rows run ahead of the adds.
template <bool kSorted, int V>
__device__ __forceinline__ void segment_block(
    const float* __restrict__ g, const int* __restrict__ idx,
    const int* __restrict__ offsets, float* __restrict__ out, int n,
    int nseg, int dim, int tile, int reps, int width, int chunk) {
  extern __shared__ __align__(16) float ring[];   // then `starts`
  int* starts = reinterpret_cast<int*>(ring + kStages * chunk * width);
  __shared__ int bounds[2];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * (tile * reps);
  const int ns = min(tile * reps, nseg - s0);
  const int col0 = blockIdx.y * width;
  const int w = min(width, dim - col0);
  const int vpr = w / V;

  // 0. zeros over the block's output, stored at once: a segment with no
  // row keeps them (at vocab scale that is almost all of the kernel)
  if (w == dim) {                      // one slice: a contiguous range
    float* o = out + (long long)s0 * dim;
    for (int e = tid; e < ns * vpr; e += kThreads) store_zeros<V>(o + e * V);
  } else {
    for (int e = tid; e < ns * vpr; e += kThreads) {
      const int r = e / vpr, v = e - r * vpr;
      store_zeros<V>(out + (long long)(s0 + r) * dim + col0 + v * V);
    }
  }

  // 1. the block's rows [P0, P1): kernel 7 reads its offsets (all of them,
  // into `starts`), kernel 8 searches the ids
  if constexpr (kSorted) {
    const int warp = tid >> 5;
    if (warp < 2) {
      const int key = s0 + warp * ns;
      const int b = key >= nseg ? n : warp_lower_bound(idx, n, key);
      if ((tid & 31) == 0) bounds[warp] = b;
    }
  } else {
    for (int j = tid; j <= ns; j += kThreads) starts[j] = offsets[s0 + j];
  }
  __syncthreads();
  const int P0 = kSorted ? bounds[0] : starts[0];
  const int P1 = kSorted ? bounds[1] : starts[ns];
  Rows<kSorted, V> rows{g + col0, idx, ring, dim, width, chunk};
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    rows.cr[i] = e / vpr;
    rows.cv[i] = e - rows.cr[i] * vpr;
  }
  const int nch = (P1 - P0 + chunk - 1) / chunk;
  auto count = [&](int k) {             // rows of chunk k
    return k < nch ? min(chunk, P1 - P0 - k * chunk) : 0;
  };

  // 2. the first chunks' copies go out now, under kernel 8's marks
  if (nch > 0) {
    int src[kStages - 1][kPer];
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k)
      rows.rows_of(P0 + k * chunk, count(k), src[k]);
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k)
      rows.copy(k, P0 + k * chunk, count(k), src[k]);
  }

  // 3. kernel 8: the first row of a segment marks its start and those of
  // the empty segments just before it; a round's id loads are all in
  // flight together
  if constexpr (kSorted) {
    for (int j = tid; j <= ns; j += kThreads) starts[j] = P1;
    if (P0 < P1) {
      __syncthreads();
      for (int base = P0; base < P1; base += kThreads * kMarkRows) {
        int cur[kMarkRows], prev[kMarkRows];
#pragma unroll
        for (int i = 0; i < kMarkRows; ++i) {
          const int p = base + tid + i * kThreads;
          cur[i] = p < P1 ? idx[p] : 0;
          prev[i] = p < P1 && p > P0 ? idx[p - 1] : s0 - 1;
        }
#pragma unroll
        for (int i = 0; i < kMarkRows; ++i) {
          const int p = base + tid + i * kThreads;
          if (p < P1)
            for (int k = prev[i] + 1; k <= cur[i]; ++k) starts[k - s0] = p;
        }
      }
    }
    __syncthreads();
  }

  // 4. fold chunk by chunk.  A thread's segment of tile t is done once a
  // chunk passes its end: it stores the sum (over the zeros, ordered
  // after them by the barriers) and moves on to tile t + 1.
  const int j = tid / width, c = tid - j * width;
  const bool mine = j < tile && c < w;
  float acc = 0.0f;
  for (int k = 0, t = 0; k < nch; ++k) {
    cp_async_wait<kStages - 2>();      // chunk k has landed ...
    __syncthreads();                   // ... for every thread, and chunk
    const int kn = k + kStages - 1;    // k - 1's stage is free again
    int src[kPer];
    rows.rows_of(P0 + kn * chunk, count(kn), src);
    const int c0 = P0 + k * chunk, c1 = min(c0 + chunk, P1);
    const float* buf = ring + (k % kStages) * (chunk * width) + c;
    for (; mine && t * tile + j < ns; ++t) {
      const int a = starts[t * tile + j], b = starts[t * tile + j + 1];
      if (a >= c1) break;              // its rows start in a later chunk
      // 16 rows' loads at a time, then a tail of 8, 4, 2 and 1
      int r = max(a, c0) - c0;
      const int r1 = min(b, c1) - c0;
      for (; r + 16 <= r1; r += 16)
        acc = fold_rows<16>(acc, buf + r * width, width);
      acc = fold_tail<8>(acc, buf + r * width, width, r1 - r);
      if (b > c1) break;               // and go on into the next one
      if (b > a) out[(long long)(s0 + t * tile + j) * dim + col0 + c] = acc;
      acc = 0.0f;
    }
    // (kernel 7's `order` loads for this copy ran under the fold)
    rows.copy(kn, P0 + kn * chunk, count(kn), src);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, 4)
    segment_sum_kernel(const float* __restrict__ g,
                       const int* __restrict__ order,
                       const int* __restrict__ offsets,
                       float* __restrict__ out, int n, int nseg, int dim,
                       int tile, int reps, int width, int chunk) {
  segment_block<false, V>(g, order, offsets, out, n, nseg, dim, tile, reps,
                          width, chunk);
}

template <int V>
__global__ void __launch_bounds__(kThreads, 4)
    segment_sum_sorted_kernel(const float* __restrict__ g,
                              const int* __restrict__ seg,
                              float* __restrict__ out, int n, int nseg,
                              int dim, int tile, int reps, int width,
                              int chunk) {
  segment_block<true, V>(g, seg, nullptr, out, n, nseg, dim, tile, reps,
                         width, chunk);
}

// What the kernels assume of a plan: a tile's (segment, column) pairs fit
// the block, a stage fits its rows, 16-byte copies only on 16-byte rows.
bool plan_ok(const void* g, const void* out, int n, int nseg, int dim,
             int tile, int reps, int width, int chunk, int vec) {
  if (n < 0 || nseg <= 0 || dim <= 0) return false;
  if (width < 1 || width > kMaxWidth || width > dim) return false;
  if (vec != 1 && vec != 4) return false;
  if (vec == 4 && (dim % 4 || width % 4 ||
                   ((uintptr_t)g | (uintptr_t)out) % 16))
    return false;
  if (tile < 1 || tile * width > kThreads) return false;
  if (reps < 1 || reps > kMaxReps) return false;
  if (chunk < 1 || chunk * (width / vec) > kStageGroups) return false;
  return (dim + width - 1) / width <= 65535;
}

// Launch `kernel` (one of the four instantiations) on a checked plan,
// with the shared memory of its ring and ranges opted into.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int nseg, int dim, int tile, int reps, int width,
           int chunk, void* stream, Args... args) {
  const dim3 grid(
      (unsigned)(((long long)nseg + (long long)tile * reps - 1) /
                 ((long long)tile * reps)),
      (unsigned)((dim + width - 1) / width));
  const size_t smem = sizeof(float) * kStages * chunk * width +
                      sizeof(int) * (tile * reps + 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args..., tile, reps, width, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Kernel 7.  g: [n, dim] f32 contiguous; order: [n] int32, the rows stably
// sorted by segment; offsets: [nseg + 1] int32, segment s owns
// order[offsets[s] .. offsets[s + 1]); out: [nseg, dim] f32 contiguous,
// every element written.  tile, reps, width, chunk, vec: the launch plan.
// Returns the CUDA error of the launch (0 on success).
int segment_sum_f32(const void* g, const void* order, const void* offsets,
                    void* out, int n, int nseg, int dim, int tile, int reps,
                    int width, int chunk, int vec, void* stream) {
  if (!plan_ok(g, out, n, nseg, dim, tile, reps, width, chunk, vec))
    return (int)cudaErrorInvalidValue;
  return launch(vec == 4 ? segment_sum_kernel<4> : segment_sum_kernel<1>,
                nseg, dim, tile, reps, width, chunk, stream,
                static_cast<const float*>(g), static_cast<const int*>(order),
                static_cast<const int*>(offsets), static_cast<float*>(out),
                n, nseg, dim);
}

// Kernel 8.  g: [n, dim] f32 contiguous, the rows in segment order; seg:
// [n] int32 ascending, each in [0, nseg); out: [nseg, dim] f32 contiguous,
// every element written.  tile, reps, width, chunk, vec: the launch plan.
// Returns the CUDA error of the launch (0 on success).
int segment_sum_sorted_f32(const void* g, const void* seg, void* out, int n,
                           int nseg, int dim, int tile, int reps, int width,
                           int chunk, int vec, void* stream) {
  if (!plan_ok(g, out, n, nseg, dim, tile, reps, width, chunk, vec))
    return (int)cudaErrorInvalidValue;
  return launch(
      vec == 4 ? segment_sum_sorted_kernel<4> : segment_sum_sorted_kernel<1>,
      nseg, dim, tile, reps, width, chunk, stream,
      static_cast<const float*>(g), static_cast<const int*>(seg),
      static_cast<float*>(out), n, nseg, dim);
}

}  // extern "C"

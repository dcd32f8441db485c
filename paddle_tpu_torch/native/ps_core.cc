// Native sparse-table core for the parameter-server path — the PS data
// plane lives HERE, not in Python.
//
// TPU-native equivalent of the reference's C++ sparse table stack
// (reference: paddle/fluid/distributed/table/common_sparse_table.cc,
// operators/distributed/large_scale_kv.h — unbounded id->row storage with
// per-row optimizer state, lazily initialised, sharded + locked for
// concurrent trainer threads; framework/fleet/fleet_wrapper.h:111-185
// PullSparseVarsSync / PushSparseVarsWithLabelAsync — the batched C++
// hot loop this file is the analog of).
//
// Design (not a port):
//  - N shards, each an OPEN-ADDRESSING directory (linear probe, power-of-2
//    capacity) of Slot{id, row, seen, flags}: one probe resolves the row
//    index, the admission verdict, and the sighting counter together.
//  - Rows live in a chunked float32 arena (16k rows/chunk) so row
//    pointers never move; row stride = dim * (1 value + optimizer-state
//    slots) + 1 step slot; SGD:0 extra, AdaGrad:1 (accumulator),
//    Adam:2 (m, v).
//  - pull(ids, out): per-shard dedup, then ONE directory probe +
//    admission verdict per unique id; duplicate positions memcpy from
//    the same resolved row. A pull counts ONE sighting per unique id and
//    every occurrence gets the same verdict (zeros or the row) — the
//    Python SparseTable admission contract, now in C.
//  - push(ids, grads): FUSED dedup + segment-sum + optimizer apply in
//    one pass — duplicate ids' gradients are accumulated first and the
//    optimizer applies ONCE per unique id (the reference's
//    PushSparse merge semantics; also what makes AdaGrad/Adam correct
//    under duplicate ids).
//  - Admission entries native: count-filter (admit after K sightings)
//    and probability (deterministic splitmix-style per-id hash, BIT-EXACT
//    with python/paddle_tpu/distributed/entry.py so the two backends
//    admit identical subsets). Rejected probability ids leave NO slot
//    behind; rejected count ids keep only the counter (row = -1).
//  - Per-id deterministic init: splitmix64(seed ^ id) -> Box-Muller
//    normal(0, init_std). Pull/push order and shard count never change
//    the model.
//  - pull/push fan out over worker threads grouped by shard: each shard
//    lock is taken once per call, not once per id.
//
// Additions for the rows-beyond-RAM tier:
//  - Tiered storage: cold rows demote to a memory-mapped per-shard spill
//    file (record = [int64 id | stride floats], 8-byte padded; the
//    payload is written BEFORE the id, so a SIGKILL mid-sweep leaves
//    every record either whole-old or whole-new — id >= 0 is the commit
//    mark). The TTL sweep DEMOTES instead of evicting when spill is on;
//    any access through row_of() transparently promotes (spill -> arena
//    copy, record freed, arena row reused from a free list). Exports
//    read spilled rows in place — checkpoints stay bit-exact and
//    placement-independent.
//  - Geo LWW stamp directory: (lamport seq, interned site index) lives
//    IN the slot next to id/row/touched — vocab-scale stamps without a
//    server-side Python dict. gseq = -1 means "no stamp" (the Python
//    dict's .get(k, (-1, "")) default).
//  - SIMD fused push: AVX2 mul/add/sub/div/sqrt (each correctly
//    rounded, NO FMA — built with -ffp-contract=off) in the exact
//    scalar evaluation order, so SIMD == scalar bit-for-bit. Runtime
//    toggle via pts_set_simd for the parity suite.
//  - int8 wire rows: per-row symmetric quantization (scale =
//    max|row|/127, nearbyintf ties-to-even == np.rint) for the
//    quarter-egress serving pull.
//  - Zero-copy batched pull: pts_resolve hands the caller raw arena
//    VALUE addresses under a shared "pin" (pin_mu) that row-moving
//    mutators take exclusively — the service layer sendmsg()s straight
//    from the arena with zero staging copies.
//    Lock order: Table::pin_mu -> Shard::mu (never the reverse).
//
// C ABI only (loaded via ctypes; pybind11 is not in this image).
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <vector>

#include <cerrno>
#include <fcntl.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kRowsPerChunk = 1 << 14;

enum Opt { kSGD = 0, kAdaGrad = 1, kAdam = 2 };
enum EntryMode { kNoEntry = 0, kCountEntry = 1, kProbEntry = 2 };

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// BIT-EXACT mirror of ProbabilityEntry.admit (distributed/entry.py):
// both backends must admit the identical subset for a given probability.
static inline bool prob_admit(int64_t id, double p) {
  uint64_t h = (uint64_t)id * 0x9E3779B97F4A7C15ULL;
  h ^= h >> 31;
  h *= 0xBF58476D1CE4E5B9ULL;
  h ^= h >> 29;
  return (double)h * (1.0 / 18446744073709551616.0) < p;
}

constexpr uint32_t kOccupied = 1u;
constexpr uint32_t kAdmitted = 2u;
// row field holds a SPILL RECORD index, not an arena row
constexpr uint32_t kSpilled = 4u;

// SIMD fused-push toggle (1 = use AVX2 when compiled in). The parity
// suite flips this to prove SIMD == scalar bit-for-bit.
static std::atomic<int> g_simd{1};

struct Slot {
  int64_t id;
  int64_t row;    // arena row index; -1 = admission counter only, no row
  uint32_t seen;  // sighting count (count-filter entries, pre-admission)
  uint32_t flags;
  // feature-lifecycle last-sighting tick: stamped from the
  // table clock on every pull/push/push_delta that touches the id; a
  // TTL sweep evicts slots whose tick is older than the cutoff
  uint64_t touched;
  // geo LWW stamp: lamport seq + interned
  // site index, -1 = unstamped. Lives with the slot so stamp storage
  // scales with the directory, not a Python dict.
  int64_t gseq = -1;
  int32_t gsite = -1;
};

struct Shard {
  std::vector<Slot> slots;  // open addressing, power-of-2, linear probe
  uint64_t used = 0;        // occupied slots
  uint64_t rows_used = 0;   // arena rows allocated (high-water mark)
  std::vector<float*> chunks;
  std::vector<int64_t> free_rows;  // arena rows freed by demotion
  // -- spill tier: mmap'd per-shard cold-row file ----------
  int spill_fd = -1;
  char* spill_map = nullptr;
  size_t spill_cap = 0;       // mapped bytes
  uint64_t spill_used = 0;    // record high-water mark
  uint64_t spilled = 0;       // live spilled rows in this shard
  std::vector<int64_t> spill_free;  // freed record indices
  std::mutex mu;

  ~Shard() {
    for (float* c : chunks) delete[] c;
    if (spill_map != nullptr) munmap(spill_map, spill_cap);
    if (spill_fd >= 0) close(spill_fd);
  }
};

struct Table {
  int dim;
  int opt;
  float lr, beta1, beta2, eps, init_std;
  uint64_t seed;
  int n_shards;
  int stride;  // floats per row incl. optimizer state + step counter
  int entry_mode = kNoEntry;
  double entry_param = 0.0;  // count threshold / admit probability
  // last-seq: count of applied mutating batches (push/push_delta),
  // exposed alongside the id directory so a replica's catch-up can be
  // audited (primary and caught-up standby report the same version)
  std::atomic<uint64_t> version{0};
  // feature-lifecycle clock: a caller-advanced logical tick
  // (the sweeper stamps wall seconds); touches copy it into the slot.
  // Sightings are therefore timestamped at sweep-interval granularity.
  std::atomic<uint64_t> clock{0};
  // churn counters: rows newly materialised via admission (imports
  // excluded) / slots removed by sweeps — the ps_feature_admitted /
  // ps_feature_evicted metric sources
  std::atomic<uint64_t> admitted_total{0};
  std::atomic<uint64_t> evicted_total{0};
  // tier churn counters
  std::atomic<uint64_t> promoted_total{0};
  std::atomic<uint64_t> demoted_total{0};
  bool spill_on = false;
  int rec_bytes = 0;  // spill record size: 8 (id) + stride floats, 8B-padded
  // Zero-copy pull pin: resolvers hold it SHARED across the
  // resolve-and-send window; every mutator that can move or rewrite
  // row bytes (push/push_delta/set_vals/sweep/evict/import/clear)
  // takes it EXCLUSIVE first. Lock order: pin_mu -> Shard::mu.
  std::shared_mutex pin_mu;
  std::vector<Shard> shards;

  Table(int dim_, int opt_, float lr_, float b1, float b2, float eps_,
        float std_, uint64_t seed_, int n_shards_)
      : dim(dim_), opt(opt_), lr(lr_), beta1(b1), beta2(b2), eps(eps_),
        init_std(std_), seed(seed_), n_shards(n_shards_),
        shards(n_shards_) {
    int state_slots = opt == kAdam ? 2 : (opt == kAdaGrad ? 1 : 0);
    stride = dim * (1 + state_slots) + 1;  // +1: per-row step counter
    rec_bytes = (int)((8 + 4 * (size_t)stride + 7) & ~(size_t)7);
  }

  int shard_of(int64_t id) const {
    return (int)(splitmix64((uint64_t)id) % (uint64_t)n_shards);
  }

  // directory hash must be independent of shard_of (which consumes the
  // low splitmix bits via % n_shards): re-mix, or every id in a shard
  // would collide into 1/n_shards of the buckets
  static uint64_t slot_hash(int64_t id) {
    return splitmix64(splitmix64((uint64_t)id) ^ 0x517cc1b727220a95ULL);
  }

  // caller holds s.mu for all directory/arena ops ------------------------
  Slot* find(Shard& s, int64_t id) const {
    if (s.slots.empty()) return nullptr;
    uint64_t mask = s.slots.size() - 1;
    uint64_t i = slot_hash(id) & mask;
    while (s.slots[i].flags & kOccupied) {
      if (s.slots[i].id == id) return &s.slots[i];
      i = (i + 1) & mask;
    }
    return nullptr;
  }

  void grow(Shard& s) {
    size_t ncap = s.slots.empty() ? 1024 : s.slots.size() * 2;
    std::vector<Slot> old;
    old.swap(s.slots);
    s.slots.assign(ncap, Slot{0, -1, 0, 0, 0});
    uint64_t mask = ncap - 1;
    for (Slot& sl : old) {
      if (!(sl.flags & kOccupied)) continue;
      uint64_t i = slot_hash(sl.id) & mask;
      while (s.slots[i].flags & kOccupied) i = (i + 1) & mask;
      s.slots[i] = sl;
    }
  }

  // find-or-create; may grow (invalidating previously returned Slot*)
  Slot* insert(Shard& s, int64_t id) {
    if (s.slots.empty() || (s.used + 1) * 10 >= s.slots.size() * 7)
      grow(s);
    uint64_t mask = s.slots.size() - 1;
    uint64_t i = slot_hash(id) & mask;
    while (s.slots[i].flags & kOccupied) {
      if (s.slots[i].id == id) return &s.slots[i];
      i = (i + 1) & mask;
    }
    s.slots[i] = Slot{id, -1, 0, kOccupied,
                      clock.load(std::memory_order_relaxed)};
    ++s.used;
    return &s.slots[i];
  }

  float* row_ptr(Shard& s, int64_t row) const {
    return s.chunks[row / kRowsPerChunk] +
           (size_t)(row % kRowsPerChunk) * stride;
  }

  // -- spill tier ----------------------------------------------------
  // caller holds s.mu for every spill op
  int64_t* spill_id(Shard& s, int64_t rec) const {
    return (int64_t*)(s.spill_map + (size_t)rec * rec_bytes);
  }
  float* spill_payload(Shard& s, int64_t rec) const {
    return (float*)(s.spill_map + (size_t)rec * rec_bytes + 8);
  }

  bool spill_reserve(Shard& s, uint64_t rec) {
    size_t need = ((size_t)rec + 1) * rec_bytes;
    if (need <= s.spill_cap) return true;
    size_t ncap = s.spill_cap ? s.spill_cap : (size_t)rec_bytes * 1024;
    while (ncap < need) ncap *= 2;
    struct stat st;
    if (fstat(s.spill_fd, &st) != 0) return false;
    size_t old_size = (size_t)st.st_size;  // pre-grow EOF, NOT spill_cap:
    // on recovery the map starts cold (spill_cap 0) over a file that
    // already holds committed records
    if (ftruncate(s.spill_fd, (off_t)ncap) != 0) return false;
    // remap wholesale: spill addresses are only ever used under the
    // shard lock within one call, so the base may move freely
    if (s.spill_map != nullptr) munmap(s.spill_map, s.spill_cap);
    void* m = mmap(nullptr, ncap, PROT_READ | PROT_WRITE, MAP_SHARED,
                   s.spill_fd, 0);
    if (m == MAP_FAILED) {
      s.spill_map = nullptr;
      s.spill_cap = 0;
      return false;
    }
    s.spill_map = (char*)m;
    s.spill_cap = ncap;
    // ftruncate zero-fills, and id 0 is a VALID feature id — stamp the
    // freshly grown records invalid so pts_spill_recover never mistakes
    // never-written space for committed rows
    for (uint64_t r = old_size / rec_bytes; r < ncap / (size_t)rec_bytes; ++r)
      *spill_id(s, r) = -1;
    return true;
  }

  int64_t spill_alloc(Shard& s) {
    if (!s.spill_free.empty()) {
      int64_t r = s.spill_free.back();
      s.spill_free.pop_back();
      return r;
    }
    uint64_t rec = s.spill_used;
    if (!spill_reserve(s, rec)) return -1;
    s.spill_used = rec + 1;
    return (int64_t)rec;
  }

  void spill_free_rec(Shard& s, int64_t rec) {
    *spill_id(s, rec) = -1;
    s.spill_free.push_back(rec);
  }

  int64_t alloc_arena_row(Shard& s) {
    if (!s.free_rows.empty()) {
      int64_t r = s.free_rows.back();
      s.free_rows.pop_back();
      return r;
    }
    uint64_t idx = s.rows_used++;
    if (idx / kRowsPerChunk >= s.chunks.size())
      s.chunks.push_back(new float[(size_t)kRowsPerChunk * stride]);
    return (int64_t)idx;
  }

  // read a slot's row WITHOUT promoting — exports/checkpoints read
  // spilled rows in place so a save never churns the tier
  const float* row_read(Shard& s, const Slot& sl) const {
    if (sl.flags & kSpilled) return spill_payload(s, sl.row);
    return row_ptr(s, sl.row);
  }

  // materialise the slot's arena row (deterministic init unless the
  // caller will overwrite it wholesale, e.g. import). A spilled slot
  // transparently PROMOTES here: spill payload -> arena (bit-exact
  // stride copy), record freed — the pull-promotes contract.
  float* row_of(Shard& s, Slot* sl, bool init) {
    if (sl->flags & kSpilled) {
      int64_t arow = alloc_arena_row(s);
      float* r = row_ptr(s, arow);
      std::memcpy(r, spill_payload(s, sl->row), sizeof(float) * stride);
      spill_free_rec(s, sl->row);
      sl->row = arow;
      sl->flags &= ~kSpilled;
      --s.spilled;
      promoted_total.fetch_add(1, std::memory_order_relaxed);
      return r;
    }
    if (sl->row < 0) {
      sl->row = alloc_arena_row(s);
      float* r = row_ptr(s, sl->row);
      if (init) {
        init_row(r, sl->id);
        // a freshly materialised (admitted) feature — imports restore,
        // they don't admit, and pass init=false
        admitted_total.fetch_add(1, std::memory_order_relaxed);
      }
      return r;
    }
    return row_ptr(s, sl->row);
  }

  void init_row(float* r, int64_t id) {
    uint64_t st = splitmix64(seed ^ (uint64_t)id);
    for (int j = 0; j < dim; j += 2) {
      // Box-Muller from two splitmix64 draws
      st = splitmix64(st);
      double u1 = ((st >> 11) + 1.0) * (1.0 / 9007199254740993.0);
      st = splitmix64(st);
      double u2 = (st >> 11) * (1.0 / 9007199254740992.0);
      double m = std::sqrt(-2.0 * std::log(u1)) * init_std;
      r[j] = (float)(m * std::cos(6.283185307179586 * u2));
      if (j + 1 < dim)
        r[j + 1] = (float)(m * std::sin(6.283185307179586 * u2));
    }
    std::memset(r + dim, 0, sizeof(float) * (stride - dim));
  }

#if defined(__AVX2__)
  // Vectorized optimizer apply. Every intrinsic used here
  // (mul/add/sub/div/sqrt) is IEEE correctly rounded and the evaluation
  // order reproduces the scalar loop op-for-op — no FMA (the build
  // passes -ffp-contract=off so the scalar path can't contract either),
  // no reassociation. SIMD output is therefore bit-identical to scalar,
  // which the tiering parity suite asserts via the pts_set_simd toggle.
  void apply_avx2(float* r, const float* g) {
    float* v = r;
    int j = 0;
    switch (opt) {
      case kSGD: {
        __m256 vlr = _mm256_set1_ps(lr);
        for (; j + 8 <= dim; j += 8) {
          __m256 gv = _mm256_loadu_ps(g + j);
          __m256 xv = _mm256_loadu_ps(v + j);
          xv = _mm256_sub_ps(xv, _mm256_mul_ps(vlr, gv));
          _mm256_storeu_ps(v + j, xv);
        }
        for (; j < dim; ++j) v[j] -= lr * g[j];
        break;
      }
      case kAdaGrad: {
        float* acc = r + dim;
        __m256 vlr = _mm256_set1_ps(lr);
        __m256 veps = _mm256_set1_ps(eps);
        for (; j + 8 <= dim; j += 8) {
          __m256 gv = _mm256_loadu_ps(g + j);
          __m256 av = _mm256_loadu_ps(acc + j);
          av = _mm256_add_ps(av, _mm256_mul_ps(gv, gv));
          _mm256_storeu_ps(acc + j, av);
          __m256 num = _mm256_mul_ps(vlr, gv);
          __m256 den = _mm256_add_ps(_mm256_sqrt_ps(av), veps);
          __m256 xv = _mm256_loadu_ps(v + j);
          xv = _mm256_sub_ps(xv, _mm256_div_ps(num, den));
          _mm256_storeu_ps(v + j, xv);
        }
        for (; j < dim; ++j) {
          acc[j] += g[j] * g[j];
          v[j] -= lr * g[j] / (std::sqrt(acc[j]) + eps);
        }
        break;
      }
      case kAdam: {
        float* m = r + dim;
        float* vv = r + 2 * dim;
        float t = r[stride - 1];
        float bc1 = 1.0f - std::pow(beta1, t);
        float bc2 = 1.0f - std::pow(beta2, t);
        __m256 vb1 = _mm256_set1_ps(beta1);
        __m256 vb2 = _mm256_set1_ps(beta2);
        __m256 vc1 = _mm256_set1_ps(1.0f - beta1);
        __m256 vc2 = _mm256_set1_ps(1.0f - beta2);
        __m256 vbc1 = _mm256_set1_ps(bc1);
        __m256 vbc2 = _mm256_set1_ps(bc2);
        __m256 vlr = _mm256_set1_ps(lr);
        __m256 veps = _mm256_set1_ps(eps);
        for (; j + 8 <= dim; j += 8) {
          __m256 gv = _mm256_loadu_ps(g + j);
          __m256 mv = _mm256_loadu_ps(m + j);
          // scalar order: beta1*m + (1-beta1)*g — two mults, one add
          mv = _mm256_add_ps(_mm256_mul_ps(vb1, mv),
                             _mm256_mul_ps(vc1, gv));
          _mm256_storeu_ps(m + j, mv);
          __m256 vvv = _mm256_loadu_ps(vv + j);
          // scalar order: beta2*vv + ((1-beta2)*g)*g (left-assoc)
          vvv = _mm256_add_ps(
              _mm256_mul_ps(vb2, vvv),
              _mm256_mul_ps(_mm256_mul_ps(vc2, gv), gv));
          _mm256_storeu_ps(vv + j, vvv);
          __m256 num = _mm256_mul_ps(vlr, _mm256_div_ps(mv, vbc1));
          __m256 den = _mm256_add_ps(
              _mm256_sqrt_ps(_mm256_div_ps(vvv, vbc2)), veps);
          __m256 xv = _mm256_loadu_ps(v + j);
          xv = _mm256_sub_ps(xv, _mm256_div_ps(num, den));
          _mm256_storeu_ps(v + j, xv);
        }
        for (; j < dim; ++j) {
          m[j] = beta1 * m[j] + (1.0f - beta1) * g[j];
          vv[j] = beta2 * vv[j] + (1.0f - beta2) * g[j] * g[j];
          v[j] -= lr * (m[j] / bc1) / (std::sqrt(vv[j] / bc2) + eps);
        }
        break;
      }
    }
  }
#endif

  void apply(float* r, const float* g) {
    float* v = r;
    float* step = r + stride - 1;
    *step += 1.0f;
#if defined(__AVX2__)
    if (g_simd.load(std::memory_order_relaxed) && dim >= 8) {
      apply_avx2(r, g);
      return;
    }
#endif
    switch (opt) {
      case kSGD:
        for (int j = 0; j < dim; ++j) v[j] -= lr * g[j];
        break;
      case kAdaGrad: {
        float* acc = r + dim;
        for (int j = 0; j < dim; ++j) {
          acc[j] += g[j] * g[j];
          v[j] -= lr * g[j] / (std::sqrt(acc[j]) + eps);
        }
        break;
      }
      case kAdam: {
        float* m = r + dim;
        float* vv = r + 2 * dim;
        float t = *step;
        float bc1 = 1.0f - std::pow(beta1, t);
        float bc2 = 1.0f - std::pow(beta2, t);
        for (int j = 0; j < dim; ++j) {
          m[j] = beta1 * m[j] + (1.0f - beta1) * g[j];
          vv[j] = beta2 * vv[j] + (1.0f - beta2) * g[j] * g[j];
          v[j] -= lr * (m[j] / bc1) / (std::sqrt(vv[j] / bc2) + eps);
        }
        break;
      }
    }
  }

  // Admission verdict for one unique id. counting=true is the pull path
  // (each pull is ONE sighting per unique id); false is the push path
  // (grads never count as sightings). Returns the row pointer when
  // admitted (creating the row), nullptr when the id pulls zeros /
  // drops its grad. Mirrors SparseTable._filter_admitted exactly.
  float* admit_row(Shard& s, int64_t id, bool counting) {
    uint64_t now = clock.load(std::memory_order_relaxed);
    switch (entry_mode) {
      case kNoEntry: {
        Slot* sl = insert(s, id);
        sl->touched = now;  // every sighting refreshes the TTL clock
        return row_of(s, sl, true);
      }
      case kCountEntry: {
        Slot* sl = insert(s, id);
        sl->touched = now;  // pre-admission counters age out too
        if (sl->flags & kAdmitted) return row_of(s, sl, true);
        if (counting) ++sl->seen;
        if ((double)sl->seen >= entry_param) {
          sl->flags |= kAdmitted;
          sl->seen = 0;  // python pops the counter on admit
          return row_of(s, sl, true);
        }
        return nullptr;
      }
      default: {  // kProbEntry
        Slot* sl = find(s, id);
        if (sl != nullptr && (sl->flags & kAdmitted)) {
          sl->touched = now;
          return row_of(s, sl, true);
        }
        if (!prob_admit(id, entry_param)) return nullptr;
        // rejected ids leave NO slot behind (ProbabilityEntry is
        // count-independent — the memory the entry exists to save)
        sl = insert(s, id);
        sl->flags |= kAdmitted;
        sl->touched = now;
        return row_of(s, sl, true);
      }
    }
  }

  // Drop every occupied slot whose last sighting predates ``cutoff``
  // (counter-only slots included), rebuilding the shard's directory
  // and compacting its arena.  Surviving rows are memcpy'd whole
  // stride — value, optimizer moments and step counter keep their
  // exact bits, which is what makes post-sweep checkpoints/replica
  // snapshots round-trip exact.  Evicted ids are appended to ``out``
  // up to ``cap``; a slot whose eviction would overflow the caller's
  // buffer is LEFT IN PLACE for the next sweep (everything reported
  // is everything evicted — the replica replay depends on that).
  int64_t sweep_shard(Shard& s, uint64_t cutoff, int64_t* out,
                      int64_t cap, int64_t n_out) {
    int64_t wrote = 0;
    bool any = false;
    for (auto& sl : s.slots)
      if ((sl.flags & kOccupied) && sl.touched < cutoff) { any = true; break; }
    if (!any) return 0;
    std::vector<Slot> surv;
    surv.reserve(s.used);
    for (auto& sl : s.slots) {
      if (!(sl.flags & kOccupied)) continue;
      if (sl.touched < cutoff && (out == nullptr || n_out + wrote < cap)) {
        if (out != nullptr) out[n_out + wrote] = sl.id;
        // an evicted SPILLED slot releases its cold record too
        if (sl.flags & kSpilled) {
          spill_free_rec(s, sl.row);
          --s.spilled;
        }
        ++wrote;
        continue;
      }
      surv.push_back(sl);
    }
    rebuild_shard(s, surv);
    return wrote;
  }

  // Demote-instead-of-evict sweep: every cold slot with a
  // materialised arena row moves to the shard's spill file — payload
  // written BEFORE the id so a SIGKILL mid-copy leaves the record
  // uncommitted (id stays -1/stale) instead of torn. The arena row
  // joins the free list (rows never move, so pinned zero-copy sends
  // stay valid — freed rows aren't being sent). Demotion is a LOCAL
  // placement decision: no version tick, nothing forwarded to
  // replicas, directory untouched (the slot keeps its admission state,
  // TTL tick and geo stamp).
  int64_t demote_shard(Shard& s, uint64_t cutoff) {
    int64_t n = 0;
    for (auto& sl : s.slots) {
      if (!(sl.flags & kOccupied) || sl.row < 0 || (sl.flags & kSpilled))
        continue;
      if (sl.touched >= cutoff) continue;
      int64_t rec = spill_alloc(s);
      if (rec < 0) break;  // file grow failed: stop demoting, stay hot
      float* src = row_ptr(s, sl.row);
      float* dst = spill_payload(s, rec);
      std::memcpy(dst, src, sizeof(float) * stride);
      *spill_id(s, rec) = sl.id;  // commit mark LAST
      s.free_rows.push_back(sl.row);
      sl.row = rec;
      sl.flags |= kSpilled;
      ++s.spilled;
      ++n;
    }
    return n;
  }

  // Re-seat ``surv`` (slot copies holding OLD arena row indices) as the
  // shard's whole population: compact the arena (bit-exact row copies)
  // and rebuild the open-addressing directory. Spilled survivors keep
  // their spill record untouched — only arena rows compact.
  void rebuild_shard(Shard& s, std::vector<Slot>& surv) {
    std::vector<float*> nchunks;
    uint64_t nrows = 0;
    for (auto& sl : surv) {
      if (sl.row < 0 || (sl.flags & kSpilled)) continue;
      if (nrows / kRowsPerChunk >= nchunks.size())
        nchunks.push_back(new float[(size_t)kRowsPerChunk * stride]);
      float* dst = nchunks[nrows / kRowsPerChunk] +
                   (size_t)(nrows % kRowsPerChunk) * stride;
      std::memcpy(dst, row_ptr(s, sl.row), sizeof(float) * stride);
      sl.row = (int64_t)nrows++;
    }
    for (float* c : s.chunks) delete[] c;
    s.chunks = std::move(nchunks);
    s.rows_used = nrows;
    s.free_rows.clear();
    size_t ncap = 1024;
    while ((surv.size() + 1) * 10 >= ncap * 7) ncap <<= 1;
    s.slots.assign(ncap, Slot{0, -1, 0, 0, 0});
    s.used = 0;
    uint64_t mask = ncap - 1;
    for (auto& sl : surv) {
      uint64_t i = slot_hash(sl.id) & mask;
      while (s.slots[i].flags & kOccupied) i = (i + 1) & mask;
      s.slots[i] = sl;
      ++s.used;
    }
  }
};

// Per-shard batched fan-out: positions grouped by shard once, worker
// threads claim whole shards — one lock acquisition per (call, shard).
// fn(shard_index, positions) owns the shard's slice of the batch.
template <typename Fn>
void for_each_shard_batch(Table* t, const int64_t* ids, int64_t n, Fn fn) {
  std::vector<std::vector<int64_t>> by_shard(t->n_shards);
  for (int64_t i = 0; i < n; ++i)
    by_shard[t->shard_of(ids[i])].push_back(i);
  int hw = (int)std::thread::hardware_concurrency();
  int workers = std::min(t->n_shards, std::max(1, std::min(hw, 16)));
  if (n < 4096) workers = 1;  // small batches: thread spawn dominates
  std::atomic<int> next{0};
  auto run = [&]() {
    int s;
    while ((s = next.fetch_add(1)) < t->n_shards) {
      if (by_shard[s].empty()) continue;
      Shard& sh = t->shards[s];
      std::lock_guard<std::mutex> lk(sh.mu);
      fn(s, by_shard[s]);
    }
  };
  if (workers == 1) {
    run();
  } else {
    std::vector<std::thread> th;
    for (int w = 0; w < workers; ++w) th.emplace_back(run);
    for (auto& x : th) x.join();
  }
}

// Segment-sum accumulate a[j] += g[j] (SIMD): lane-parallel
// over j keeps the scalar loop's i-ordering of additions, and
// _mm256_add_ps is correctly rounded — bit-identical to the scalar
// loop (which -ffp-contract=off keeps un-contracted too).
static inline void vec_add(float* a, const float* g, int dim) {
  int j = 0;
#if defined(__AVX2__)
  if (g_simd.load(std::memory_order_relaxed)) {
    for (; j + 8 <= dim; j += 8)
      _mm256_storeu_ps(
          a + j, _mm256_add_ps(_mm256_loadu_ps(a + j),
                               _mm256_loadu_ps(g + j)));
  }
#endif
  for (; j < dim; ++j) a[j] += g[j];
}

// Local first-occurrence dedup of a shard's positions: fills u_of
// (position -> unique index) and uniq (unique ids in first-touch order).
void dedup(const int64_t* ids, const std::vector<int64_t>& pos,
           std::vector<int32_t>& u_of, std::vector<int64_t>& uniq) {
  size_t m = pos.size();
  size_t cap = 16;
  while (cap < 2 * m) cap <<= 1;
  std::vector<int64_t> keys(cap);
  std::vector<int32_t> vals(cap, -1);
  u_of.resize(m);
  uniq.clear();
  uint64_t mask = cap - 1;
  for (size_t p = 0; p < m; ++p) {
    int64_t id = ids[pos[p]];
    uint64_t i = Table::slot_hash(id) & mask;
    while (vals[i] >= 0 && keys[i] != id) i = (i + 1) & mask;
    if (vals[i] < 0) {
      keys[i] = id;
      vals[i] = (int32_t)uniq.size();
      uniq.push_back(id);
    }
    u_of[p] = vals[i];
  }
}

}  // namespace

extern "C" {

void* pts_create(int dim, int opt, float lr, float beta1, float beta2,
                 float eps, float init_std, uint64_t seed, int n_shards) {
  if (n_shards <= 0) n_shards = 32;
  return new Table(dim, opt, lr, beta1, beta2, eps, init_std, seed,
                   n_shards);
}

void pts_free(void* h) { delete (Table*)h; }

void pts_set_lr(void* h, float lr) { ((Table*)h)->lr = lr; }

// last-seq accessors: the applied-mutation counter travels with
// checkpoints/replication snapshots (pts_import resets rows, the
// caller restores the counter alongside)
uint64_t pts_version(void* h) {
  return ((Table*)h)->version.load(std::memory_order_relaxed);
}

void pts_set_version(void* h, uint64_t v) {
  ((Table*)h)->version.store(v, std::memory_order_relaxed);
}

// feature admission policy: mode 1 = count filter (param = threshold),
// mode 2 = probability (param = admit probability), 0 = none
void pts_set_entry(void* h, int mode, double param) {
  Table* t = (Table*)h;
  t->entry_mode = mode;
  t->entry_param = param;
}

// -- feature lifecycle -----------------------------------------------

// advance the table's logical clock (the TTL sweeper stamps wall
// seconds once per tick; touches copy the current value)
void pts_set_clock(void* h, uint64_t now) {
  ((Table*)h)->clock.store(now, std::memory_order_relaxed);
}

// grandfather pass: stamp EVERY occupied slot (and the clock) to
// ``now`` — rows of unknown age (created before any lifecycle ran,
// e.g. pre-sweeper history or a restored checkpoint) age from the
// sweeper's start instead of being evicted as tick-0 ancients
void pts_touch_all(void* h, uint64_t now) {
  Table* t = (Table*)h;
  t->clock.store(now, std::memory_order_relaxed);
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    for (auto& sl : s.slots)
      if (sl.flags & kOccupied) sl.touched = now;
  }
}

uint64_t pts_admitted_total(void* h) {
  return ((Table*)h)->admitted_total.load(std::memory_order_relaxed);
}

uint64_t pts_evicted_total(void* h) {
  return ((Table*)h)->evicted_total.load(std::memory_order_relaxed);
}

// occupied directory slots (materialised rows + admission counters) —
// the TTL sweep output-buffer bound
int64_t pts_slots(void* h) {
  Table* t = (Table*)h;
  int64_t n = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    n += (int64_t)s.used;
  }
  return n;
}

// TTL sweep: evict every slot whose last sighting predates ``cutoff``.
// Evicted ids are written to ``out`` (up to ``cap``); slots that would
// overflow the buffer survive until the next sweep, so the return value
// counts EXACTLY the ids written — the caller forwards that list to
// replicas verbatim.  Counts as one applied mutating batch (version)
// iff anything was evicted.
int64_t pts_ttl_sweep(void* h, uint64_t cutoff, int64_t* out,
                      int64_t cap) {
  Table* t = (Table*)h;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  int64_t n = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    n += t->sweep_shard(s, cutoff, out, cap, n);
  }
  if (n) {
    t->version.fetch_add(1, std::memory_order_relaxed);
    t->evicted_total.fetch_add((uint64_t)n, std::memory_order_relaxed);
  }
  return n;
}

// exact-id eviction — the replica-side replay of a primary's TTL sweep
// (the streamed ``evict`` record names the swept ids).  ALWAYS counts
// as one applied mutating batch: the primary's sweep that produced the
// record did, and version parity between primary and replica is the
// audited catch-up invariant.
int64_t pts_evict(void* h, const int64_t* ids, int64_t n) {
  Table* t = (Table*)h;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  int64_t removed = 0;
  std::vector<std::vector<int64_t>> by_shard(t->n_shards);
  for (int64_t i = 0; i < n; ++i)
    by_shard[t->shard_of(ids[i])].push_back(ids[i]);
  for (int sh = 0; sh < t->n_shards; ++sh) {
    if (by_shard[sh].empty()) continue;
    std::sort(by_shard[sh].begin(), by_shard[sh].end());
    Shard& s = t->shards[sh];
    std::lock_guard<std::mutex> lk(s.mu);
    std::vector<Slot> surv;
    surv.reserve(s.used);
    bool any = false;
    for (auto& sl : s.slots) {
      if (!(sl.flags & kOccupied)) continue;
      if (std::binary_search(by_shard[sh].begin(), by_shard[sh].end(),
                             sl.id)) {
        if (sl.flags & kSpilled) {
          t->spill_free_rec(s, sl.row);
          --s.spilled;
        }
        ++removed;
        any = true;
        continue;
      }
      surv.push_back(sl);
    }
    if (any) t->rebuild_shard(s, surv);
  }
  t->version.fetch_add(1, std::memory_order_relaxed);
  if (removed)
    t->evicted_total.fetch_add((uint64_t)removed,
                               std::memory_order_relaxed);
  return removed;
}

// LWW geo row replacement (conflict policy): set the VALUE
// part of each id's row wholesale — existing rows keep their optimizer
// moments/step, fresh rows materialise with zeroed state (no
// deterministic init: the incoming value IS the row).  Bypasses
// admission like pts_import, but marks the id admitted (the origin
// cluster admitted it — a replicated winner must not serve zeros).
// One applied mutating batch per call (empty calls included: the
// primary applies the winning subset of a geo_set record even when it
// is empty, and the replica replay must tick version identically).
void pts_set_vals(void* h, const int64_t* ids, int64_t n,
                  const float* vals) {
  Table* t = (Table*)h;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  t->version.fetch_add(1, std::memory_order_relaxed);
  for_each_shard_batch(t, ids, n, [&](int s, const std::vector<int64_t>& pos) {
    Shard& sh = t->shards[s];
    uint64_t now = t->clock.load(std::memory_order_relaxed);
    for (int64_t p : pos) {
      Slot* sl = t->insert(sh, ids[p]);
      bool fresh = sl->row < 0;
      float* r = t->row_of(sh, sl, /*init=*/false);
      if (fresh) std::memset(r, 0, sizeof(float) * t->stride);
      std::memcpy(r, vals + (size_t)p * t->dim,
                  sizeof(float) * t->dim);
      sl->flags |= kAdmitted;
      sl->touched = now;
    }
  });
}

// gather rows (lazy init, admission-aware) into out[n, dim]: ONE
// directory transaction per unique id; non-admitted ids write zeros at
// every one of their positions (one sighting per unique id per call)
void pts_pull(void* h, const int64_t* ids, int64_t n, float* out) {
  Table* t = (Table*)h;
  for_each_shard_batch(t, ids, n, [&](int s, const std::vector<int64_t>& pos) {
    Shard& sh = t->shards[s];
    std::vector<int32_t> u_of;
    std::vector<int64_t> uniq;
    dedup(ids, pos, u_of, uniq);
    // resolve each unique once; row pointers are stable under the shard
    // lock (arena rows never move), so duplicates just memcpy
    std::vector<float*> rowp(uniq.size());
    for (size_t u = 0; u < uniq.size(); ++u)
      rowp[u] = t->admit_row(sh, uniq[u], /*counting=*/true);
    for (size_t p = 0; p < pos.size(); ++p) {
      float* dst = out + (size_t)pos[p] * t->dim;
      float* r = rowp[u_of[p]];
      if (r != nullptr)
        std::memcpy(dst, r, sizeof(float) * t->dim);
      else
        std::memset(dst, 0, sizeof(float) * t->dim);
    }
  });
}

// FUSED push: dedup + segment-sum + admission filter + optimizer apply
// in one pass. Duplicate ids' grads accumulate first; the optimizer
// applies ONCE per unique id (correct AdaGrad/Adam merge semantics).
// Grads of never-admitted ids are dropped (their pulled zeros carried
// no signal); pushes do not count as sightings.
void pts_push(void* h, const int64_t* ids, int64_t n, const float* grads) {
  Table* t = (Table*)h;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  t->version.fetch_add(1, std::memory_order_relaxed);
  int dim = t->dim;
  for_each_shard_batch(t, ids, n, [&](int s, const std::vector<int64_t>& pos) {
    Shard& sh = t->shards[s];
    std::vector<int32_t> u_of;
    std::vector<int64_t> uniq;
    dedup(ids, pos, u_of, uniq);
    std::vector<float> acc(uniq.size() * (size_t)dim, 0.0f);
    for (size_t p = 0; p < pos.size(); ++p) {
      const float* g = grads + (size_t)pos[p] * dim;
      float* a = acc.data() + (size_t)u_of[p] * dim;
      vec_add(a, g, dim);
    }
    for (size_t u = 0; u < uniq.size(); ++u) {
      float* r = t->admit_row(sh, uniq[u], /*counting=*/false);
      if (r != nullptr) t->apply(r, acc.data() + u * (size_t)dim);
    }
  });
}

// geo-mode raw delta add (no optimizer); same fused dedup + admission
void pts_push_delta(void* h, const int64_t* ids, int64_t n,
                    const float* deltas) {
  Table* t = (Table*)h;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  t->version.fetch_add(1, std::memory_order_relaxed);
  int dim = t->dim;
  for_each_shard_batch(t, ids, n, [&](int s, const std::vector<int64_t>& pos) {
    Shard& sh = t->shards[s];
    std::vector<int32_t> u_of;
    std::vector<int64_t> uniq;
    dedup(ids, pos, u_of, uniq);
    std::vector<float> acc(uniq.size() * (size_t)dim, 0.0f);
    for (size_t p = 0; p < pos.size(); ++p) {
      const float* d = deltas + (size_t)pos[p] * dim;
      float* a = acc.data() + (size_t)u_of[p] * dim;
      vec_add(a, d, dim);
    }
    for (size_t u = 0; u < uniq.size(); ++u) {
      float* r = t->admit_row(sh, uniq[u], /*counting=*/false);
      if (r == nullptr) continue;
      const float* a = acc.data() + u * (size_t)dim;
      vec_add(r, a, dim);
    }
  });
}

// materialised rows only — admission counters (row == -1) don't count,
// matching the Python backend's len(self._rows). Spilled rows ARE rows
// (they're just cold); demoted arena slots on the free list are not.
int64_t pts_size(void* h) {
  Table* t = (Table*)h;
  int64_t n = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    n += (int64_t)(s.rows_used - s.free_rows.size() + s.spilled);
  }
  return n;
}

// two-phase export: ids/vals may be null to query count. vals gets the
// value part only (dim floats per row) — optimizer state stays server-side,
// matching the reference's save format (values persisted, state rebuilt).
// cap bounds the rows written so a table growing concurrently (trainer
// threads pull-initialise rows during checkpoint) can never overflow the
// caller's buffers; returns rows written (or total count when querying).
int64_t pts_export(void* h, int64_t* ids_out, float* vals_out,
                   int64_t cap) {
  Table* t = (Table*)h;
  int64_t n = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    if (ids_out == nullptr && vals_out == nullptr) {
      n += (int64_t)(s.rows_used - s.free_rows.size() + s.spilled);
      continue;
    }
    for (auto& sl : s.slots) {
      if (!(sl.flags & kOccupied) || sl.row < 0) continue;
      if (n >= cap) return n;
      if (ids_out) ids_out[n] = sl.id;
      if (vals_out)
        // row_read: spilled rows export in place (no promotion churn);
        // the npz checkpoint is bit-exact regardless of placement
        std::memcpy(vals_out + (size_t)n * t->dim, t->row_read(s, sl),
                    sizeof(float) * t->dim);
      ++n;
    }
  }
  return n;
}

// FULL-ROW export/import for REPLICATION snapshots.  Unlike
// pts_export (the disk checkpoint format: values persisted, optimizer
// state rebuilt — the reference's save semantics), a hot replica of a
// STATEFUL optimizer (adagrad/adam) must inherit the moments and
// per-row step counters, or every post-snapshot apply diverges from
// the primary's trajectory (fresh zero moments take bigger steps).
// rows_out carries the whole stride per row: [value(dim) | state | step].
int pts_stride(void* h) { return ((Table*)h)->stride; }

int64_t pts_export_full(void* h, int64_t* ids_out, float* rows_out,
                        int64_t cap) {
  Table* t = (Table*)h;
  int64_t n = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    if (ids_out == nullptr && rows_out == nullptr) {
      n += (int64_t)(s.rows_used - s.free_rows.size() + s.spilled);
      continue;
    }
    for (auto& sl : s.slots) {
      if (!(sl.flags & kOccupied) || sl.row < 0) continue;
      if (n >= cap) return n;
      if (ids_out) ids_out[n] = sl.id;
      if (rows_out)
        std::memcpy(rows_out + (size_t)n * t->stride,
                    t->row_read(s, sl), sizeof(float) * t->stride);
      ++n;
    }
  }
  return n;
}

void pts_import_full(void* h, const int64_t* ids, int64_t n,
                     const float* rows) {
  Table* t = (Table*)h;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  for_each_shard_batch(t, ids, n, [&](int s, const std::vector<int64_t>& pos) {
    Shard& sh = t->shards[s];
    for (int64_t p : pos) {
      float* r = t->row_of(sh, t->insert(sh, ids[p]), /*init=*/false);
      std::memcpy(r, rows + (size_t)p * t->stride,
                  sizeof(float) * t->stride);
    }
  });
}

// admission-state export, same two-phase contract as pts_export.
// which=0: admitted ids. which=1: pre-admission sighting counters
// (ids_out + cnt_out). Null ids_out queries the count.
int64_t pts_entry_export(void* h, int which, int64_t* ids_out,
                         int64_t* cnt_out, int64_t cap) {
  Table* t = (Table*)h;
  int64_t n = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    for (auto& sl : s.slots) {
      if (!(sl.flags & kOccupied)) continue;
      bool want = which == 0 ? (sl.flags & kAdmitted) != 0
                             : !(sl.flags & kAdmitted) && sl.seen > 0;
      if (!want) continue;
      if (ids_out != nullptr) {
        if (n >= cap) return n;
        ids_out[n] = sl.id;
        if (cnt_out != nullptr) cnt_out[n] = (int64_t)sl.seen;
      }
      ++n;
    }
  }
  return n;
}

// restore admission state (after pts_clear + pts_import): admitted ids
// get the flag (their rows, if saved, already exist; otherwise the row
// materialises on next pull), seen ids get their counters back
void pts_entry_import(void* h, const int64_t* admitted, int64_t n_adm,
                      const int64_t* seen_ids, const int64_t* seen_cnt,
                      int64_t n_seen) {
  Table* t = (Table*)h;
  for (int64_t i = 0; i < n_adm; ++i) {
    Shard& s = t->shards[t->shard_of(admitted[i])];
    std::lock_guard<std::mutex> lk(s.mu);
    t->insert(s, admitted[i])->flags |= kAdmitted;
  }
  for (int64_t i = 0; i < n_seen; ++i) {
    Shard& s = t->shards[t->shard_of(seen_ids[i])];
    std::lock_guard<std::mutex> lk(s.mu);
    t->insert(s, seen_ids[i])->seen = (uint32_t)seen_cnt[i];
  }
}

// drop every row AND the admission state (used by load(): restore
// replaces, never merges)
void pts_clear(void* h) {
  Table* t = (Table*)h;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    s.slots.clear();
    s.used = 0;
    for (float* c : s.chunks) delete[] c;
    s.chunks.clear();
    s.rows_used = 0;
    s.free_rows.clear();
    // invalidate every spill record (restore replaces, never merges)
    for (uint64_t r = 0; r < s.spill_used; ++r) *t->spill_id(s, r) = -1;
    s.spill_used = 0;
    s.spilled = 0;
    s.spill_free.clear();
  }
}

// bulk load values (fresh optimizer state); bypasses admission — the
// caller restores entry state separately via pts_entry_import
void pts_import(void* h, const int64_t* ids, int64_t n, const float* vals) {
  Table* t = (Table*)h;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  for_each_shard_batch(t, ids, n, [&](int s, const std::vector<int64_t>& pos) {
    Shard& sh = t->shards[s];
    for (int64_t p : pos) {
      float* r = t->row_of(sh, t->insert(sh, ids[p]), /*init=*/false);
      std::memcpy(r, vals + (size_t)p * t->dim, sizeof(float) * t->dim);
      std::memset(r + t->dim, 0, sizeof(float) * (t->stride - t->dim));
    }
  });
}

// standalone dedup-free segment-sum: sums[seg_of[i]] += grads[i] for a
// caller-provided segment map (e.g. np.unique's inverse). Replaces the
// per-push jax.ops.segment_sum DISPATCH on the host-gradient path of
// the device cache (fleet/heter.py) — the sum itself was never the
// cost; the per-call XLA dispatch on a 1-core host was.
void ps_segsum_inv(const int64_t* seg_of, int64_t n, int dim,
                   const float* grads, float* sums) {
  for (int64_t i = 0; i < n; ++i) {
    float* a = sums + (size_t)seg_of[i] * dim;
    const float* g = grads + (size_t)i * dim;
    vec_add(a, g, dim);
  }
}

// ======================= tier, wire and geo entry points ============

// -- SIMD toggle --------------------------------------------------------

// 1 = AVX2 compiled in on this host, 0 = scalar-only build
int pts_simd_available(void) {
#if defined(__AVX2__)
  return 1;
#else
  return 0;
#endif
}

void pts_set_simd(int on) {
  g_simd.store(on ? 1 : 0, std::memory_order_relaxed);
}

// -- tiered spill storage ----------------------------------------------

// Create fresh per-shard spill files under ``dir`` (truncating any
// existing ones). Returns 0 on success, -1 on any open failure (the
// table stays RAM-only in that case).
int pts_enable_spill(void* h, const char* dir) {
  Table* t = (Table*)h;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  for (int i = 0; i < t->n_shards; ++i) {
    Shard& s = t->shards[i];
    std::lock_guard<std::mutex> lk(s.mu);
    if (s.spill_fd >= 0) return -1;  // already enabled
    char path[4096];
    std::snprintf(path, sizeof(path), "%s/shard_%04d.spill", dir, i);
    int fd = open(path, O_RDWR | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return -1;
    s.spill_fd = fd;
  }
  t->spill_on = true;
  return 0;
}

int pts_spill_enabled(void* h) { return ((Table*)h)->spill_on ? 1 : 0; }

// Demote-instead-of-evict sweep: every slot colder than ``cutoff``
// whose row is in the arena moves to the shard's spill file. Local
// placement only — no version tick, nothing to forward. Returns rows
// demoted, -1 if spill is not enabled.
int64_t pts_spill_sweep(void* h, uint64_t cutoff) {
  Table* t = (Table*)h;
  if (!t->spill_on) return -1;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  int64_t n = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    n += t->demote_shard(s, cutoff);
  }
  t->demoted_total.fetch_add((uint64_t)n, std::memory_order_relaxed);
  return n;
}

// Attach EXISTING spill files under ``dir`` (post-SIGKILL recovery) and
// re-seat every committed record (id >= 0) as a spilled slot: admitted
// (a demoted row was necessarily admitted), touched = current clock.
// Uncommitted records (payload written, id not yet stamped when the
// process died) are reclaimed as free. Returns rows recovered, -1 on
// failure or if spill is already enabled.
int64_t pts_spill_recover(void* h, const char* dir) {
  Table* t = (Table*)h;
  std::unique_lock<std::shared_mutex> pin(t->pin_mu);
  if (t->spill_on) return -1;
  int64_t recovered = 0;
  uint64_t now = t->clock.load(std::memory_order_relaxed);
  for (int i = 0; i < t->n_shards; ++i) {
    Shard& s = t->shards[i];
    std::lock_guard<std::mutex> lk(s.mu);
    char path[4096];
    std::snprintf(path, sizeof(path), "%s/shard_%04d.spill", dir, i);
    int fd = open(path, O_RDWR | O_CREAT, 0644);
    if (fd < 0) return -1;
    s.spill_fd = fd;
    struct stat st;
    if (fstat(fd, &st) != 0) return -1;
    uint64_t recs = (uint64_t)st.st_size / t->rec_bytes;
    if (recs == 0) continue;
    if (!t->spill_reserve(s, recs - 1)) return -1;
    s.spill_used = recs;
    for (uint64_t r = 0; r < recs; ++r) {
      int64_t id = *t->spill_id(s, r);
      if (id < 0) {
        s.spill_free.push_back((int64_t)r);
        continue;
      }
      Slot* sl = t->insert(s, id);
      if (sl->row >= 0 && !(sl->flags & kSpilled)) continue;  // hot wins
      sl->row = (int64_t)r;
      sl->flags |= kAdmitted | kSpilled;
      sl->touched = now;
      ++s.spilled;
      ++recovered;
    }
  }
  t->spill_on = true;
  return recovered;
}

// out[4] = {hot_rows, cold_rows, promoted_total, demoted_total}
void pts_spill_stats(void* h, uint64_t* out) {
  Table* t = (Table*)h;
  uint64_t hot = 0, cold = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    hot += s.rows_used - s.free_rows.size();
    cold += s.spilled;
  }
  out[0] = hot;
  out[1] = cold;
  out[2] = t->promoted_total.load(std::memory_order_relaxed);
  out[3] = t->demoted_total.load(std::memory_order_relaxed);
}

// Flush dirty spill pages (async) and drop them from this process's
// resident set — the kernel's page cache still holds the data, but the
// table's cold tier no longer counts against process RSS. This is what
// makes "rows beyond resident memory" an honest, measurable claim on
// the bench host.
void pts_spill_advise(void* h) {
  Table* t = (Table*)h;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    if (s.spill_map == nullptr || s.spill_cap == 0) continue;
    msync(s.spill_map, s.spill_cap, MS_SYNC);
    madvise(s.spill_map, s.spill_cap, MADV_DONTNEED);
  }
}

// -- zero-copy batched pull --------------------------------------------

// The service layer brackets resolve+sendmsg with pin_read/unpin_read:
// while any reader holds the shared pin, no mutator can move or
// rewrite row bytes (they take pin_mu exclusive), so the raw arena
// addresses handed out by pts_resolve stay valid AND the row bytes
// stay torn-free for the whole scatter-gather send. Both calls MUST
// come from the same thread (std::shared_mutex ownership rule).
void pts_pin_read(void* h) { ((Table*)h)->pin_mu.lock_shared(); }

void pts_unpin_read(void* h) { ((Table*)h)->pin_mu.unlock_shared(); }

// Resolve ``n`` PRE-DEDUPED ids to raw arena VALUE addresses (uint64;
// 0 = not admitted, caller substitutes a zeros row). Same admission
// semantics as pts_pull: one sighting per id, rows lazily materialise,
// spilled rows promote. Caller holds the read pin.
void pts_resolve(void* h, const int64_t* ids, int64_t n, uint64_t* addrs) {
  Table* t = (Table*)h;
  for_each_shard_batch(t, ids, n, [&](int s, const std::vector<int64_t>& pos) {
    Shard& sh = t->shards[s];
    for (int64_t p : pos) {
      float* r = t->admit_row(sh, ids[p], /*counting=*/true);
      addrs[p] = (uint64_t)(uintptr_t)r;
    }
  });
}

// One-call plan for the zero-copy pull wire: dedup the RAW id batch,
// resolve each unique id (same admission/promotion semantics as
// pts_resolve), sort the uniques by arena address (non-admitted 0s
// first), and hand back inv (input position -> rank in that sorted
// order) plus the sorted addresses. The service layer previously did
// np.unique + resolve + argsort + rank in python — at serving batch
// sizes those four passes cost more than the row gather they were
// meant to avoid; one native call makes the plan ~free. Caller holds
// the read pin and sizes both outputs to n (m <= n).
int64_t pts_pull_plan(void* h, const int64_t* ids, int64_t n,
                      int32_t* inv, uint64_t* addrs) {
  std::vector<int64_t> all((size_t)n);
  for (int64_t i = 0; i < n; ++i) all[(size_t)i] = i;
  std::vector<int32_t> u_of;
  std::vector<int64_t> uniq;
  dedup(ids, all, u_of, uniq);
  int64_t m = (int64_t)uniq.size();
  std::vector<uint64_t> uaddr((size_t)m);
  pts_resolve(h, uniq.data(), m, uaddr.data());
  std::vector<int32_t> order((size_t)m);
  for (int64_t i = 0; i < m; ++i) order[(size_t)i] = (int32_t)i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return uaddr[(size_t)a] < uaddr[(size_t)b];
  });
  std::vector<int32_t> rank((size_t)m);
  for (int64_t r = 0; r < m; ++r) {
    rank[(size_t)order[(size_t)r]] = (int32_t)r;
    addrs[r] = uaddr[(size_t)order[(size_t)r]];
  }
  for (int64_t i = 0; i < n; ++i) inv[i] = rank[(size_t)u_of[(size_t)i]];
  return m;
}

// Scatter-gather send of the zc pull reply: header + inv prefix, then
// the address-sorted rows — contiguous runs of rows (adjacent rows
// exactly row_bytes apart) ship as ONE iovec straight out of the
// arena, zero copies. Runs shorter than kCopyThresh bytes instead
// coalesce through a bounce buffer: a per-iovec skb setup on TCP
// costs ~0.5us while memcpy of a 256-byte row costs ~20ns, so for
// fragmented working sets copying the stragglers beats scattering
// them (a fully fragmented reply collapses to ~3 iovecs). Zeros rows
// (address 0, sorted first) materialise in the bounce buffer too.
// Loops sendmsg with IOV_MAX batching, EINTR retry, partial-send
// advance, and poll() on EAGAIN (server conns carry a socket timeout,
// so the fd is non-blocking) — byte-for-byte the frame a staged
// _send_msg would produce. Stateless w.r.t. the table; the caller's
// read pin keeps the addresses live across the send. Returns total
// bytes sent, or -errno (-EAGAIN = poll timeout).
int64_t pts_sendv_addrs(int fd, const uint64_t* addrs, int64_t m,
                        int64_t row_bytes, const void* hdr,
                        int64_t hdr_len, const void* inv,
                        int64_t inv_len, int64_t timeout_ms) {
  const int64_t kCopyThresh = 4096;
  thread_local std::vector<char> bounce;
  bounce.clear();
  bounce.reserve((size_t)(m * row_bytes));  // no realloc -> stable ptrs
  std::vector<struct iovec> iov;
  iov.reserve(34);
  if (hdr_len > 0) iov.push_back({(void*)hdr, (size_t)hdr_len});
  if (inv_len > 0) iov.push_back({(void*)inv, (size_t)inv_len});
  size_t bstart = (size_t)-1;  // open bounce segment's start offset
  auto flush = [&]() {
    if (bstart != (size_t)-1) {
      iov.push_back({bounce.data() + bstart, bounce.size() - bstart});
      bstart = (size_t)-1;
    }
  };
  int64_t i = 0;
  while (i < m) {
    if (addrs[i] == 0) {  // non-admitted id -> a zeros row
      if (bstart == (size_t)-1) bstart = bounce.size();
      bounce.resize(bounce.size() + (size_t)row_bytes, 0);
      ++i;
      continue;
    }
    int64_t j = i + 1;
    while (j < m && addrs[j] == addrs[j - 1] + (uint64_t)row_bytes) ++j;
    int64_t run = (j - i) * row_bytes;
    if (run < kCopyThresh) {
      if (bstart == (size_t)-1) bstart = bounce.size();
      size_t off = bounce.size();
      bounce.resize(off + (size_t)run);
      std::memcpy(bounce.data() + off, (void*)(uintptr_t)addrs[i],
                  (size_t)run);
    } else {
      flush();
      iov.push_back({(void*)(uintptr_t)addrs[i], (size_t)run});
    }
    i = j;
  }
  flush();
  long iovmax = sysconf(_SC_IOV_MAX);
  if (iovmax <= 0 || iovmax > 1024) iovmax = 1024;
  size_t k = 0;
  int64_t total = 0;
  while (k < iov.size()) {
    struct msghdr mh;
    std::memset(&mh, 0, sizeof(mh));
    mh.msg_iov = &iov[k];
    mh.msg_iovlen = std::min((size_t)iovmax, iov.size() - k);
    ssize_t sent = sendmsg(fd, &mh, MSG_NOSIGNAL);
    if (sent < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        struct pollfd pf{fd, POLLOUT, 0};
        int pr = poll(&pf, 1, timeout_ms < 0 ? -1 : (int)timeout_ms);
        if (pr > 0) continue;
        return -(int64_t)(pr == 0 ? EAGAIN : errno);
      }
      return -(int64_t)errno;
    }
    total += sent;
    size_t s = (size_t)sent;
    while (k < iov.size() && s >= iov[k].iov_len) {
      s -= iov[k].iov_len;
      ++k;
    }
    if (s > 0) {
      iov[k].iov_base = (char*)iov[k].iov_base + s;
      iov[k].iov_len -= s;
    }
  }
  return total;
}

// -- int8 wire rows -----------------------------------------------------

// Pull with per-row symmetric int8 quantization for the wire:
// scale[i] = max|row|/127 (float32 ops, bit-exact with the numpy
// reference np.abs(row).max()/np.float32(127)); codes = clip(
// nearbyintf(row/scale), -127, 127) — nearbyintf ties-to-even matches
// np.rint. All-zero (and non-admitted) rows ship scale 0, codes 0.
// Same admission/sighting semantics as pts_pull.
void pts_pull_q8(void* h, const int64_t* ids, int64_t n, int8_t* codes,
                 float* scales) {
  Table* t = (Table*)h;
  int dim = t->dim;
  for_each_shard_batch(t, ids, n, [&](int s, const std::vector<int64_t>& pos) {
    Shard& sh = t->shards[s];
    std::vector<int32_t> u_of;
    std::vector<int64_t> uniq;
    dedup(ids, pos, u_of, uniq);
    std::vector<int8_t> ucodes(uniq.size() * (size_t)dim, 0);
    std::vector<float> uscale(uniq.size(), 0.0f);
    for (size_t u = 0; u < uniq.size(); ++u) {
      float* r = t->admit_row(sh, uniq[u], /*counting=*/true);
      if (r == nullptr) continue;
      float amax = 0.0f;
      for (int j = 0; j < dim; ++j) {
        float a = std::fabs(r[j]);
        if (a > amax) amax = a;
      }
      if (amax == 0.0f) continue;
      float scale = amax / 127.0f;
      uscale[u] = scale;
      int8_t* c = ucodes.data() + u * (size_t)dim;
      for (int j = 0; j < dim; ++j) {
        float q = nearbyintf(r[j] / scale);
        if (q > 127.0f) q = 127.0f;
        if (q < -127.0f) q = -127.0f;
        c[j] = (int8_t)q;
      }
    }
    for (size_t p = 0; p < pos.size(); ++p) {
      std::memcpy(codes + (size_t)pos[p] * dim,
                  ucodes.data() + (size_t)u_of[p] * dim, (size_t)dim);
      scales[pos[p]] = uscale[u_of[p]];
    }
  });
}

// -- geo LWW stamp directory -------------------------------------------

// Read stamps: seqs_out[i]/sites_out[i] = the id's (lamport seq,
// interned site idx), or (-1, -1) when unstamped — the Python dict's
// .get(k, (-1, "")) default. Never creates slots.
void pts_geo_get(void* h, const int64_t* ids, int64_t n, int64_t* seqs_out,
                 int32_t* sites_out) {
  Table* t = (Table*)h;
  for (int64_t i = 0; i < n; ++i) {
    Shard& s = t->shards[t->shard_of(ids[i])];
    std::lock_guard<std::mutex> lk(s.mu);
    Slot* sl = t->find(s, ids[i]);
    seqs_out[i] = sl != nullptr ? sl->gseq : -1;
    sites_out[i] = sl != nullptr ? sl->gsite : -1;
  }
}

// Commit stamps (winners only — the LWW comparison happens in Python,
// where the site-intern table lives and string tiebreak order is
// preserved). Creates the slot when missing: stamps can precede rows.
void pts_geo_put(void* h, const int64_t* ids, int64_t n,
                 const int64_t* seqs, const int32_t* sites) {
  Table* t = (Table*)h;
  for (int64_t i = 0; i < n; ++i) {
    Shard& s = t->shards[t->shard_of(ids[i])];
    std::lock_guard<std::mutex> lk(s.mu);
    Slot* sl = t->insert(s, ids[i]);
    sl->gseq = seqs[i];
    sl->gsite = sites[i];
  }
}

// Two-phase stamped-slot export (replica attach handshake): null
// ids_out queries the count; otherwise fills ids/seqs/sites up to cap.
int64_t pts_geo_export(void* h, int64_t* ids_out, int64_t* seqs_out,
                       int32_t* sites_out, int64_t cap) {
  Table* t = (Table*)h;
  int64_t n = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> lk(s.mu);
    for (auto& sl : s.slots) {
      if (!(sl.flags & kOccupied) || sl.gseq < 0) continue;
      if (ids_out != nullptr) {
        if (n >= cap) return n;
        ids_out[n] = sl.id;
        seqs_out[n] = sl.gseq;
        sites_out[n] = sl.gsite;
      }
      ++n;
    }
  }
  return n;
}

}  // extern "C"

// cache_dir.cc — native directory for the device embedding cache.
//
// The TPU analog of the reference's GPU-side hashtable
// (paddle/fluid/framework/fleet/heter_ps/hashtable.h): the cache VALUES
// live in device HBM (fleet/heter.py DeviceCachedTable._buf), but the
// DIRECTORY — id -> slot map, LRU order, free list, pin counts,
// admission/eviction planning — was pure Python and profiled as the
// residual cost of the wide&deep PS step (~27k unique-id dict/LRU
// operations per batch on the 1-core host; PERF.md).  One C call now
// performs the whole directory transaction.
//
// Plain C ABI over ctypes (no pybind11 in this image).  Thread safety
// is the caller's job (DeviceCachedTable serializes under its RLock).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct CacheDir {
  int64_t cap;
  std::unordered_map<int64_t, int64_t> slot_of;  // id -> slot
  std::vector<int64_t> id_of;                    // slot -> id (-1 free)
  std::vector<int64_t> pin;                      // slot -> pin count
  // intrusive doubly-linked LRU over slots; head = coldest
  std::vector<int64_t> prev_, next_;
  int64_t head = -1, tail = -1;
  std::vector<int64_t> free_slots;               // stack
  int64_t hits = 0, misses = 0, evictions = 0;

  explicit CacheDir(int64_t capacity)
      : cap(capacity), id_of(capacity, -1), pin(capacity, 0),
        prev_(capacity, -1), next_(capacity, -1) {
    slot_of.reserve(2 * capacity);
    free_slots.reserve(capacity);
    for (int64_t s = capacity - 1; s >= 0; --s) free_slots.push_back(s);
  }

  void lru_unlink(int64_t s) {
    if (prev_[s] >= 0) next_[prev_[s]] = next_[s]; else head = next_[s];
    if (next_[s] >= 0) prev_[next_[s]] = prev_[s]; else tail = prev_[s];
    prev_[s] = next_[s] = -1;
  }

  void lru_push_back(int64_t s) {  // most-recently-used end
    prev_[s] = tail;
    next_[s] = -1;
    if (tail >= 0) next_[tail] = s; else head = s;
    tail = s;
  }
};

// np.unique(ids, return_inverse=True) without hashing: one argsort of
// (id, index) pairs + a linear walk.
void unique_inverse(const int64_t* ids, int64_t n, int64_t* uniq,
                    int64_t* inverse) {
  static thread_local std::vector<std::pair<int64_t, int64_t>> buf;
  buf.resize(n);
  for (int64_t i = 0; i < n; ++i) buf[i] = {ids[i], i};
  std::sort(buf.begin(), buf.end());
  int64_t u = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || buf[i].first != buf[i - 1].first) uniq[++u] = buf[i].first;
    inverse[buf[i].second] = u;
  }
}

}  // namespace

extern "C" {

void* cache_dir_create(int64_t capacity) {
  return new CacheDir(capacity);
}

void cache_dir_destroy(void* h) { delete static_cast<CacheDir*>(h); }

void cache_dir_stats(void* h, int64_t* out3) {
  auto* d = static_cast<CacheDir*>(h);
  out3[0] = d->hits;
  out3[1] = d->misses;
  out3[2] = d->evictions;
}

void cache_dir_reset_stats(void* h) {
  auto* d = static_cast<CacheDir*>(h);
  d->hits = d->misses = d->evictions = 0;
}

int64_t cache_dir_load(void* h) {
  auto* d = static_cast<CacheDir*>(h);
  return d->cap - static_cast<int64_t>(d->free_slots.size());
}

// Full pull transaction over ids[n] (duplicates allowed):
//   uniq[<=n], inverse[n] (ids == uniq[inverse]), slots[<=n] per uniq
//   miss_pos: positions into uniq that were admitted this call
//   evict_slots/evict_ids: rows the caller must WRITE BACK before
//     installing new values (their directory entries are already gone)
//   pin != 0: each uniq slot's pin count += 1 (async in-flight batch)
// Out counts: {n_uniq, n_miss, n_evict}.  Returns 0, or -1 when the
// working set cannot fit (capacity thrash) — directory unchanged.
int64_t cache_dir_pull(void* h, const int64_t* ids, int64_t n,
                       int32_t pin, int64_t* uniq, int64_t* inverse,
                       int64_t* slots, int64_t* miss_pos,
                       int64_t* evict_slots, int64_t* evict_ids,
                       int64_t* counts) {
  auto* d = static_cast<CacheDir*>(h);
  unique_inverse(ids, n, uniq, inverse);
  int64_t u = 0;
  for (int64_t i = 0; i < n; ++i) u = std::max(u, inverse[i] + 1);

  // PHASE 1 — pure lookup (no mutation yet: a thrash bail-out below
  // must leave the directory byte-identical)
  int64_t n_miss = 0;
  for (int64_t j = 0; j < u; ++j) {
    auto it = d->slot_of.find(uniq[j]);
    if (it == d->slot_of.end()) {
      miss_pos[n_miss++] = j;
      slots[j] = -1;
    } else {
      slots[j] = it->second;
    }
  }
  counts[0] = u;
  counts[1] = n_miss;
  counts[2] = 0;

  // eviction plan (still no mutation)
  int64_t n_evict = 0;
  if (n_miss > static_cast<int64_t>(d->free_slots.size())) {
    int64_t need = n_miss - static_cast<int64_t>(d->free_slots.size());
    // the current batch's hit slots are untouchable this call
    std::vector<char> in_batch(d->cap, 0);
    for (int64_t j = 0; j < u; ++j)
      if (slots[j] >= 0) in_batch[slots[j]] = 1;
    for (int64_t s = d->head; s >= 0 && n_evict < need; s = d->next_[s]) {
      if (!in_batch[s] && d->pin[s] == 0) evict_slots[n_evict++] = s;
    }
    if (n_evict < need) return -1;  // thrash: directory unchanged
                                    // (counts still report u/n_miss so
                                    // the caller can account the batch)
  }

  // PHASE 2 — commit: LRU bumps for hits, evictions, admissions
  for (int64_t j = 0; j < u; ++j) {
    if (slots[j] >= 0) {
      d->lru_unlink(slots[j]);
      d->lru_push_back(slots[j]);
      ++d->hits;
    }
  }
  for (int64_t e = 0; e < n_evict; ++e) {
    int64_t s = evict_slots[e];
    evict_ids[e] = d->id_of[s];
    d->lru_unlink(s);
    d->slot_of.erase(d->id_of[s]);
    d->id_of[s] = -1;
    d->free_slots.push_back(s);
    ++d->evictions;
  }

  // admit misses
  d->misses += n_miss;
  for (int64_t m = 0; m < n_miss; ++m) {
    int64_t j = miss_pos[m];
    int64_t s = d->free_slots.back();
    d->free_slots.pop_back();
    slots[j] = s;
    d->id_of[s] = uniq[j];
    d->slot_of.emplace(uniq[j], s);
    d->lru_push_back(s);
  }

  if (pin)
    for (int64_t j = 0; j < u; ++j) ++d->pin[slots[j]];

  counts[0] = u;
  counts[1] = n_miss;
  counts[2] = n_evict;
  return 0;
}

// Lookup-only transaction for push: ids[n] -> uniq/inverse/slots; every
// id must be resident (returns -1 listing nothing otherwise).  unpin !=
// 0 decrements each uniq slot's pin count (the matching pull's pin).
int64_t cache_dir_lookup(void* h, const int64_t* ids, int64_t n,
                         int32_t unpin, int64_t* uniq, int64_t* inverse,
                         int64_t* slots, int64_t* counts) {
  auto* d = static_cast<CacheDir*>(h);
  unique_inverse(ids, n, uniq, inverse);
  int64_t u = 0;
  for (int64_t i = 0; i < n; ++i) u = std::max(u, inverse[i] + 1);
  for (int64_t j = 0; j < u; ++j) {
    auto it = d->slot_of.find(uniq[j]);
    if (it == d->slot_of.end()) return -1;
    slots[j] = it->second;
  }
  if (unpin)
    for (int64_t j = 0; j < u; ++j)
      if (d->pin[slots[j]] > 0) --d->pin[slots[j]];
  counts[0] = u;
  return 0;
}

// Decrement pin counts for explicit slots (push fast path: the caller
// reuses the matching pull's plan instead of re-deriving it).
void cache_dir_unpin_slots(void* h, const int64_t* slots, int64_t n) {
  auto* d = static_cast<CacheDir*>(h);
  for (int64_t i = 0; i < n; ++i)
    if (d->pin[slots[i]] > 0) --d->pin[slots[i]];
}

// Tolerant unpin over raw ids (duplicates allowed): non-resident ids
// are SKIPPED, resident ids' slots get one pin decrement each.  Used by
// the public release() path, where a partial eviction may already have
// dropped some of the batch's rows — the all-or-nothing lookup would
// leak the surviving rows' pins forever.
void cache_dir_unpin_ids(void* h, const int64_t* ids, int64_t n) {
  auto* d = static_cast<CacheDir*>(h);
  static thread_local std::vector<int64_t> uniq_buf, inv_buf;
  uniq_buf.resize(n);
  inv_buf.resize(n);
  unique_inverse(ids, n, uniq_buf.data(), inv_buf.data());
  int64_t u = 0;
  for (int64_t i = 0; i < n; ++i) u = std::max(u, inv_buf[i] + 1);
  for (int64_t j = 0; j < u; ++j) {
    auto it = d->slot_of.find(uniq_buf[j]);
    if (it != d->slot_of.end() && d->pin[it->second] > 0)
      --d->pin[it->second];
  }
}

// Slot ids for write-back bookkeeping (flush path).
void cache_dir_ids_of(void* h, const int64_t* slots, int64_t n,
                      int64_t* out_ids) {
  auto* d = static_cast<CacheDir*>(h);
  for (int64_t i = 0; i < n; ++i) out_ids[i] = d->id_of[slots[i]];
}

}  // extern "C"

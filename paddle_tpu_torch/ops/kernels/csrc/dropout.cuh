// The flash kernels' attention-dropout keep mask, shared by
// flash_attention_fwd.cu (kernel 1) and flash_attention_bwd.cu (kernels 2
// and 3), so that the backward regenerates exactly the forward's mask.
//
// Replaces the mask of paddle_tpu/ops/pallas/flash_attention.py:53
// `_keep_mask`, which seeds the TPU's on-chip generator with (seed, b, h,
// q block, k block) and keeps a score iff its 32 random bits are
// >= floor(p * 2^32).  The keep rule is the same here; the bits are
// Philox4x32-10 (Random123's counter-based generator) and depend on the
// element, not on a tile: the port's routes tile 32, 64 or 128 rows and
// the backward tiles differently from the forward, so the bits of score
// (q, k) of head h in batch b are a pure function of
//   key     = (seed & 0xffffffff, seed >> 32)     (the int64 seed)
//   counter = (k >> 1, q >> 1, h, b)
//   word    = 2 * (q & 1) + (k & 1)  of the four the counter gives.
// One Philox call thus covers a 2 x 2 group of scores.  The kernels hold
// the two halves of a group in two lanes (rows g and g + 1 of an mma
// fragment, or lanes l and l + 1 of an FMA warp): each lane computes one
// group and the pair swaps the half the other needs (`keep_pair`), so
// every word is used once.  The plain version is `dropout_keep_mask` in
// flash_attention.py (int64 PyTorch); the debug entry below computes the
// mask one element a thread from the definition, and chip_smoke.py holds
// it bitwise against the plain version.
//
// Everything sits in the including file's anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Philox4x32 with 10 rounds (Random123's philox4x32_10)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the dropout options as the kernels take them: the seed in device memory
// (an int64 drawn on the card, so no host sync), the keep threshold
// floor(p * 2^32) and 1 - p as f32 (kept values are divided by it, as
// the reference divides)
struct Dropout {
  const long long* seed;   // null: no dropout
  uint32_t thresh;
  float keep_p;            // f32(1 - p)
};

struct PhiloxKey {
  uint32_t k0, k1;
};

__device__ __forceinline__ PhiloxKey philox_key(const long long* seed) {
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  return PhiloxKey{static_cast<uint32_t>(s),
                   static_cast<uint32_t>(s >> 32)};
}

// the four words of the group holding score (q, k)
__device__ __forceinline__ uint4 keep_group(PhiloxKey key, int b, int h,
                                            int q, int k) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(k) >> 1, static_cast<uint32_t>(q) >> 1,
                 static_cast<uint32_t>(h), static_cast<uint32_t>(b)),
      key.k0, key.k1);
}

// The bits of two 2 x 2 groups shared by a pair of lanes.  The two lanes
// hold the same two groups, one lane the even and the other the odd half
// of each along one index: the query (`split_q`: lanes of rows g and g + 1
// of an mma fragment whose rows are queries, or of an FMA warp whose lanes
// are queries) or the key.  Each lane computes one of the groups (`mine`:
// the lower lane, whose index is even, the first; its partner the
// second), keeps its own half and sends the other across (`partner`: lane
// ^ 4 in an mma fragment, ^ 1 in an FMA warp).  Returns this lane's half
// of `mine` ({x, y}) and of the partner's group ({z, w}), each in the
// order of the other index (even, odd); all 32 lanes must call it.
__device__ __forceinline__ uint4 keep_pair(uint4 mine, bool lower,
                                           bool split_q, int partner) {
  uint32_t own0, own1, send0, send1;
  if (split_q) {
    own0 = lower ? mine.x : mine.z;
    own1 = lower ? mine.y : mine.w;
    send0 = lower ? mine.z : mine.x;
    send1 = lower ? mine.w : mine.y;
  } else {
    own0 = lower ? mine.x : mine.y;
    own1 = lower ? mine.z : mine.w;
    send0 = lower ? mine.y : mine.x;
    send1 = lower ? mine.w : mine.z;
  }
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, send0, partner);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, send1, partner);
  return make_uint4(own0, own1, got0, got1);
}

// The keep bits of a thread's 4 kNT fragment elements (bit 4j + e for
// element e of n-tile j): rows row_a and row_a + 8 (queries if `rows_q`,
// else keys), columns c0 + 8j + 2t and + 1 (keys, else queries)
template <int kNT = 8>
__device__ __forceinline__ uint32_t keep_bits_mma(PhiloxKey key, int b, int h,
                                                  int row_a, int c0, int g,
                                                  int t, bool rows_q,
                                                  uint32_t thresh) {
  static_assert(kNT <= 8, "32 bits");
  const bool lower = (g & 1) == 0;
  const int row = lower ? row_a : row_a + 8;
  uint32_t keep = 0;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = c0 + j * 8 + 2 * t;
    const uint4 r = keep_pair(rows_q ? keep_group(key, b, h, row, c)
                                     : keep_group(key, b, h, c, row),
                              lower, rows_q, 4);
    const uint32_t w[4] = {lower ? r.x : r.z, lower ? r.y : r.w,
                           lower ? r.z : r.x, lower ? r.w : r.y};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      keep |= (w[e] >= thresh ? 1u : 0u) << (4 * j + e);
  }
  return keep;
}

// The keep bits of a 2 x 2 group from its Philox words: bit 0 (q even,
// k even), 1 (q even, k odd), 2 (q odd, k even), 3 (q odd, k odd)
__device__ __forceinline__ uint32_t keep_nibble(uint4 r, uint32_t thresh) {
  return (r.x >= thresh ? 1u : 0u) | (r.y >= thresh ? 2u : 0u)
         | (r.z >= thresh ? 4u : 0u) | (r.w >= thresh ? 8u : 0u);
}

// The groups a lane computes for the 32 elements of an mma / wgmma
// fragment (rows row_a, row_a + 8, columns c0 + 8j + 2t and + 1, as
// keep_bits_mma), one a column pair: nibble j is the group of n-tile j
// at the lower lane's row row_a (rows row_a, row_a + 1) or at the upper
// lane's row row_a + 8 (rows row_a + 7, row_a + 8).  Rows are queries if
// `rows_q`, else keys.  The Hopper backward route keeps this word (dK/dV
// writes it for dQ); keep_bits_of_groups turns it into the lane's bits.
__device__ __forceinline__ uint32_t keep_groups_mma(PhiloxKey key, int b,
                                                    int h, int row_a, int c0,
                                                    int g, int t, bool rows_q,
                                                    uint32_t thresh) {
  const int row = (g & 1) == 0 ? row_a : row_a + 8;
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + j * 8 + 2 * t;
    w |= keep_nibble(rows_q ? keep_group(key, b, h, row, c)
                            : keep_group(key, b, h, c, row), thresh)
         << (4 * j);
  }
  return w;
}

// A lane's keep bits (bit 4j + e for element e of n-tile j, as
// keep_bits_mma gives them) from its group word and its partner's (lane
// ^ 4, one shuffle): with rows of queries the lower lane holds the q-even
// halves (bits 0, 1) of its group (row g) and of the partner's (row
// g + 8), the upper lane the q-odd halves (bits 2, 3) of the partner's
// (row g) and of its own (row g + 8); with rows of keys the k-even halves
// (bits 0, 2) and the k-odd halves (bits 1, 3) alike.  All 32 lanes must
// call it.
__device__ __forceinline__ uint32_t keep_bits_of_groups(uint32_t mine, int g,
                                                        bool rows_q) {
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 4);
  const bool lower = (g & 1) == 0;
  if (rows_q)
    return lower ? (mine & 0x33333333u) | ((other & 0x33333333u) << 2)
                 : ((other >> 2) & 0x33333333u) | (mine & 0xCCCCCCCCu);
  return lower ? (mine & 0x11111111u) | ((mine >> 1) & 0x22222222u)
                     | ((other << 2) & 0x44444444u)
                     | ((other << 1) & 0x88888888u)
               : ((other >> 1) & 0x11111111u) | ((other >> 2) & 0x22222222u)
                     | ((mine << 1) & 0x44444444u) | (mine & 0x88888888u);
}

// The keep bits of an FMA warp's 8 rows r0 + i (even r0) at its lane's
// column c (lane-parity = c-parity): rows are queries if `rows_q` (keys,
// lanes queries, otherwise); bit i for row r0 + i
__device__ __forceinline__ uint32_t keep_bits_fma(PhiloxKey key, int b, int h,
                                                  int r0, int c, int lane,
                                                  bool rows_q,
                                                  uint32_t thresh) {
  const bool lower = (lane & 1) == 0;
  uint32_t keep = 0;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int mine = 4 * m + (lower ? 0 : 2);
    const int other = 4 * m + (lower ? 2 : 0);
    const uint4 r = keep_pair(rows_q ? keep_group(key, b, h, r0 + mine, c)
                                     : keep_group(key, b, h, c, r0 + mine),
                              lower, !rows_q, 1);
    keep |= (r.x >= thresh ? 1u : 0u) << mine;
    keep |= (r.y >= thresh ? 1u : 0u) << (mine + 1);
    keep |= (r.z >= thresh ? 1u : 0u) << other;
    keep |= (r.w >= thresh ? 1u : 0u) << (other + 1);
  }
  return keep;
}

// the definition, one element a thread: keep[b, h, i, j] for queries
// q0 + i and keys k0 + j (the debug entry's kernel)
__global__ void dropout_keep_mask_kernel(const long long* seed, int B, int H,
                                         int Sq, int Sk, int q0, int k0,
                                         uint32_t thresh, uint8_t* out) {
  const long long n = static_cast<long long>(B) * H * Sq * Sk;
  const PhiloxKey key = philox_key(seed);
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = static_cast<int>(e % Sk);
    const int i = static_cast<int>((e / Sk) % Sq);
    const int h = static_cast<int>((e / ((long long)Sk * Sq)) % H);
    const int b = static_cast<int>(e / ((long long)Sk * Sq * H));
    const int q = q0 + i, k = k0 + j;
    const uint4 r = keep_group(key, b, h, q, k);
    const int w = 2 * (q & 1) + (k & 1);
    const uint32_t bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
    out[e] = bits >= thresh ? 1 : 0;
  }
}

}  // namespace

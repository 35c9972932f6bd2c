// The decode of one candidate, shared by the candidate kernel
// (candidate.cu) and the block-decode kernel (block_decode.cu), so that the
// two cannot drift apart: the 8-word gather of the packed compares, the
// funnel shift and even bits, the CRC-24 from the single-bit syndromes,
// the single-bit repair in the 88 data bits, and the extended mode's DF,
// short AP residual and classes.
//
// Per candidate at offset o, data bit t is compare o + 16 + 2t, so the
// frame spans 8 consecutive words from word0 = (o + 16) / 32. A funnel
// shift aligns the window; the even bits of each aligned word are the 16
// frame bits, MSB first. The CRC is the XOR of the syndromes of the set
// data bits (CRC-24 is linear over GF(2)); a nonzero delta equal to the
// syndrome of data bit j (j < 88; syndromes are pairwise distinct, so the
// match is unique) flips bit j. A flip in the CRC field never validates.
// The recover2 repair (repair2) then looks a delta that matched no single
// syndrome up among the 3828 pair syndromes S_i ^ S_j (i < j < 88): unique,
// disjoint from the single ones and never 0 (airjax/protocol/crc.py:
// 138-156), so any lookup that finds the key finds airjax's argmax. The
// table (kernels/block_decode.py::pair_hash_table) is a two-choice bucketed
// hash in device memory: kPairBuckets buckets of 4 entries {syndrome,
// i | j << 8}, 32 B each (one sector), 32 KB in all at load 0.93; an empty
// entry has the key 0. Each syndrome d sits in bucket h1(d) = (d * kHashM1
// mod 2^32) >> kHashShift or h2(d) (kHashM2), placed by cuckoo displacement
// on the host. The lookup issues the four 16-byte __ldg loads of both
// buckets together and then compares 8 keys: one round trip to L1/L2,
// where a binary search over the sorted table took 12 dependent ones.
//
// c_syndromes is __constant__ in an anonymous namespace: every translation
// unit that includes this header has its own copy, which its own
// load_syndromes() fills. airjax_load_syndromes (candidate.cu) loads them
// all; a copy that is never loaded reads zeros.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDataBits = 88;
constexpr int kFrameBytes = 14;

__constant__ uint32_t c_syndromes[kDataBits];

// Copies the 88 syndromes (uint32, host memory) into this translation
// unit's c_syndromes on the current device.
inline int load_syndromes(const void* host) {
  cudaMemcpyToSymbol(c_syndromes, host, sizeof(c_syndromes));
  return static_cast<int>(cudaGetLastError());
}

// MSB-first bit positions 0, 2, ..., 30 of x -> a 16-bit value with
// position 0 in bit 15.
__device__ __forceinline__ uint32_t even_bits(uint32_t x) {
  x = (x >> 1) & 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  x = (x | (x >> 8)) & 0x0000FFFFu;
  return x;
}

// One candidate as sliced; `flip` is set by repair().
struct Candidate {
  uint32_t h[7];   // h[q] = frame bits 16q .. 16q+15, MSB first (two frame bytes)
  uint32_t delta;  // crc24(data bits) ^ CRC field: 0 when valid as sent; the long AP residual
  int flip;        // the data bit whose syndrome is delta (the repair), -1 if none
  int pair;        // i | j << 8 of the 2-bit repair (repair2), -1 if none
};

__device__ __forceinline__ bool crc_ok(const Candidate& c) { return c.delta == 0 || c.flip >= 0 || c.pair >= 0; }
__device__ __forceinline__ int frame_df(const Candidate& c) { return static_cast<int>(c.h[0] >> 11); }

// The candidate at `offset`: the 8-word gather with its index clamped to
// the array, as airjax's gather does (in-range offsets reach at most into
// the 8 zero pad words that pack_cmp_words appends), and the CRC.
__device__ __forceinline__ Candidate slice_candidate(const uint32_t* __restrict__ words, long long n_words,
                                                      long long offset) {
  const long long d0 = offset + 16;
  const long long word0 = d0 >> 5;
  const unsigned align = static_cast<unsigned>(d0 & 31);
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    long long idx = word0 + j;
    idx = idx < 0 ? 0 : (idx >= n_words ? n_words - 1 : idx);
    w[j] = __ldg(words + idx);
  }
  Candidate c;
#pragma unroll
  for (int q = 0; q < 7; ++q) c.h[q] = even_bits(__funnelshift_l(w[q + 1], w[q], align));

  uint32_t calced = 0;
#pragma unroll
  for (int i = 0; i < kDataBits; ++i) {
    if ((c.h[i >> 4] >> (15 - (i & 15))) & 1u) calced ^= c_syndromes[i];
  }
  c.delta = calced ^ (((c.h[5] & 0xFFu) << 16) | c.h[6]);
  c.flip = -1;
  c.pair = -1;
  return c;
}

// The single-bit repair: the data bit whose syndrome is delta. The kernels
// store what needs no repair first: in the extended mode, the search before
// the raw fields' stores took more device time (PERF.md, PR 4).
__device__ __forceinline__ void repair(Candidate& c) {
  if (c.delta != 0) {
    for (int j = 0; j < kDataBits; ++j) {
      if (c_syndromes[j] == c.delta) c.flip = j;
    }
  }
}

// The pair table's hash (kernels/block_decode.py mirrors these): bucket
// h(d) = (d * m mod 2^32) >> kHashShift, m = kHashM1 or kHashM2.
constexpr int kPairBuckets = 1024;
constexpr unsigned kHashShift = 22;  // 32 - log2(kPairBuckets)
constexpr uint32_t kHashM1 = 0x9E3779B1u;
constexpr uint32_t kHashM2 = 0x85EBCA77u;
static_assert(kPairBuckets == 1 << (32 - kHashShift), "one bucket per hash value");

// The recover2 repair: the single-bit repair, then, if delta is nonzero and
// matched no single syndrome, the pair whose syndrome it is, or -1. `pairs`
// is the hashed table: bucket b is pairs[2b], pairs[2b + 1], each two
// entries {key, i | j << 8}. The lookup is a call, not inlined: inlined at
// the block-decode kernel's 128 registers a pair search spilled 48-68
// bytes, as a call nothing (PERF.md).
__device__ __noinline__ int pair_of(uint32_t delta, const uint4* __restrict__ pairs) {
  const uint4* b1 = pairs + 2 * ((delta * kHashM1) >> kHashShift);
  const uint4* b2 = pairs + 2 * ((delta * kHashM2) >> kHashShift);
  const uint4 e0 = __ldg(b1), e1 = __ldg(b1 + 1), e2 = __ldg(b2), e3 = __ldg(b2 + 1);
  int ij = -1;  // keys are unique and delta != 0, so at most one matches
  ij = e0.x == delta ? static_cast<int>(e0.y) : ij;
  ij = e0.z == delta ? static_cast<int>(e0.w) : ij;
  ij = e1.x == delta ? static_cast<int>(e1.y) : ij;
  ij = e1.z == delta ? static_cast<int>(e1.w) : ij;
  ij = e2.x == delta ? static_cast<int>(e2.y) : ij;
  ij = e2.z == delta ? static_cast<int>(e2.w) : ij;
  ij = e3.x == delta ? static_cast<int>(e3.y) : ij;
  ij = e3.z == delta ? static_cast<int>(e3.w) : ij;
  return ij;
}

__device__ __forceinline__ void repair2(Candidate& c, const uint4* __restrict__ pairs) {
  repair(c);
  if (c.delta != 0 && c.flip < 0) c.pair = pair_of(c.delta, pairs);
}

// The short AP residual: the CRC of data bits 0-31 ^ PI = bits 32-55. The
// short CRC needs the syndromes of a 32-bit message; bit j of it has the
// syndrome of bit j + 56 of the 88-bit message (both x^(55-j) mod G), so it
// reads the same table.
__device__ __forceinline__ uint32_t short_residual(const Candidate& c) {
  uint32_t crc = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if ((c.h[i >> 4] >> (15 - (i & 15))) & 1u) crc ^= c_syndromes[56 + i];
  }
  return crc ^ ((c.h[2] << 8) | (c.h[3] >> 8));
}

__device__ __forceinline__ uint32_t bit_mask(int bit, int q) {
  return (bit >> 4) == q ? 1u << (15 - (bit & 15)) : 0u;
}

// Frame bits 16q .. 16q+15 with data bit `flip` flipped (none if flip < 0)
// and the two bits of `pair` (none if pair < 0).
__device__ __forceinline__ uint32_t repaired_word(const uint32_t* h, int q, int flip, int pair) {
  uint32_t x = flip >= 0 && (flip >> 4) == q ? h[q] ^ (1u << (15 - (flip & 15))) : h[q];
  if (pair >= 0) x ^= bit_mask(pair & 0xFF, q) ^ bit_mask(pair >> 8, q);
  return x;
}

// The 14 frame bytes, repaired as repaired_word.
__device__ __forceinline__ void store_frame(uint8_t* f, const uint32_t* h, int flip, int pair = -1) {
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    const uint32_t x = repaired_word(h, q, flip, pair);
    f[2 * q] = static_cast<uint8_t>(x >> 8);
    f[2 * q + 1] = static_cast<uint8_t>(x & 0xFFu);
  }
}

// The extended mode's candidate classes (airjax/pipeline.py:216-250), in
// rows of `stride` flags in this order.
enum Class { kGoodLong, kRecovered, kGoodDf11, kCandDf11Ic, kCandShortAp, kCandLongAp, kClasses };

__device__ __forceinline__ void store_classes(bool* classes, long long stride, long long k, const Candidate& c,
                                              int df, uint32_t icao_short, bool valid) {
  // AP-addressed long frames: DF16 ACAS, DF20/21 Comm-B, DF24+ Comm-D ELM.
  const bool is_long_ap = df == 16 || df == 20 || df == 21 || df >= 24;
  const bool good_long = crc_ok(c) && df >= 16 && valid && !is_long_ap;
  classes[kGoodLong * stride + k] = good_long;
  classes[kRecovered * stride + k] = c.flip >= 0 && good_long;
  classes[kGoodDf11 * stride + k] = df == 11 && icao_short == 0 && valid;
  classes[kCandDf11Ic * stride + k] = df == 11 && valid && icao_short != 0 && icao_short < 80;
  classes[kCandShortAp * stride + k] = (df == 0 || df == 4 || df == 5) && valid && icao_short != 0;
  classes[kCandLongAp * stride + k] = is_long_ap && valid && c.delta != 0;
}

}  // namespace

// Load block_decode.cu's and fields.cu's copies of the syndromes (defined
// there); airjax_load_syndromes calls them after loading candidate.cu's.
int load_block_decode_syndromes(const void* host);
int load_fields_syndromes(const void* host);

// Front kernel for the decode paths: int16 IQ -> exact magnitude -> the
// gate at every offset as bits, the PPM compares as bits, and the
// detections per tile of kTile offsets, in one pass.
//
// Replaces airjax/kernels/magdet.py::_magdet_packed_kernel (magdet_packed,
// the pallas_call at :250) with Gate::kDf17, and the XLA-fused
// airjax/dsp/demod.py::detect_preamble_only (:70) with Gate::kPreamble.
// Its plain torch version is airjax_torch/kernels/magdet.py::
// magdet_bits_plain. csrc/magdet.cu::magdet_kernel (u8 mask) is its oracle.
//
//   det_words[w]   bit 31-k = the gate at offset 32w+k, MSB first (the
//                  pack_cmp_words layout); 0 at offsets >= n_off
//   words[w]       bit 31-k = mag[32w+k] > mag[32w+k+1]; 0 at 32w+k >= L-1,
//                  which also zeroes the trailing pad words
//   tile_counts[t] set bits of det_words[256t .. 256t+255], one tile per
//                  block
//
// Bound: memory traffic. Per sample it reads 4 B of IQ; per offset it
// writes 2 bits (a det bit, a compare bit), and 4 B per tile: 71.3 MB, 21.3
// us at 2^24 samples. On the card it takes about twice that, held by
// instruction issue: its time moves with the tap count at equal bytes, and
// with the per-sample address work of the shared stores (PERF.md). The
// design, against what bound magdet_kernel:
// - One thread owns 32 consecutive offsets: one det word and one compare
//   word, and a block owns one tile (kTile = 8192 offsets), whose count is
//   a __reduce_add_sync of __popc per warp, summed over the 8 warps. Stores
//   are whole coalesced words.
// - The block computes each magnitude once (plus a 32-sample look-ahead
//   per tile) into shared memory as biased int16, v = mag ^ 0x8000 =
//   mag - 32768 (order-preserving: mag <= 46341). A thread then reads its
//   window of 32 + 25 magnitudes once, as 29 words: 29 shared loads per 32
//   offsets against magdet_kernel's 26 per offset.
// - The gate runs in registers on paired int16 SIMD (__vmins2,
//   __vmaxs2, __vcmpges2): register P[j] holds mag[j+16] in its low half
//   and mag[j] in its high half, so one op serves offsets j and j+16 and
//   bit 0 / bit 16 of a compare land at bits 15-j / 31-j of the word with
//   one shift. Shared sub-terms (min or max of taps 2 apart, max of taps 1
//   apart) are computed once per thread: 323 ops per 32 offsets with the
//   DF17 taps, against 22 min/max per offset.
// - Shared memory is skewed by one word per 16 (thread t's word u sits at
//   17t + u + u/16), so the 32 lanes reading word u hit 32 banks.
// - IQ arrives as 16-byte vector loads from the 16-byte boundary at or
//   below the block's first sample, all of a thread's loads issued before
//   its first isqrt. A vector that reaches outside [0, L) is read word by
//   word instead, so a base that is 4-byte but not 16-byte aligned works
//   (pipeline._overlap_scan may slice at any sample) and nothing outside
//   the tensor is read. From a 16-byte-aligned base (the decode paths'
//   blocks and slices) a vector's four magnitudes fill two whole pair
//   words, stored as two 32-bit words; any other base stores 16-bit
//   halves, at more device time (the per-sample address work shows
//   because the kernel is issue-bound; chip_smoke.py times both).
//   Magnitudes past L are 0; no written bit depends on them (a det bit
//   needs o+25 < L, a compare i+1 < L).
//
// Count mode (kCount, Gate::kDf17 only): the detection count of the fused
// parity decode (airjax/pipeline.py::_count_chunked_detections, :464-482),
// the whole-stream gate over n_chunks * chunk samples filtered to the
// reference's chunks. The same gate over the same magnitudes; no det or
// compare word is written. Each thread ANDs its det word with the in-chunk
// mask of its 32 offsets (offset o counts when o < n_off = n_chunks *
// chunk - WINDOW and o mod chunk < chunk - WINDOW; a chunk of 20,000 is no
// multiple of 32, so a word can straddle a chunk edge), and the block's
// tile count is its only output; the caller sums the tile counts. Bound:
// the IQ read once, 4 B a sample: 20.0 us at 2^24 samples on 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "magnitude.cuh"

namespace {

constexpr int kThreads = 256;    // one det word and one compare word each
constexpr int kOffsets = 32 * kThreads;       // offsets per block
constexpr int kTile = 8192;      // offsets per tile count (kernels/magdet.py::TILE)
constexpr int kSpan = kOffsets + 32;          // magnitudes per block (thread t reads 32t .. 32t+57)
constexpr int kVecs = kSpan / 4 + 1;          // 16-byte loads, one more for a misaligned base
constexpr int kVecRounds = (kVecs + kThreads - 1) / kThreads;
constexpr int kSmemWords = kSpan / 2 + kSpan / 32;  // pair words, skewed by one per 16
constexpr int kWindowWords = 29;              // magnitudes 32t .. 32t+57 as pairs
constexpr int kPairs = 41;                    // P[0..40]: taps reach +25 from j+15
constexpr int kWindow = 240;                  // samples a frame window spans (dsp/demod.py WINDOW)
static_assert(kTile == kOffsets, "a block owns one tile");

__device__ __forceinline__ int skew(int q) { return q + (q >> 4); }

// The biased int16 magnitude of one IQ word, in the low 16 bits.
__device__ __forceinline__ uint32_t biased(uint32_t w) { return mag_from_word(w) ^ 0x8000u; }

__device__ __forceinline__ uint32_t mn(uint32_t a, uint32_t b) { return __vmins2(a, b); }
__device__ __forceinline__ uint32_t mx(uint32_t a, uint32_t b) { return __vmaxs2(a, b); }

// Bits 0 and 16 of a per-half 0xFFFF/0 result at bits 15-j and 31-j.
__device__ __forceinline__ uint32_t place(uint32_t r, int j) { return (r & 0x00010001u) << (15 - j); }

// Word w's first `valid` bits (MSB first) kept, the rest cleared.
__device__ __forceinline__ uint32_t keep_first(uint32_t bits, long long valid) {
  if (valid >= 32) return bits;
  return valid <= 0 ? 0u : bits & ~(0xFFFFFFFFu >> valid);
}

// The bits of offsets o0 + lo .. o0 + hi - 1 of a word (MSB first), lo and
// hi clamped to [0, 32].
__device__ __forceinline__ uint32_t span_bits(long long lo, long long hi) {
  return keep_first(0xFFFFFFFFu, hi) & ~keep_first(0xFFFFFFFFu, lo);
}

// Count mode: offsets o0 .. o0 + 31 as bits, set where the offset lies
// below chunk - kWindow in its chunk. chunk > kWindow > 32, so the word
// reaches into at most one more chunk, which starts at bit e1; each chunk
// excludes its last kWindow offsets.
__device__ __forceinline__ uint32_t in_chunk_bits(long long o0, long long chunk) {
  const long long r = o0 % chunk, e1 = chunk - r;
  return ~(span_bits(e1 - kWindow, e1) | span_bits(e1 + chunk - kWindow, e1 + chunk));
}

// chunk is read in count mode alone.
template <Gate G, bool kCount>
__global__ void __launch_bounds__(kThreads, 4)
magdet_bits_kernel(const uint32_t* __restrict__ iq, long long n_samples, long long n_off,
                   uint32_t* __restrict__ det_words, uint32_t* __restrict__ words,
                   long long n_words, int* __restrict__ tile_counts, long long chunk) {
  __shared__ uint32_t sm[kSmemWords];
  __shared__ unsigned warp_count[kThreads / 32];
  uint16_t* sm16 = reinterpret_cast<uint16_t*>(sm);
  const long long s0 = static_cast<long long>(blockIdx.x) * kOffsets;

  // mis: samples before iq's 16-byte boundary; s0 is a multiple of 4, so
  // vec[i] starts at sample s0 + 4i - mis. All of a thread's loads are
  // issued before the first isqrt, so that kVecRounds vectors per thread
  // are in flight at once.
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(iq) >> 2) & 3);
  const uint4* vec = reinterpret_cast<const uint4*>(iq - mis) + s0 / 4;
  uint4 x[kVecRounds];
#pragma unroll
  for (int r = 0; r < kVecRounds; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const long long g = s0 + 4LL * i - mis;
    if (i >= kVecs) {
      x[r] = make_uint4(0u, 0u, 0u, 0u);
    } else if (g >= 0 && g + 3 < n_samples) {
      x[r] = __ldg(vec + i);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = g + j >= 0 && g + j < n_samples ? __ldg(iq + g + j) : 0u;
      x[r] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  if (mis == 0) {
    // Vector i is positions 4i .. 4i+3: pair words 2i and 2i+1, which sit
    // side by side in one group of 16.
#pragma unroll
    for (int r = 0; r < kVecRounds; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (4 * i < kSpan) {
        const int q = skew(2 * i);
        sm[q] = biased(x[r].x) | biased(x[r].y) << 16;
        sm[q + 1] = biased(x[r].z) | biased(x[r].w) << 16;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kVecRounds; ++r) {
      const uint32_t w[4] = {x[r].x, x[r].y, x[r].z, x[r].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Position in the block (p >= 0 <=> sample >= s0); i >= kVecs gives p >= kSpan.
        const int p = 4 * (threadIdx.x + r * kThreads) + j - mis;
        if (p >= 0 && p < kSpan) sm16[2 * skew(p >> 1) + (p & 1)] = static_cast<uint16_t>(biased(w[j]));
      }
    }
  }
  __syncthreads();

  // Window: W[u] = (mag[32t+2u] low, mag[32t+2u+1] high).
  uint32_t W[kWindowWords];
#pragma unroll
  for (int u = 0; u < kWindowWords; ++u) W[u] = sm[skew(16 * threadIdx.x + u)];
  // P[j] = (mag[j+16] low, mag[j] high), relative to offset 32t.
  uint32_t P[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    P[j] = __byte_perm(W[(j + 16) >> 1], W[j >> 1], (j & 1) ? 0x7632 : 0x5410);
  }
  // Taps two apart (min) and one apart (max); unrolled, each is one value.
  auto a2 = [&](int i) { return mn(P[i], P[i + 2]); };
  auto b1 = [&](int i) { return mx(P[i], P[i + 1]); };

  uint32_t det = 0, cmp = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // Preamble highs {0,2,7,9}, lows {1,3,4,5,6,8,10,...,15}.
    const uint32_t hmin = mn(a2(j), a2(j + 7));
    const uint32_t lmax = mx(mx(P[j + 1], b1(j + 3)),
                             mx(mx(b1(j + 5), P[j + 8]), mx(b1(j + 10), mx(b1(j + 12), b1(j + 14)))));
    uint32_t r = __vcmpges2(hmin, lmax);
    if constexpr (G == Gate::kDf17) {
      // DF17 highs {16,19,21,23,24}, lows {17,18,20,22,25}.
      const uint32_t dmin = mn(mn(P[j + 16], P[j + 19]), mn(a2(j + 21), P[j + 24]));
      const uint32_t dmax = mx(mx(b1(j + 17), P[j + 20]), mx(P[j + 22], P[j + 25]));
      r &= __vcmpges2(dmin, dmax);
    }
    det |= place(r, j);
    cmp |= place(__vcmpgts2(P[j], P[j + 1]), j);
  }

  const long long w = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n_det_words = (n_off + 31) / 32;
  det = keep_first(det, n_off - 32 * w);
  if constexpr (kCount) {
    det &= in_chunk_bits(32 * w, chunk);
  } else {
    cmp = keep_first(cmp, n_samples - 1 - 32 * w);
    if (w < n_det_words) det_words[w] = det;
    if (w < n_words) words[w] = cmp;
  }
  const unsigned count = __reduce_add_sync(0xFFFFFFFFu, static_cast<unsigned>(__popc(det)));
  if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < (n_off + kTile - 1) / kTile) {
    unsigned tile = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) tile += warp_count[k];
    tile_counts[blockIdx.x] = static_cast<int>(tile);
  }
}

}  // namespace

// iq: (n_samples,) IQ words, 4-byte aligned; det_words: (ceil(n_off/32),)
// u32; words: (n_words,) u32 packed compares; tile_counts:
// (ceil(n_off/kTile),) i32; gate: 0 DF17, 1 preamble only. The caller
// guarantees n_off + 25 <= n_samples.
extern "C" int airjax_magdet_bits(const void* iq, long long n_samples, long long n_off,
                                  void* det_words, void* words, long long n_words,
                                  void* tile_counts, int gate, void* stream) {
  const long long n_det_words = (n_off + 31) / 32;
  const long long domain = n_words > n_det_words ? n_words : n_det_words;
  const long long blocks = (domain + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(iq);
  auto* d = static_cast<uint32_t*>(det_words);
  auto* c = static_cast<uint32_t*>(words);
  auto* t = static_cast<int*>(tile_counts);
  const auto grid = static_cast<unsigned>(blocks);
  if (gate == static_cast<int>(Gate::kPreamble)) {
    magdet_bits_kernel<Gate::kPreamble, false><<<grid, kThreads, 0, s>>>(x, n_samples, n_off, d, c, n_words, t, 0);
  } else {
    magdet_bits_kernel<Gate::kDf17, false><<<grid, kThreads, 0, s>>>(x, n_samples, n_off, d, c, n_words, t, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Count mode: iq: (n_samples,) IQ words, 4-byte aligned, n_samples =
// n_chunks * chunk; n_off = n_samples - 240 (n_off + 25 <= n_samples);
// chunk > 240; tile_counts: (ceil(n_off/kTile),) i32, each tile's DF17
// detections at in-chunk offsets (o mod chunk < chunk - 240).
extern "C" int airjax_chunked_count(const void* iq, long long n_samples, long long n_off, long long chunk,
                                    void* tile_counts, void* stream) {
  if (chunk <= kWindow) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = ((n_off + 31) / 32 + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  magdet_bits_kernel<Gate::kDf17, true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(iq), n_samples, n_off, nullptr, nullptr, 0, static_cast<int*>(tile_counts), chunk);
  return static_cast<int>(cudaGetLastError());
}

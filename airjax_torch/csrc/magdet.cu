// Front kernel: int16 IQ -> exact magnitude -> preamble gate per offset +
// PPM pair compares, in one pass. Magnitudes live only in shared memory;
// they never reach device memory.
//
// Replaces airjax/kernels/magdet.py::_magdet_packed_kernel (magdet_packed,
// :200-277) in mode PACKED and ::_magdet_kernel (magdet_fused, :97-165) in
// mode planes. Its plain torch version is airjax_torch/kernels/magdet.py::
// magdet_plain (magnitude_u16 -> detect or detect_preamble_only,
// pack_cmp_words).
//
//   mag[i]  = isqrt(re^2 + im^2)                   exact, uint32
//   det[i]  = min(highs) >= max(lows): the preamble taps (+0..+15), and
//             with Gate::kDf17 also the DF17 taps (+16..+25)
//   cmp[i]  = mag[i] > mag[i+1]
//
// Gate::kDf17 is the reference's detector (the DF17 main path);
// Gate::kPreamble is the preamble alone, for the extended decode of every
// downlink format (airjax/dsp/demod.py:70-84).
//
// PACKED writes det (n_off,) u8 and the dense pack_cmp_words layout
// (airjax/dsp/demod.py:222-250): word w holds cmp[32w .. 32w+31], MSB
// first, compares at i >= L-1 are 0 (which also zeroes the trailing pad
// words). It does not write the TPU's sparse byte plane (magdet.py:183-196,
// a Mosaic relayout workaround). Planes writes det (n_off,) and cmp (L-1,)
// as u8.
//
// Bound: memory traffic. Per sample it reads 4 B of IQ and writes 1 B of
// det plus 1/8 B of packed compares (planes: 1 B of cmp). The design keeps
// it at that: each block loads its tile of IQ words plus a 32-sample
// look-ahead once, coalesced, computes the magnitudes into shared memory,
// and reads the 26 stencil taps and the compares from there; a warp packs
// 32 compares with one __ballot_sync and __brev (sample 32w -> bit 31).
// Reads past L are masked; the zeros put in their place are seen by no
// output that is written (a written det needs i+25 < L, a compare i+1 < L).
//
// magdet_stencil_kernel holds the other formulations of the DF17 stencil,
// in the planes contract, for a same-run A/B against the flat int32 one.
// It replaces airjax/kernels/stencil3.py::magdet_tree (:203-250; bodies
// _tree_kernel_i32 :148, _tree_kernel_i16 :157, _flat_kernel_i16 :169,
// tree _tree_det_cmp :105); its plain version is airjax_torch/kernels/
// stencil3.py::magdet_tree_plain. On the TPU every shift cost a lane
// rotation; here a shift is a shared-memory index, so what the variants
// trade is shared-memory traffic and min/max count per offset:
//   flat32: 26 taps, 22 min/max per offset            (magdet_kernel)
//   tree32: the shift-sharing tree, one level at a time over the tile in
//           shared memory (20 reads, 8 writes, 14 min/max per offset)
//   tree16: the tree on two biased int16 magnitudes per 32-bit word
//           (__vmins2/__vmaxs2/__vcmpges2): half the words and ops
//   flat16: the flat stencil on the same paired words
// v = mag ^ 0x8000 = mag - 32768 (as int16) preserves order because
// mag <= 46341. A word pairs offsets j and j + kWords (not j and j+1), so
// a shift by s stays one aligned 32-bit load.
//
// The decode paths run csrc/front.cu's magdet_bits_kernel, which emits the
// gate as bits with a count per tile; magdet_kernel stays as its oracle
// and as the u8 mask of pipeline._count_chunked_detections.
//
// The exact magnitude is mag_from_word (magnitude.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "magnitude.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // offsets (and compare bits) per block
constexpr int kHalo = 32;    // look-ahead >= 26: taps reach +25, cmp +1
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerWarp = kTile / 32 / kWarps;
constexpr int kWords = 1024;  // shared words per block in magdet_stencil_kernel

// One uint32 magnitude per word: word j is offset j of the block.
struct Mag32 {
  static constexpr int kPerWord = 1;
  __device__ static uint32_t load(const uint32_t* iq, long long n, long long base, int j) {
    return base + j < n ? mag_from_word(__ldg(iq + base + j)) : 0u;
  }
  __device__ static uint32_t mn(uint32_t a, uint32_t b) { return min(a, b); }
  __device__ static uint32_t mx(uint32_t a, uint32_t b) { return max(a, b); }
  __device__ static uint32_t ge(uint32_t a, uint32_t b) { return a >= b; }
  __device__ static uint32_t gt(uint32_t a, uint32_t b) { return a > b; }
};

// Two biased int16 magnitudes per word: the low half is offset j of the
// block, the high half offset j + kWords.
struct Pair16 {
  static constexpr int kPerWord = 2;
  __device__ static uint32_t biased(const uint32_t* iq, long long n, long long g) {
    return (g < n ? mag_from_word(__ldg(iq + g)) : 0u) ^ 0x8000u;
  }
  __device__ static uint32_t load(const uint32_t* iq, long long n, long long base, int j) {
    return biased(iq, n, base + j) | biased(iq, n, base + j + kWords) << 16;
  }
  __device__ static uint32_t mn(uint32_t a, uint32_t b) { return __vmins2(a, b); }
  __device__ static uint32_t mx(uint32_t a, uint32_t b) { return __vmaxs2(a, b); }
  __device__ static uint32_t ge(uint32_t a, uint32_t b) { return __vcmpges2(a, b); }
  __device__ static uint32_t gt(uint32_t a, uint32_t b) { return __vcmpgts2(a, b); }
};

// The flat stencil at p[0]: nonzero (per half, for Pair16) where the gate passes.
template <class Ops, Gate G>
__device__ __forceinline__ uint32_t flat_det(const uint32_t* p) {
  using O = Ops;
  const uint32_t hmin = O::mn(O::mn(p[0], p[2]), O::mn(p[7], p[9]));
  const uint32_t lmax =
      O::mx(O::mx(O::mx(p[1], p[3]), O::mx(p[4], p[5])),
            O::mx(O::mx(O::mx(p[6], p[8]), O::mx(p[10], p[11])),
                  O::mx(O::mx(p[12], p[13]), O::mx(p[14], p[15]))));
  uint32_t det = O::ge(hmin, lmax);
  if constexpr (G == Gate::kDf17) {
    const uint32_t dmin = O::mn(O::mn(O::mn(p[16], p[19]), O::mn(p[21], p[23])), p[24]);
    const uint32_t dmax = O::mx(O::mx(O::mx(p[17], p[18]), O::mx(p[20], p[22])), p[25]);
    det &= O::ge(dmin, dmax);
  }
  return det;
}

template <bool kPacked, Gate G>
__global__ void __launch_bounds__(kThreads)
magdet_kernel(const uint32_t* __restrict__ iq, long long n_samples,
              long long n_off, uint8_t* __restrict__ det,
              void* __restrict__ out, long long n_out) {
  __shared__ uint32_t mag[kTile + kHalo];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;

  for (int i = threadIdx.x; i < kTile + kHalo; i += kThreads) {
    mag[i] = Mag32::load(iq, n_samples, base, i);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long o = base + i;
    if (o < n_off) det[o] = static_cast<uint8_t>(flat_det<Mag32, G>(mag + i));
  }

  if constexpr (kPacked) {
    uint32_t* words = static_cast<uint32_t*>(out);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < kWordsPerWarp; ++k) {
      const int i = (warp * kWordsPerWarp + k) * 32 + lane;
      const bool bit = base + i < n_samples - 1 && mag[i] > mag[i + 1];
      const uint32_t word = __brev(__ballot_sync(0xFFFFFFFFu, bit));
      if (lane == k) mine = word;
    }
    const long long w = base / 32 + warp * kWordsPerWarp + lane;
    if (lane < kWordsPerWarp && w < n_out) words[w] = mine;
  } else {
    uint8_t* cmp = static_cast<uint8_t*>(out);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const long long p = base + i;
      if (p < n_out) cmp[p] = static_cast<uint8_t>(mag[i] > mag[i + 1]);
    }
  }
}

// det/cmp of word j into the planes, per offset the word holds.
template <class Ops>
__device__ __forceinline__ void store_planes(uint8_t* det, uint8_t* cmp, long long base, int j,
                                             uint32_t d, uint32_t c, long long n_off,
                                             long long n_cmp) {
#pragma unroll
  for (int h = 0; h < Ops::kPerWord; ++h) {
    const long long o = base + j + h * kWords;
    const uint32_t shift = 16 * h;
    if (o < n_off) det[o] = static_cast<uint8_t>(((d >> shift) & 0xFFFFu) != 0);
    if (o < n_cmp) cmp[o] = static_cast<uint8_t>(((c >> shift) & 0xFFFFu) != 0);
  }
}

// The DF17 gate of airjax's _tree_det_cmp (stencil3.py:105-145), one level
// at a time over the block's words in shared memory. Each array is exactly
// as long as the next level reads (word j of a level at shift s reads
// j + s of the one below); the deepest chain, dmax at the last word
// (g2max +17 <- gmax +5 <- m +3), reaches m[kWords - 1 + 25] < kWords + kHalo.
template <class Ops>
__device__ __forceinline__ void tree_planes(const uint32_t* m, uint8_t* det, uint8_t* cmp,
                                            long long base, long long n_off, long long n_cmp) {
  // Level 1: a2 = {0,2}, e = {0,7}, g = {0,3}.
  __shared__ uint32_t a2min[kWords + 7], a2max[kWords + 13], e[kWords + 1];
  __shared__ uint32_t gmin[kWords + 21], gmax[kWords + 22];
  for (int j = threadIdx.x; j < kWords + 22; j += kThreads) {
    const uint32_t m0 = m[j], m2 = m[j + 2], m3 = m[j + 3];
    if (j < kWords + 7) a2min[j] = Ops::mn(m0, m2);
    if (j < kWords + 13) a2max[j] = Ops::mx(m0, m2);
    if (j < kWords + 1) e[j] = Ops::mx(m0, m[j + 7]);
    if (j < kWords + 21) gmin[j] = Ops::mn(m0, m3);
    gmax[j] = Ops::mx(m0, m3);
  }
  __syncthreads();
  // Level 2: bmax = a2max at {3,10,12}; g2 = g at {0,5}, i.e. m at {0,3,5,8}.
  __shared__ uint32_t bmax[kWords + 1], g2min[kWords + 16], g2max[kWords + 17];
  for (int j = threadIdx.x; j < kWords + 17; j += kThreads) {
    if (j < kWords + 1) bmax[j] = Ops::mx(a2max[j + 3], Ops::mx(a2max[j + 10], a2max[j + 12]));
    if (j < kWords + 16) g2min[j] = Ops::mn(gmin[j], gmin[j + 5]);
    g2max[j] = Ops::mx(gmax[j], gmax[j + 5]);
  }
  __syncthreads();
  // Level 3: highs {0,2}+{0,7}; lows bmax at {0,1} and e at {1};
  // DF17 highs g2min +16 and m +23; DF17 lows g2max +17 and m +18.
  for (int j = threadIdx.x; j < kWords; j += kThreads) {
    const uint32_t hmin = Ops::mn(a2min[j], a2min[j + 7]);
    const uint32_t lmax = Ops::mx(Ops::mx(bmax[j], bmax[j + 1]), e[j + 1]);
    const uint32_t dmin = Ops::mn(g2min[j + 16], m[j + 23]);
    const uint32_t dmax = Ops::mx(g2max[j + 17], m[j + 18]);
    const uint32_t d = Ops::ge(hmin, lmax) & Ops::ge(dmin, dmax);
    store_planes<Ops>(det, cmp, base, j, d, Ops::gt(m[j], m[j + 1]), n_off, n_cmp);
  }
}

template <class Ops, bool kTree>
__global__ void __launch_bounds__(kThreads)
magdet_stencil_kernel(const uint32_t* __restrict__ iq, long long n_samples,
                      long long n_off, uint8_t* __restrict__ det,
                      uint8_t* __restrict__ cmp, long long n_cmp) {
  __shared__ uint32_t m[kWords + kHalo];
  const long long base = static_cast<long long>(blockIdx.x) * kWords * Ops::kPerWord;
  for (int j = threadIdx.x; j < kWords + kHalo; j += kThreads) {
    m[j] = Ops::load(iq, n_samples, base, j);
  }
  __syncthreads();
  if constexpr (kTree) {
    tree_planes<Ops>(m, det, cmp, base, n_off, n_cmp);
  } else {
    for (int j = threadIdx.x; j < kWords; j += kThreads) {
      store_planes<Ops>(det, cmp, base, j, flat_det<Ops, Gate::kDf17>(m + j),
                        Ops::gt(m[j], m[j + 1]), n_off, n_cmp);
    }
  }
}

template <class Ops, bool kTree>
void launch_stencil(const uint32_t* iq, long long n_samples, long long n_off, uint8_t* det,
                    uint8_t* cmp, long long n_cmp, long long domain, cudaStream_t s) {
  constexpr long long kPerBlock = static_cast<long long>(kWords) * Ops::kPerWord;
  const long long blocks = (domain + kPerBlock - 1) / kPerBlock;
  if (blocks == 0) return;
  magdet_stencil_kernel<Ops, kTree><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      iq, n_samples, n_off, det, cmp, n_cmp);
}

}  // namespace

// iq: (n_samples,) IQ words; det: (n_off,) u8; out: (n_out,) u32 packed
// words if packed, else (n_out = n_samples-1,) u8 compares; gate: 0 DF17,
// 1 preamble only. The caller guarantees n_off + 25 < n_samples + 1 and a
// 4-byte aligned iq.
extern "C" int airjax_magdet(const void* iq, long long n_samples,
                             long long n_off, void* det, void* out,
                             long long n_out, int packed, int gate, void* stream) {
  const long long n_bits = packed ? 32 * n_out : n_out;
  const long long domain = n_off > n_bits ? n_off : n_bits;
  const long long blocks = (domain + kTile - 1) / kTile;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* words = static_cast<const uint32_t*>(iq);
  auto* d = static_cast<uint8_t*>(det);
  const auto grid = static_cast<unsigned>(blocks);
  if (gate == static_cast<int>(Gate::kPreamble)) {
    if (packed) {
      magdet_kernel<true, Gate::kPreamble><<<grid, kThreads, 0, s>>>(words, n_samples, n_off, d, out, n_out);
    } else {
      magdet_kernel<false, Gate::kPreamble><<<grid, kThreads, 0, s>>>(words, n_samples, n_off, d, out, n_out);
    }
  } else if (packed) {
    magdet_kernel<true, Gate::kDf17><<<grid, kThreads, 0, s>>>(words, n_samples, n_off, d, out, n_out);
  } else {
    magdet_kernel<false, Gate::kDf17><<<grid, kThreads, 0, s>>>(words, n_samples, n_off, d, out, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The DF17 gate and compares in the planes contract (det (n_off,) u8,
// cmp (n_samples-1,) u8) through stencil variant 1 tree32, 2 tree16 or
// 3 flat16. Same caller guarantees as airjax_magdet.
extern "C" int airjax_magdet_stencil(const void* iq, long long n_samples,
                                     long long n_off, void* det, void* cmp,
                                     int variant, void* stream) {
  const long long n_cmp = n_samples - 1;
  const long long domain = n_off > n_cmp ? n_off : n_cmp;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* words = static_cast<const uint32_t*>(iq);
  auto* d = static_cast<uint8_t*>(det);
  auto* c = static_cast<uint8_t*>(cmp);
  switch (variant) {
    case 1: launch_stencil<Mag32, true>(words, n_samples, n_off, d, c, n_cmp, domain, s); break;
    case 2: launch_stencil<Pair16, true>(words, n_samples, n_off, d, c, n_cmp, domain, s); break;
    case 3: launch_stencil<Pair16, false>(words, n_samples, n_off, d, c, n_cmp, domain, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

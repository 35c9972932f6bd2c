// Front kernel: int16 IQ -> exact magnitude -> preamble/DF17 gate per
// offset + PPM pair compares, in one pass. Magnitudes live only in shared
// memory; they never reach device memory.
//
// Replaces airjax/kernels/magdet.py::_magdet_packed_kernel (magdet_packed,
// :200-277) in mode PACKED and ::_magdet_kernel (magdet_fused, :97-165) in
// mode planes. Its plain torch version is airjax_torch/kernels/magdet.py::
// magdet_plain (magnitude_u16 -> detect, pack_cmp_words).
//
//   mag[i]  = isqrt(re^2 + im^2)                   exact, uint32
//   det[i]  = min(highs) >= max(lows), preamble and DF17 taps (+0..+25)
//   cmp[i]  = mag[i] > mag[i+1]
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
// Built without --use_fast_math: sqrtf is correctly rounded, and the
// two-sided fixup makes the isqrt exact whichever way it rounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // offsets (and compare bits) per block
constexpr int kHalo = 32;    // look-ahead >= 26: taps reach +25, cmp +1
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerWarp = kTile / 32 / kWarps;

__device__ __forceinline__ uint32_t mag_from_word(uint32_t w) {
  // I in the low 16 bits, Q in the high 16 (little-endian int16 pairs).
  const int re = static_cast<int16_t>(w & 0xFFFFu);
  const int im = static_cast<int16_t>(w >> 16);
  // Each square <= 2^30; the sum is at most 2^31, exact in uint32.
  const uint32_t s = static_cast<uint32_t>(re * re) + static_cast<uint32_t>(im * im);
  uint32_t k = static_cast<uint32_t>(sqrtf(static_cast<float>(s)));
  const uint32_t up = k + 1;  // <= 46342, so up * up < 2^32
  if (up * up <= s) k = up;
  if (k > 0 && k * k > s) k -= 1;
  return k;
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
magdet_kernel(const uint32_t* __restrict__ iq, long long n_samples,
              long long n_off, uint8_t* __restrict__ det,
              void* __restrict__ out, long long n_out) {
  __shared__ uint32_t mag[kTile + kHalo];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;

  for (int i = threadIdx.x; i < kTile + kHalo; i += kThreads) {
    const long long g = base + i;
    mag[i] = g < n_samples ? mag_from_word(__ldg(iq + g)) : 0u;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long o = base + i;
    if (o < n_off) {
      const uint32_t* m = mag + i;
      const uint32_t hmin = min(min(m[0], m[2]), min(m[7], m[9]));
      const uint32_t lmax =
          max(max(max(m[1], m[3]), max(m[4], m[5])),
              max(max(max(m[6], m[8]), max(m[10], m[11])),
                  max(max(m[12], m[13]), max(m[14], m[15]))));
      const uint32_t dmin = min(min(min(m[16], m[19]), min(m[21], m[23])), m[24]);
      const uint32_t dmax = max(max(max(m[17], m[18]), max(m[20], m[22])), m[25]);
      det[o] = static_cast<uint8_t>((hmin >= lmax) & (dmin >= dmax));
    }
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

}  // namespace

// iq: (n_samples,) IQ words; det: (n_off,) u8; out: (n_out,) u32 packed
// words if packed, else (n_out = n_samples-1,) u8 compares. The caller
// guarantees n_off + 25 < n_samples + 1 and a 4-byte aligned iq.
extern "C" int airjax_magdet(const void* iq, long long n_samples,
                             long long n_off, void* det, void* out,
                             long long n_out, int packed, void* stream) {
  const long long n_bits = packed ? 32 * n_out : n_out;
  const long long domain = n_off > n_bits ? n_off : n_bits;
  const long long blocks = (domain + kTile - 1) / kTile;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* words = static_cast<const uint32_t*>(iq);
  auto* d = static_cast<uint8_t*>(det);
  if (packed) {
    magdet_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        words, n_samples, n_off, d, out, n_out);
  } else {
    magdet_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        words, n_samples, n_off, d, out, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

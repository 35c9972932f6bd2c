// Candidate kernel: packed PPM compares + candidate offsets -> 14-byte
// frames, CRC-24 check and single-bit repair. One thread per candidate.
//
// No Pallas ancestor: on the TPU, XLA fuses airjax/dsp/demod.py::
// slice_bits_packed (:285-306), airjax/protocol/crc.py::
// crc_check_and_recover (:108-135) and bits_to_bytes (:200-204). Its plain
// torch version is airjax_torch/kernels/candidate.py::
// decode_candidates_plain.
//
// Per candidate at offset o, data bit t is compare o + 16 + 2t, so the
// frame spans 8 consecutive words from word0 = (o + 16) / 32. A funnel
// shift aligns the window; the even bits of each aligned word are the 16
// frame bits, MSB first. The CRC is the XOR of the syndromes of the set
// data bits (CRC-24 is linear over GF(2)); a nonzero delta equal to the
// syndrome of data bit j (j < 88; syndromes are pairwise distinct, so the
// match is unique) flips bit j. A flip in the CRC field never validates.
//
// Mode extended (`adsb --extended`, every downlink format) also writes,
// per candidate, what airjax/pipeline.py:206-237 derives from the raw
// bits: the bytes before the repair, df = the first 5 bits, the long
// AP residual (the pre-repair delta, crc24(bits[:88]) ^ bits[88:112]) and
// the short one (the CRC of data bits 0-31 ^ PI = bits 32-55). The short
// CRC needs the syndromes of a 32-bit message; bit j of it has the
// syndrome of bit j + 56 of the 88-bit message (both x^(55-j) mod G), so
// it reads the same table. It also writes the candidate classes with
// airjax/pipeline.py:216-250's expressions, from the slot's validity: the
// ~30 (K,) torch ops that would compute them after the kernel cost more
// host launch time than the whole pass takes on the device.
//
// Bound: neither bandwidth nor arithmetic at the main path's sizes — a
// block holds at most a few thousand candidates, each gathering 32 B and
// writing 16 B; the 88 syndromes sit in __constant__ memory, read at one
// index across the warp (a broadcast). The word gather clamps its index to
// the array, as airjax's gather does; in-range offsets reach at most into
// the 8 zero pad words that pack_cmp_words appends.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDataBits = 88;
constexpr int kThreads = 128;

__constant__ uint32_t c_syndromes[kDataBits];

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

// The extended mode's input and outputs; null in the DF17 mode.
struct Extended {
  const bool* valid;    // (n_cand,) in: the slot holds a detection
  uint8_t* frames_raw;  // (n_cand, 14)
  int32_t* df;          // (n_cand,)
  int32_t* icao_long;   // (n_cand,)
  int32_t* icao_short;  // (n_cand,)
  bool* classes;        // (kClasses, n_cand), rows in the order of enum Class
};

enum Class { kGoodLong, kRecovered, kGoodDf11, kCandDf11Ic, kCandShortAp, kCandLongAp, kClasses };

__device__ __forceinline__ void store_frame(uint8_t* f, const uint32_t* h) {
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    f[2 * q] = static_cast<uint8_t>(h[q] >> 8);
    f[2 * q + 1] = static_cast<uint8_t>(h[q] & 0xFFu);
  }
}

template <bool kExtended>
__global__ void __launch_bounds__(kThreads)
candidate_kernel(const uint32_t* __restrict__ words, long long n_words,
                 const int32_t* __restrict__ offsets, long long n_cand,
                 uint8_t* __restrict__ frames, bool* __restrict__ crc_ok,
                 bool* __restrict__ recovered, Extended ext) {
  // Mode extended writes its classes instead of crc_ok and recovered.
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n_cand) return;

  const long long d0 = static_cast<long long>(offsets[k]) + 16;
  const long long word0 = d0 >> 5;
  const unsigned align = static_cast<unsigned>(d0 & 31);
  uint32_t w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    long long idx = word0 + j;
    idx = idx < 0 ? 0 : (idx >= n_words ? n_words - 1 : idx);
    w[j] = __ldg(words + idx);
  }

  // h[q] = frame bits 16q .. 16q+15, MSB first (two frame bytes).
  uint32_t h[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) h[q] = even_bits(__funnelshift_l(w[q + 1], w[q], align));

  uint32_t calced = 0;
#pragma unroll
  for (int i = 0; i < kDataBits; ++i) {
    if ((h[i >> 4] >> (15 - (i & 15))) & 1u) calced ^= c_syndromes[i];
  }
  const uint32_t packet_crc = ((h[5] & 0xFFu) << 16) | h[6];
  const uint32_t delta = calced ^ packet_crc;

  const int df = static_cast<int>(h[0] >> 11);
  uint32_t icao_short = 0;
  if constexpr (kExtended) {
    store_frame(ext.frames_raw + k * 14, h);
    ext.df[k] = df;
    ext.icao_long[k] = static_cast<int32_t>(delta);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((h[i >> 4] >> (15 - (i & 15))) & 1u) icao_short ^= c_syndromes[56 + i];
    }
    icao_short ^= (h[2] << 8) | (h[3] >> 8);  // PI: frame bits 32-55
    ext.icao_short[k] = static_cast<int32_t>(icao_short);
  }

  int flip = -1;
  if (delta != 0) {
    for (int j = 0; j < kDataBits; ++j) {
      if (c_syndromes[j] == delta) flip = j;
    }
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    if (flip >= 0 && (flip >> 4) == q) h[q] ^= 1u << (15 - (flip & 15));
  }

  store_frame(frames + k * 14, h);
  const bool ok = delta == 0 || flip >= 0;
  if constexpr (kExtended) {
    const bool valid = ext.valid[k];
    // AP-addressed long frames: DF16 ACAS, DF20/21 Comm-B, DF24+ Comm-D ELM.
    const bool is_long_ap = df == 16 || df == 20 || df == 21 || df >= 24;
    const bool good_long = ok && df >= 16 && valid && !is_long_ap;
    bool* c = ext.classes;
    c[kGoodLong * n_cand + k] = good_long;
    c[kRecovered * n_cand + k] = flip >= 0 && good_long;
    c[kGoodDf11 * n_cand + k] = df == 11 && icao_short == 0 && valid;
    c[kCandDf11Ic * n_cand + k] = df == 11 && valid && icao_short != 0 && icao_short < 80;
    c[kCandShortAp * n_cand + k] = (df == 0 || df == 4 || df == 5) && valid && icao_short != 0;
    c[kCandLongAp * n_cand + k] = is_long_ap && valid && delta != 0;
  } else {
    crc_ok[k] = ok;
    recovered[k] = flip >= 0;
  }
}

}  // namespace

// Copies the 88 syndromes (uint32, host memory) into __constant__ memory
// of the current device. Called once per device before the first launch.
extern "C" int airjax_load_syndromes(const void* host) {
  cudaMemcpyToSymbol(c_syndromes, host, sizeof(c_syndromes));
  return static_cast<int>(cudaGetLastError());
}

// words: (n_words,) u32 packed compares; offsets: (n_cand,) int32, invalid
// slots already replaced by 0; frames: (n_cand, 14) u8. Mode DF17 (valid
// null): crc_ok, recovered (n_cand,) bool. Mode extended: valid (n_cand,)
// bool in; frames_raw (n_cand, 14) u8; df, icao_long, icao_short (n_cand,)
// int32; classes (6, n_cand) bool (enum Class); crc_ok, recovered unused.
extern "C" int airjax_candidates(const void* words, long long n_words,
                                 const void* offsets, long long n_cand,
                                 void* frames, void* crc_ok, void* recovered,
                                 const void* valid, void* frames_raw, void* df,
                                 void* icao_long, void* icao_short, void* classes,
                                 void* stream) {
  const long long blocks = (n_cand + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const auto grid = static_cast<unsigned>(blocks);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* o = static_cast<const int32_t*>(offsets);
  auto* f = static_cast<uint8_t*>(frames);
  auto* ok = static_cast<bool*>(crc_ok);
  auto* rec = static_cast<bool*>(recovered);
  const Extended ext{static_cast<const bool*>(valid), static_cast<uint8_t*>(frames_raw),
                     static_cast<int32_t*>(df), static_cast<int32_t*>(icao_long),
                     static_cast<int32_t*>(icao_short), static_cast<bool*>(classes)};
  if (valid != nullptr) {
    candidate_kernel<true><<<grid, kThreads, 0, s>>>(w, n_words, o, n_cand, f, ok, rec, ext);
  } else {
    candidate_kernel<false><<<grid, kThreads, 0, s>>>(w, n_words, o, n_cand, f, ok, rec, ext);
  }
  return static_cast<int>(cudaGetLastError());
}

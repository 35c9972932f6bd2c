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

__global__ void __launch_bounds__(kThreads)
candidate_kernel(const uint32_t* __restrict__ words, long long n_words,
                 const int32_t* __restrict__ offsets, long long n_cand,
                 uint8_t* __restrict__ frames, bool* __restrict__ crc_ok,
                 bool* __restrict__ recovered) {
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

  uint8_t* f = frames + k * 14;
#pragma unroll
  for (int q = 0; q < 7; ++q) {
    f[2 * q] = static_cast<uint8_t>(h[q] >> 8);
    f[2 * q + 1] = static_cast<uint8_t>(h[q] & 0xFFu);
  }
  crc_ok[k] = delta == 0 || flip >= 0;
  recovered[k] = flip >= 0;
}

}  // namespace

// Copies the 88 syndromes (uint32, host memory) into __constant__ memory
// of the current device. Called once per device before the first launch.
extern "C" int airjax_load_syndromes(const void* host) {
  cudaMemcpyToSymbol(c_syndromes, host, sizeof(c_syndromes));
  return static_cast<int>(cudaGetLastError());
}

// words: (n_words,) u32 packed compares; offsets: (n_cand,) int32, invalid
// slots already replaced by 0; frames: (n_cand, 14) u8; crc_ok, recovered:
// (n_cand,) bool.
extern "C" int airjax_candidates(const void* words, long long n_words,
                                 const void* offsets, long long n_cand,
                                 void* frames, void* crc_ok, void* recovered,
                                 void* stream) {
  const long long blocks = (n_cand + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  candidate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int32_t*>(offsets), n_cand,
      static_cast<uint8_t*>(frames), static_cast<bool*>(crc_ok),
      static_cast<bool*>(recovered));
  return static_cast<int>(cudaGetLastError());
}

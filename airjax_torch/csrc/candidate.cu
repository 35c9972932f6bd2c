// Candidate kernel: packed PPM compares + candidate offsets -> 14-byte
// frames, CRC-24 check and single-bit repair. One thread per candidate.
//
// No Pallas ancestor: on the TPU, XLA fuses airjax/dsp/demod.py::
// slice_bits_packed (:285-306), airjax/protocol/crc.py::
// crc_check_and_recover (:108-135) and bits_to_bytes (:200-204). Its plain
// torch version is airjax_torch/kernels/candidate.py::
// decode_candidates_plain.
//
// The per-candidate decode lives in candidate.cuh, which the block-decode
// kernel (block_decode.cu) shares.
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

#include "candidate.cuh"

namespace {

constexpr int kThreads = 128;

// The extended mode's input and outputs; null in the DF17 mode.
struct Extended {
  const bool* valid;    // (n_cand,) in: the slot holds a detection
  uint8_t* frames_raw;  // (n_cand, 14)
  int32_t* df;          // (n_cand,)
  int32_t* icao_long;   // (n_cand,)
  int32_t* icao_short;  // (n_cand,)
  bool* classes;        // (kClasses, n_cand), rows in the order of enum Class
};

template <bool kExtended>
__global__ void __launch_bounds__(kThreads)
candidate_kernel(const uint32_t* __restrict__ words, long long n_words,
                 const int32_t* __restrict__ offsets, long long n_cand,
                 uint8_t* __restrict__ frames, bool* __restrict__ crc_ok_out,
                 bool* __restrict__ recovered, Extended ext) {
  // Mode extended writes its classes instead of crc_ok and recovered.
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= n_cand) return;

  Candidate c = slice_candidate(words, n_words, offsets[k]);
  if constexpr (kExtended) {
    const int df = frame_df(c);
    store_frame(ext.frames_raw + k * kFrameBytes, c.h, -1);
    ext.df[k] = df;
    ext.icao_long[k] = static_cast<int32_t>(c.delta);
    const uint32_t icao_short = short_residual(c);
    ext.icao_short[k] = static_cast<int32_t>(icao_short);
    repair(c);
    store_frame(frames + k * kFrameBytes, c.h, c.flip);
    store_classes(ext.classes, n_cand, k, c, df, icao_short, ext.valid[k]);
  } else {
    repair(c);
    store_frame(frames + k * kFrameBytes, c.h, c.flip);
    crc_ok_out[k] = crc_ok(c);
    recovered[k] = c.flip >= 0;
  }
}

}  // namespace

// Copies the 88 syndromes (uint32, host memory) into every copy of
// c_syndromes on the current device: this file's, block_decode.cu's and
// fields.cu's.
// Called once per device before the first launch of either kernel.
extern "C" int airjax_load_syndromes(const void* host) {
  int rc = load_syndromes(host);
  if (rc == 0) rc = load_block_decode_syndromes(host);
  return rc != 0 ? rc : load_fields_syndromes(host);
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

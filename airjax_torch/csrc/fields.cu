// Fields kernel: a block's frames -> every protocol field of every slot, in
// one launch. The A/B baseline and second oracle of the block-decode
// kernel's F flag (csrc/block_decode.cu), which computes the same fields
// from the words it holds in registers, so that a batched pass is two
// launches, and of the shard-gather kernel's F flag (csrc/shard_gather.cu),
// which computes them for the gathered rows of a sharded batched step. The
// paths that launch it are those where it is the only launch: the fields
// of an analysis' hits (airjax_torch/analytics.py::analyze_capture) and of
// the rows a multi-process decode merged across its ranks
// (airjax_torch/parallel/multihost.py::attach_candidate_fields).
//
// No Pallas ancestor: on the TPU, XLA fuses airjax/protocol/fields.py::
// extract_fields (:36-143) into the decode program
// (airjax/pipeline.py::decode_iq_block_with_fields, :287-304), and in the
// extended decode also airjax/protocol/shortframe.py::
// extract_short_fields_from_raw (:337-349) over the raw frames
// (decode_iq_block_extended_with_fields, :307-328). Its plain torch version
// is airjax_torch/kernels/fields.py::block_fields_plain.
//
// One thread per slot, over all K slots: airjax extracts the fields of the
// invalid slots too, and the whole dict is compared. The thread reads the
// 11 bytes of frames[k] the long fields need (and the first 7 of
// frames_raw[k] in the extended mode) and writes its slot through
// csrc/fields.cuh, the code the block-decode kernel runs. The short CRC is
// the XOR of the syndromes of the set data bits; bit j of a 32-bit message
// has the syndrome of bit j + 56 of an 88-bit one
// (candidate.cuh:short_residual), so it reads this file's copy of the long
// table.
//
// Bound: memory traffic, 14 B in and 105 B out a slot (DF17), 21 + 166 B
// extended: 0.24 MB at K = 2048 and 4.0 MB at K = 21,504, 0.07 / 1.2 us on
// an H100 SXM's 3.35 TB/s. At these sizes a launch is latency-bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "candidate.cuh"
#include "fields.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kExtended>
__global__ void __launch_bounds__(kThreads)
fields_kernel(const uint8_t* __restrict__ frames, const uint8_t* __restrict__ frames_raw, long long k_slots,
              int32_t* __restrict__ ints, uint8_t* __restrict__ bytes) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= k_slots) return;
  int b[11];
#pragma unroll
  for (int i = 0; i < 11; ++i) b[i] = __ldg(frames + k * kFrameBytes + i);
  store_long_fields(ints, bytes, k_slots, k, b);

  if constexpr (kExtended) {
    int r[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) r[i] = __ldg(frames_raw + k * kFrameBytes + i);
    const uint32_t w = (static_cast<uint32_t>(r[0]) << 24) | (r[1] << 16) | (r[2] << 8) | r[3];
    uint32_t crc = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((w >> (31 - i)) & 1u) crc ^= c_syndromes[56 + i];
    }
    store_short_fields(ints, bytes, k_slots, k, w, (r[4] << 16) | (r[5] << 8) | r[6], crc);
  }
}

}  // namespace

int load_fields_syndromes(const void* host) { return load_syndromes(host); }

// frames: (K, 14) u8; frames_raw: (K, 14) u8 in the extended mode, else
// null; ints: (24 or 24 + 15, K) i32; bytes: (9 or 10) * K u8,
// callsign_codes (K, 8), alt_mode_25 (K,), then altitude_valid (K,) in the
// extended mode. bytes must be 4-byte aligned.
extern "C" int airjax_fields(const void* frames, const void* frames_raw, long long k, void* ints, void* bytes,
                             void* stream) {
  if (k == 0) return 0;
  const auto grid = static_cast<unsigned>((k + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const uint8_t*>(frames);
  const auto* r = static_cast<const uint8_t*>(frames_raw);
  auto* i = static_cast<int32_t*>(ints);
  auto* b = static_cast<uint8_t*>(bytes);
  if (r != nullptr) {
    fields_kernel<true><<<grid, kThreads, 0, s>>>(f, r, k, i, b);
  } else {
    fields_kernel<false><<<grid, kThreads, 0, s>>>(f, r, k, i, b);
  }
  return static_cast<int>(cudaGetLastError());
}

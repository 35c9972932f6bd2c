// Fields kernel: a block's frames -> every protocol field of every slot, in
// one launch. The batched decode paths run it after the block-decode kernel,
// so a batched pass is three launches (front, block decode, fields).
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
// 14 bytes of frames[k] (and the first 7 of frames_raw[k] in the extended
// mode) and writes row r of the int32 (rows, K) buffer as ints[r * K + k]
// (coalesced across a warp), and the 8 callsign bytes, alt_mode_25 and, in
// the extended mode, altitude_valid into the byte buffer. The row order is
// LONG_ROWS then SHORT_ROWS of kernels/fields.py. The short CRC is the XOR
// of the syndromes of the set data bits; bit j of a 32-bit message has the
// syndrome of bit j + 56 of an 88-bit one (candidate.cuh:short_residual),
// so it reads this file's copy of the long table.
//
// Not folded into the block-decode kernel: that kernel is latency-bound at
// its 128-register budget, and ~41 more outputs a slot would press on it.
// Bound: memory traffic, 14 B in and 105 B out a slot (DF17), 21 + 166 B
// extended: 0.24 MB at K = 2048 and 4.0 MB at K = 21,504, 0.07 / 1.2 us on
// an H100 SXM's 3.35 TB/s. At these sizes a launch is latency-bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include "candidate.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLongRows = 24;
constexpr int kShortRows = 15;

// src/adsb/msgs.rs:172-177, the reference's 64-char callsign table.
__constant__ char c_chars[65] = "#ABCDEFGHIJKLMNOPQRSTUVWXYZ#####_###############0123456789######";

__device__ __forceinline__ int gray2bin(int g) {
  g ^= g >> 4;
  g ^= g >> 2;
  return g ^ (g >> 1);
}

template <bool kExtended>
__global__ void __launch_bounds__(kThreads)
fields_kernel(const uint8_t* __restrict__ frames, const uint8_t* __restrict__ frames_raw, long long k_slots,
              int32_t* __restrict__ ints, uint8_t* __restrict__ bytes) {
  const long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (k >= k_slots) return;
  const long long K = k_slots;
  int b[11];
#pragma unroll
  for (int i = 0; i < 11; ++i) b[i] = __ldg(frames + k * kFrameBytes + i);
  const int b4 = b[4], m1 = b[5], m2 = b[6], m3 = b[7], m4 = b[8], m5 = b[9], m6 = b[10];
  const int msg_type = b4 >> 3;
  const int msg_class = (msg_type >= 1 && msg_type <= 4) ? 1 : (msg_type >= 9 && msg_type <= 18) ? 2 : 0;
  const bool alt_mode_25 = (m1 & 1) == 1;
  const int alt_code = (((m1 & 0xFE) >> 1) << 4) | ((m2 & 0xF0) >> 4);
  int32_t row[kLongRows] = {
      b[0] >> 3,                                        // df
      b[0] & 7,                                         // subformat
      b[0] & 5,                                         // capability (the reference's quirk)
      (b[1] << 16) | (b[2] << 8) | b[3],                // icao
      msg_type,
      msg_class,
      alt_code * (alt_mode_25 ? 25 : 100) - 1000,       // altitude_ft
      (b4 & 6) >> 1,                                    // surveillance_status
      b4 & 1,                                           // nic_supplement
      (m2 & 8) >> 3,                                    // cpr_time
      (m2 & 4) >> 2,                                    // cpr_odd
      ((m2 & 3) << 15) | (m3 << 7) | ((m4 & 0xFE) >> 1),  // cpr_lat
      ((m4 & 1) << 16) | (m5 << 8) | m6,                // cpr_lon
      msg_type == 19 ? 3 : msg_class,                   // msg_class_ext
      b4 & 7,                                           // vel_subtype
      (m1 >> 2) & 1, ((m1 & 3) << 8) | m2,              // vel_sign_a, vel_val_a
      (m3 >> 7) & 1, ((m3 & 0x7F) << 3) | (m4 >> 5),    // vel_sign_b, vel_val_b
      (m4 >> 4) & 1,                                    // vel_vr_source_baro
      (m4 >> 3) & 1, ((m4 & 7) << 6) | (m5 >> 2),       // vel_vr_sign, vel_vr_val
      (m6 >> 7) & 1, m6 & 0x7F,                         // vel_gbd_sign, vel_gbd_val
  };
#pragma unroll
  for (int r = 0; r < kLongRows; ++r) ints[r * K + k] = row[r];
  bytes[8 * K + k] = alt_mode_25;
  const uint32_t hi24 = (m1 << 16) | (m2 << 8) | m3, lo24 = (m4 << 16) | (m5 << 8) | m6;
  uchar4 lo, hi;
  lo.x = c_chars[(hi24 >> 18) & 0x3F], lo.y = c_chars[(hi24 >> 12) & 0x3F];
  lo.z = c_chars[(hi24 >> 6) & 0x3F], lo.w = c_chars[hi24 & 0x3F];
  hi.x = c_chars[(lo24 >> 18) & 0x3F], hi.y = c_chars[(lo24 >> 12) & 0x3F];
  hi.z = c_chars[(lo24 >> 6) & 0x3F], hi.w = c_chars[lo24 & 0x3F];
  uint8_t* cs = bytes + 8 * k;  // (K, 8) callsign codes
  reinterpret_cast<uchar4*>(cs)[0] = lo;
  reinterpret_cast<uchar4*>(cs)[1] = hi;

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
    const int parity = (r[4] << 16) | (r[5] << 8) | r[6];
    // AC13 = bits 19..31: C1 A1 C2 A2 C4 A4 M B1 Q B2 D2 B4 D4; ac(t) = bit 19 + t.
    auto ac = [w](int t) { return static_cast<int>((w >> (12 - t)) & 1u); };
    const int m_bit = ac(6), q_bit = ac(8);
    const int n11 = (static_cast<int>(w >> 7) & 0x3F) << 5 | ac(7) << 4 | (static_cast<int>(w) & 0xF);
    const int c1 = ac(0), a1 = ac(1), c2 = ac(2), a2 = ac(3), c4 = ac(4), a4 = ac(5);
    const int b1 = ac(7), d1 = ac(8), b2 = ac(9), d2 = ac(10), b4s = ac(11), d4 = ac(12);
    const int c_gray = (c1 << 2) | (c2 << 1) | c4;
    const int f_gray = (d2 << 7) | (d4 << 6) | (a1 << 5) | (a2 << 4) | (a4 << 3) | (b1 << 2) | (b2 << 1) | b4s;
    int ones = gray2bin(c_gray);
    if ((ones & 5) == 5) ones ^= 2;  // 7 <-> 5 remap
    const int fives = gray2bin(f_gray);
    const bool gillham_ok = c_gray != 0 && ones >= 1 && ones <= 5;
    if (fives & 1) ones = 6 - ones;  // reflection
    const int fs = static_cast<int>(w >> 24) & 7;
    int32_t srow[kShortRows] = {
        static_cast<int>(w >> 27),                      // df
        fs,
        static_cast<int>(w >> 19) & 0x1F,               // dr
        static_cast<int>(w >> 13) & 0x3F,               // um
        static_cast<int>(w >> 26) & 1,                  // vs
        static_cast<int>(w >> 25) & 1,                  // cc
        static_cast<int>(w >> 21) & 7,                  // sl
        static_cast<int>(w >> 15) & 0xF,                // ri
        fs,                                             // capability
        static_cast<int>(w & 0xFFFFFFu),                // icao_aa
        static_cast<int>(crc),                          // crc_calc
        parity,                                         // parity_field
        static_cast<int>(crc) ^ parity,                 // icao_ap
        q_bit ? n11 * 25 - 1000 : fives * 500 + ones * 100 - 1300,  // altitude_ft
        ((a4 << 2) | (a2 << 1) | a1) * 1000 + ((b4s << 2) | (b2 << 1) | b1) * 100 +
            ((c4 << 2) | (c2 << 1) | c1) * 10 + ((d4 << 2) | (d2 << 1) | d1),  // squawk
    };
#pragma unroll
    for (int i = 0; i < kShortRows; ++i) ints[(kLongRows + i) * K + k] = srow[i];
    bytes[9 * K + k] = m_bit == 0 && (q_bit == 1 || gillham_ok);  // altitude_valid
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

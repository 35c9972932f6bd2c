// The protocol fields of one slot, shared by the fields kernel (fields.cu)
// and the block-decode kernel's F flag (block_decode.cu), so that the two
// cannot drift apart: airjax/protocol/fields.py::extract_fields (:36-143)
// of the repaired frame and airjax/protocol/shortframe.py::
// extract_short_fields_from_raw (:337-349) of the raw one.
//
// Layout (kernels/fields.py): row r of the int32 (rows, K) buffer is
// ints[r * K + k], LONG_ROWS then SHORT_ROWS; the byte buffer holds the
// callsign codes (K, 8) first (two 4-byte stores a slot, so it must be
// 4-byte aligned), then alt_mode_25 (K,) and, in the extended mode,
// altitude_valid (K,).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLongRows = 24;
constexpr int kShortRows = 15;

// src/adsb/msgs.rs:172-177, the reference's 64-char callsign table.
__constant__ char c_chars[65] = "#ABCDEFGHIJKLMNOPQRSTUVWXYZ#####_###############0123456789######";

__device__ __forceinline__ int gray2bin(int g) {
  g ^= g >> 4;
  g ^= g >> 2;
  return g ^ (g >> 1);
}

// The long fields of slot k from frame bytes b[0..10].
__device__ __forceinline__ void store_long_fields(int32_t* __restrict__ ints, uint8_t* __restrict__ bytes,
                                                  long long K, long long k, const int* b) {
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
}

// The short fields of slot k from the raw frame: w = bytes 0-3 (MSB
// first), parity = bytes 4-6, crc = the short CRC of w (the XOR of the
// syndromes of its set bits; candidate.cuh:short_residual).
__device__ __forceinline__ void store_short_fields(int32_t* __restrict__ ints, uint8_t* __restrict__ bytes,
                                                   long long K, long long k, uint32_t w, int parity,
                                                   uint32_t crc) {
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

}  // namespace

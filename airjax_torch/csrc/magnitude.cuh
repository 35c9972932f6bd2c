// The exact magnitude of one IQ word and the gate choice, shared by the
// front kernels (magdet.cu, front.cu).
//
// Built without --use_fast_math: sqrtf is correctly rounded, and the
// two-sided fixup makes the isqrt exact whichever way it rounds.

#pragma once

#include <stdint.h>

namespace {

enum class Gate : int { kDf17 = 0, kPreamble = 1 };

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

}  // namespace

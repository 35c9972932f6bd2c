// Planes kernel: int16 IQ -> exact magnitude -> the gate at every offset
// and the PPM compares as u8 planes, in one pass, through four
// formulations of the same gate.
//
// Replaces airjax/kernels/magdet.py::_magdet_kernel (magdet_fused, the
// pallas_call at :138) with Form::kFront, and airjax/kernels/stencil3.py::
// magdet_tree (the pallas_call at :223; bodies _tree_kernel_i32 :148,
// _tree_kernel_i16 :157, _flat_kernel_i16 :169, the tree _tree_det_cmp
// :105) with kTree32, kTree16 and kFlat16. Plain versions:
// airjax_torch/kernels/magdet.py::magdet_plain(packed=False) and
// kernels/stencil3.py::magdet_tree_plain. The first forms of both,
// csrc/magdet.cu's magdet_kernel<false, G> and magdet_stencil_kernel, are
// its A/B baseline and second oracle (kernels/magdet.py::
// magdet_planes_baseline).
//
//   det[o]  the gate at offset o < n_off, 1 or 0 (Gate::kDf17: the
//           preamble and DF17 taps; Gate::kPreamble: the preamble alone,
//           kFront only, as airjax's stencil variants run DF17 alone)
//   cmp[i]  mag[i] > mag[i+1] for i < L-1, 1 or 0
//
// Bound: memory traffic. Per sample it reads 4 B of IQ and writes 1 B of
// det and 1 B of cmp: 100.7 MB, 30.05 us at 2^24 samples on 3.35 TB/s.
// The design is csrc/front.cu's (which stays as it is, so its load is
// copied here), with bytes out in place of bits:
// - One thread owns 32 consecutive offsets, a block of 256 threads 8192.
// - IQ arrives as 16-byte vector loads from the 16-byte boundary at or
//   below the block's first sample, all of a thread's loads issued before
//   its first isqrt; a vector that reaches outside [0, L) is read word by
//   word, so a base 4 bytes past a 16-byte boundary works and nothing
//   outside the tensor is read. Magnitudes past L are 0; no written byte
//   depends on them (a det byte needs o+25 < L, a compare i+1 < L).
// - Each magnitude is computed once into bank-skewed shared memory: as
//   biased int16 pairs, v = mag ^ 0x8000 = mag - 32768 (order-preserving:
//   mag <= 46341), skewed one word per 16, for the paired forms; as u32,
//   skewed one word per 32, for kTree32 (33.9 KB a block).
// - Each thread reads its window of 32 + 25 magnitudes once: 29 pair
//   words into registers, or 57 u32 from shared memory where the gate
//   first needs each (SharedMags).
// - The gate runs in registers, written per slot of the window in slot
//   order, so the compiler computes a shared sub-term once and keeps few
//   values live. The paired forms hold P[j] = (mag[j+16] low, mag[j]
//   high), as front.cu does, so one __vmins2/__vmaxs2/__vcmpges2 serves
//   offsets j and j+16:
//     kFront   front.cu's shared sub-terms (min or max of taps 2 apart, max
//              of taps 1 apart), both gates;
//     kTree32  airjax's _tree_det_cmp levels over u32 magnitudes, one
//              offset a value (twice the min/max);
//     kTree16  the same levels on the pairs;
//     kFlat16  the 26 taps folded left to right on the pairs, no shared
//              sub-term (no fold prefix repeats across offsets).
//   At 64 registers (__launch_bounds__(256, 4)) only kTree32 spills (60
//   bytes); at 3 or 2 blocks an SM it spilled none and ran slower (PERF.md).
// - A compare is 0xFFFF/0 a half (pairs) or 1/0 (u32); __byte_perm turns
//   four of them into the bytes of 4 (u32) or 2 x 4 (pairs) offsets, and a
//   thread's 32 det and 32 cmp bytes leave as two 16-byte stores a plane.
//   Only the thread at a plane's ragged end stores byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

#include "magnitude.cuh"

namespace {

enum class Form : int { kFront = 0, kTree32 = 1, kTree16 = 2, kFlat16 = 3 };

constexpr int kThreads = 256;
constexpr int kOffsets = 32 * kThreads;                  // offsets per block
constexpr int kSpan = kOffsets + 32;                     // magnitudes per block (thread t reads 32t .. 32t+56)
constexpr int kVecs = kSpan / 4 + 1;                     // 16-byte loads, one more for a misaligned base
constexpr int kVecRounds = (kVecs + kThreads - 1) / kThreads;
constexpr int kPairWords = kSpan / 2 + kSpan / 32;       // pair words, skewed by one per 16
constexpr int kMagWords = kSpan + kSpan / 32;            // u32 magnitudes, skewed by one per 32
constexpr int kWindowWords = 29;                         // magnitudes 32t .. 32t+57 as pairs
constexpr int kTaps = 25;                                // the gate reaches +25 from its offset

__device__ __forceinline__ int skew16(int q) { return q + (q >> 4); }
__device__ __forceinline__ int skew32(int q) { return q + (q >> 5); }

// The biased int16 magnitude of one IQ word, in the low 16 bits.
__device__ __forceinline__ uint32_t biased(uint32_t w) { return mag_from_word(w) ^ 0x8000u; }

// One u32 magnitude a value (kTree32): N = 32 slots, one offset each; a
// compare is 1 or 0.
struct Mag32 {
  static constexpr int N = 32;
  __device__ static uint32_t mn(uint32_t a, uint32_t b) { return min(a, b); }
  __device__ static uint32_t mx(uint32_t a, uint32_t b) { return max(a, b); }
  __device__ static uint32_t ge(uint32_t a, uint32_t b) { return a >= b; }
  __device__ static uint32_t gt(uint32_t a, uint32_t b) { return a > b; }
  // Slots 4k .. 4k+3 -> out[k], one byte each.
  __device__ static void bytes(const uint32_t* r, uint32_t (&out)[8], int k) {
    out[k] = __byte_perm(__byte_perm(r[0], r[1], 0x0040), __byte_perm(r[2], r[3], 0x0040), 0x5410);
  }
};

// Two biased int16 magnitudes a value (P[j]: offset j+16 low, j high):
// N = 16 slots of two offsets; a compare is 0xFFFF or 0 a half.
struct Pair {
  static constexpr int N = 16;
  __device__ static uint32_t mn(uint32_t a, uint32_t b) { return __vmins2(a, b); }
  __device__ static uint32_t mx(uint32_t a, uint32_t b) { return __vmaxs2(a, b); }
  __device__ static uint32_t ge(uint32_t a, uint32_t b) { return __vcmpges2(a, b); }
  __device__ static uint32_t gt(uint32_t a, uint32_t b) { return __vcmpgts2(a, b); }
  // Slots 4k .. 4k+3 -> out[k] (offsets 4k.., the high halves, byte 2)
  // and out[k+4] (offsets 16+4k.., the low halves, byte 0).
  __device__ static void bytes(const uint32_t* r, uint32_t (&out)[8], int k) {
    const uint32_t a = __byte_perm(r[0], r[1], 0x6240);  // r0.b0 r1.b0 r0.b2 r1.b2
    const uint32_t b = __byte_perm(r[2], r[3], 0x6240);
    out[k] = __byte_perm(a, b, 0x7632) & 0x01010101u;
    out[k + 4] = __byte_perm(a, b, 0x5410) & 0x01010101u;
  }
};

// The gate at slot j of the window m (O::N slots), in form F. Each form is
// written per slot, in slot order; the compiler computes a sub-term that
// several slots share once, and the slot order keeps the live values few.
template <Form F, Gate G, class O, class Window>
__device__ __forceinline__ uint32_t gate_at(const Window& m, int j) {
  if constexpr (F == Form::kFront) {
    // front.cu's gate with its shared sub-terms: min or max of taps 2
    // apart, max of taps 1 apart.
    auto a2 = [&](int i) { return O::mn(m[i], m[i + 2]); };
    auto b1 = [&](int i) { return O::mx(m[i], m[i + 1]); };
    // Preamble highs {0,2,7,9}, lows {1,3,4,5,6,8,10,...,15}.
    const uint32_t hmin = O::mn(a2(j), a2(j + 7));
    const uint32_t lmax = O::mx(O::mx(m[j + 1], b1(j + 3)),
                                O::mx(O::mx(b1(j + 5), m[j + 8]), O::mx(b1(j + 10), O::mx(b1(j + 12), b1(j + 14)))));
    uint32_t r = O::ge(hmin, lmax);
    if constexpr (G == Gate::kDf17) {
      // DF17 highs {16,19,21,23,24}, lows {17,18,20,22,25}.
      const uint32_t dmin = O::mn(O::mn(m[j + 16], m[j + 19]), O::mn(a2(j + 21), m[j + 24]));
      const uint32_t dmax = O::mx(O::mx(b1(j + 17), m[j + 20]), O::mx(m[j + 22], m[j + 25]));
      r &= O::ge(dmin, dmax);
    }
    return r;
  } else if constexpr (F == Form::kFlat16) {
    // The 26 DF17 taps folded left to right, as airjax's _flat_kernel_i16
    // reduces them: no fold prefix repeats across slots.
    const uint32_t* p = m + j;
    const uint32_t hmin = O::mn(O::mn(O::mn(p[0], p[2]), p[7]), p[9]);
    uint32_t lmax = O::mx(p[1], p[3]);
    lmax = O::mx(O::mx(O::mx(O::mx(lmax, p[4]), p[5]), p[6]), p[8]);
    lmax = O::mx(O::mx(O::mx(O::mx(O::mx(O::mx(lmax, p[10]), p[11]), p[12]), p[13]), p[14]), p[15]);
    const uint32_t dmin = O::mn(O::mn(O::mn(O::mn(p[16], p[19]), p[21]), p[23]), p[24]);
    const uint32_t dmax = O::mx(O::mx(O::mx(O::mx(p[17], p[18]), p[20]), p[22]), p[25]);
    return O::ge(hmin, lmax) & O::ge(dmin, dmax);
  } else {
    // kTree32 and kTree16: the DF17 gate of airjax's _tree_det_cmp
    // (stencil3.py:105-145), its levels as functions of the slot.
    // Preamble highs {0,2}+{0,7}; lows ({0,2}+{3,10,12}+{0,1}) u
    // ({1}+{0,7}); DF17 highs 16+(({0,3}+{0,5}) u {7}), lows 17+(the
    // same u {1}).
    auto a2min = [&](int i) { return O::mn(m[i], m[i + 2]); };
    auto a2max = [&](int i) { return O::mx(m[i], m[i + 2]); };
    auto e = [&](int i) { return O::mx(m[i], m[i + 7]); };
    auto bmax = [&](int i) { return O::mx(a2max(i + 3), O::mx(a2max(i + 10), a2max(i + 12))); };
    auto gmin = [&](int i) { return O::mn(m[i + 16], m[i + 19]); };  // {0,3} at +16
    auto gmax = [&](int i) { return O::mx(m[i + 17], m[i + 20]); };  // {0,3} at +17
    const uint32_t hmin = O::mn(a2min(j), a2min(j + 7));
    const uint32_t lmax = O::mx(O::mx(bmax(j), bmax(j + 1)), e(j + 1));
    const uint32_t dmin = O::mn(O::mn(gmin(j), gmin(j + 5)), m[j + 23]);
    const uint32_t dmax = O::mx(O::mx(gmax(j), gmax(j + 5)), m[j + 18]);
    return O::ge(hmin, lmax) & O::ge(dmin, dmax);
  }
}

// kTree32's window, m[u] = mag[32t+u] (skew32(32t+u) = 33t + u + u/32),
// read from shared memory where the gate first needs it. Loaded whole into
// registers, its 57 values and the tree's levels spilled 108 bytes at 64
// registers; read so, 60.
struct SharedMags {
  const uint32_t* row;  // sm + 33t
  __device__ uint32_t operator[](int u) const { return row[u + (u >> 5)]; }
};

// The block's magnitudes into shared memory: u32 skewed by one word per
// 32 (kU32), else biased int16 pairs skewed by one word per 16. The loads
// are csrc/front.cu's.
template <bool kU32>
__device__ __forceinline__ void load_block(const uint32_t* __restrict__ iq, long long n_samples, uint32_t* sm) {
  uint16_t* sm16 = reinterpret_cast<uint16_t*>(sm);
  const long long s0 = static_cast<long long>(blockIdx.x) * kOffsets;
  // mis: samples before iq's 16-byte boundary; s0 is a multiple of 4, so
  // vec[i] starts at sample s0 + 4i - mis.
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
  if (kU32 || mis != 0) {
#pragma unroll
    for (int r = 0; r < kVecRounds; ++r) {
      const uint32_t w[4] = {x[r].x, x[r].y, x[r].z, x[r].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Position in the block (p >= 0 <=> sample >= s0); i >= kVecs gives p >= kSpan.
        const int p = 4 * (threadIdx.x + r * kThreads) + j - mis;
        if (p < 0 || p >= kSpan) continue;
        if constexpr (kU32) {
          sm[skew32(p)] = mag_from_word(w[j]);
        } else {
          sm16[2 * skew16(p >> 1) + (p & 1)] = static_cast<uint16_t>(biased(w[j]));
        }
      }
    }
  } else {
    // Vector i is positions 4i .. 4i+3: pair words 2i and 2i+1, which sit
    // side by side in one group of 16.
#pragma unroll
    for (int r = 0; r < kVecRounds; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (4 * i < kSpan) {
        const int q = skew16(2 * i);
        sm[q] = biased(x[r].x) | biased(x[r].y) << 16;
        sm[q + 1] = biased(x[r].z) | biased(x[r].w) << 16;
      }
    }
  }
}

// 32 bytes of a plane from offset o0: two 16-byte stores, or byte by byte
// below n at the plane's ragged end.
__device__ __forceinline__ void store_plane(uint8_t* __restrict__ out, long long o0, long long n,
                                            const uint32_t (&v)[8]) {
  if (o0 + 32 <= n) {
    uint4* p = reinterpret_cast<uint4*>(out + o0);
    p[0] = make_uint4(v[0], v[1], v[2], v[3]);
    p[1] = make_uint4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (o0 + k < n) out[o0 + k] = static_cast<uint8_t>(v[k >> 2] >> (8 * (k & 3)));
    }
  }
}

// The gate and compares of a window in the form's values (O::N + kTaps of
// them), as bytes, four slots at a time.
template <class O, Form F, Gate G, class Window>
__device__ __forceinline__ void planes_of(const Window& m, uint32_t (&det)[8], uint32_t (&cmp)[8]) {
#pragma unroll
  for (int k = 0; k < O::N / 4; ++k) {
    uint32_t d[4], c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      d[q] = gate_at<F, G, O, Window>(m, 4 * k + q);
      c[q] = O::gt(m[4 * k + q], m[4 * k + q + 1]);
    }
    O::bytes(d, det, k);
    O::bytes(c, cmp, k);
  }
}

template <Form F, Gate G>
__global__ void __launch_bounds__(kThreads, 4)
planes_kernel(const uint32_t* __restrict__ iq, long long n_samples, long long n_off,
              uint8_t* __restrict__ det, uint8_t* __restrict__ cmp) {
  static_assert(F == Form::kFront || G == Gate::kDf17, "the stencil forms run the DF17 gate alone");
  constexpr bool kU32 = F == Form::kTree32;
  __shared__ uint32_t sm[kU32 ? kMagWords : kPairWords];
  load_block<kU32>(iq, n_samples, sm);
  __syncthreads();

  uint32_t det_bytes[8], cmp_bytes[8];
  if constexpr (kU32) {
    planes_of<Mag32, F, G>(SharedMags{sm + 33 * threadIdx.x}, det_bytes, cmp_bytes);
  } else {
    // Window: W[u] = (mag[32t+2u] low, mag[32t+2u+1] high).
    uint32_t W[kWindowWords];
#pragma unroll
    for (int u = 0; u < kWindowWords; ++u) W[u] = sm[skew16(16 * threadIdx.x + u)];
    // P[j] = (mag[j+16] low, mag[j] high), relative to offset 32t.
    uint32_t P[Pair::N + kTaps];
#pragma unroll
    for (int j = 0; j < Pair::N + kTaps; ++j) {
      P[j] = __byte_perm(W[(j + 16) >> 1], W[j >> 1], (j & 1) ? 0x7632 : 0x5410);
    }
    planes_of<Pair, F, G>(P, det_bytes, cmp_bytes);
  }
  const long long o0 = 32LL * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
  store_plane(det, o0, n_off, det_bytes);
  store_plane(cmp, o0, n_samples - 1, cmp_bytes);
}

template <Form F, Gate G>
int launch(const uint32_t* iq, long long n_samples, long long n_off, uint8_t* det, uint8_t* cmp, unsigned grid,
           cudaStream_t stream) {
  planes_kernel<F, G><<<grid, kThreads, 0, stream>>>(iq, n_samples, n_off, det, cmp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// iq: (n_samples,) IQ words, 4-byte aligned; det: (n_off,) u8; cmp:
// (n_samples-1,) u8, both 16-byte aligned; form: 0 front, 1 tree32, 2
// tree16, 3 flat16; gate: 0 DF17, 1 preamble only (front only). The caller
// guarantees n_off + 25 <= n_samples.
extern "C" int airjax_planes(const void* iq, long long n_samples, long long n_off, void* det, void* cmp,
                             int form, int gate, void* stream) {
  if ((reinterpret_cast<uintptr_t>(det) | reinterpret_cast<uintptr_t>(cmp)) & 15) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool preamble = gate == static_cast<int>(Gate::kPreamble);
  if (preamble && form != static_cast<int>(Form::kFront)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_cmp = n_samples - 1;
  const long long domain = n_off > n_cmp ? n_off : n_cmp;
  const long long blocks = (domain + kOffsets - 1) / kOffsets;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const auto* x = static_cast<const uint32_t*>(iq);
  auto* d = static_cast<uint8_t*>(det);
  auto* c = static_cast<uint8_t*>(cmp);
  const auto grid = static_cast<unsigned>(blocks);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case static_cast<int>(Form::kFront):
      return preamble ? launch<Form::kFront, Gate::kPreamble>(x, n_samples, n_off, d, c, grid, s)
                      : launch<Form::kFront, Gate::kDf17>(x, n_samples, n_off, d, c, grid, s);
    case static_cast<int>(Form::kTree32): return launch<Form::kTree32, Gate::kDf17>(x, n_samples, n_off, d, c, grid, s);
    case static_cast<int>(Form::kTree16): return launch<Form::kTree16, Gate::kDf17>(x, n_samples, n_off, d, c, grid, s);
    case static_cast<int>(Form::kFlat16): return launch<Form::kFlat16, Gate::kDf17>(x, n_samples, n_off, d, c, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

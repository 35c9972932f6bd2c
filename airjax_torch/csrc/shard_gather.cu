// Shard-gather kernel: the block-decode outputs of the D shards of a
// sharded decode -> one offset-sorted buffer of C rows, in one launch.
//
// No Pallas ancestor: on the TPU, XLA fuses airjax/parallel/halo.py::
// _compact_local (:259), _global_base (:322) and _scatter_to_global (:269),
// an all_gather of the shard counts and a psum of zero-padded rows, into the
// compact sharded decoders (build_sharded_decoder_compact :335, DF17, and
// build_sharded_decoder_extended_compact :521). Its plain torch version is
// airjax_torch/kernels/shard_gather.py::shard_gather_plain.
//
// Row r of shard s is selected when the slot is valid, its global offset
// offsets[r] + (first_shard + s) * block is at most max_offset, and (DF17) it is good or
// (extended) one of the six classes is set; the extended rows carry the set
// classes packed into a byte (bit c = class c). The selected rows are ranked
// shard by shard, in slot order, which the block-decode kernel writes in
// offset order; row j of shard s goes to base_s + j, base_s being the
// selected rows of the shards before s, when that is below C. Rows from the
// total up to C are zero, as the psum leaves them; n_rows is the total,
// n_det the shards' detections, overflow any shard's overflow or total > C.
// first_shard is the global index of the first shard: a process of a
// multi-process decode (airjax_torch/parallel/multihost.py) gathers its own
// shards with rows that are already global; the kernel takes its first
// shard's global offset, base0 = first_shard * block, as a parameter.
//
// One block per tile of 2048 rows of a shard, and one more per 8192 rows of
// C. Every block counts the selected rows of all shards, its warps' loads
// coalesced, and those of its shard before its tile, so each knows its
// tile's base and the total without a second launch or an atomic. A tile's
// block ranks its rows (4 consecutive rows a thread, a block scan of the
// threads' counts), lists the selected ones in shared memory, and copies
// them to their contiguous span of the output, a thread a row for the
// columns and a thread a byte for the frames, so that a warp's stores
// coalesce. All blocks share the zeroing of the rows past the total. The
// shards' pointers travel in the launch's parameters (at most kMaxShards).
//
// Latency, not bandwidth, sets the time: a thread issues its loads in
// groups (8 rows' selections, 8 frame bytes) with no branch or store among
// them. A branch around a row's loads, or a store between two loads that
// the compiler must assume may alias, makes every load wait for the one
// before it.
//
// Flag F (with_fields: the batched sinks' sharded steps) also writes the
// protocol fields of the C rows, as airjax/parallel/halo.py (:417-423,
// :613-620) runs extract_fields (and, extended, extract_short_fields_from_
// raw) over the replicated buffer: the `ints` (rows, C) and `bytes` buffers
// of kernels/fields.py::field_views, through csrc/fields.cuh, the code of
// the block-decode kernel's F flag and of csrc/fields.cu. A row's fields
// come from the bytes its copy loads: copy_frames also keeps bytes 0-10 of
// each frame (and 0-6 of the raw frame) in shared memory, after the step's
// loads, and once the block has copied its rows a thread a row computes
// them there, so that each byte is read from global memory once and the
// fields' stores coalesce across a warp's rows. The zero rows get the
// fields of an all-zero frame. The F outputs are a parameter of their own
// after Out, so that the instantiations without F keep their code. Four
// choices come from device times on the card (PERF.md): the callsign
// characters are computed, since a table lookup whose index differs
// between lanes is one constant-cache read per distinct index; the short
// CRC reads its 32 syndromes from shared memory, filled at the start,
// since after the fronts have streamed the IQ through L2 its constant
// reads missed and cost more than the rest of F; a warp's field stores
// start on a 32-row boundary; and where counting every shard's rows is
// cheap (D * K <= kCheapCount) more blocks share the zero rows.
//
// Bound: memory traffic, the flags of all D*K slots (2 B a slot, 7 B
// extended), the offsets of the slots they pass, the other columns of the
// rows written and C output rows (19 B a row DF17, 45 B extended, one more
// with recovered2): ~0.27 MB at D = 4, K = 2048, C = 8192, about 0.08 us on
// an H100's 3.35 TB/s. F adds the fields of the C rows, 105 B a row DF17
// and 166 B extended: 0.86 MB (0.26 us) at D = 4, K = 2048, C = 8192 and
// 5.4 MB (1.6 us) at C = 32,768 extended.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "fields.cuh"

namespace {

constexpr int kMaxShards = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCountRows = 8;                  // units (rows, or words of 4) a thread counts per step
constexpr int kRankRows = 4;                   // consecutive rows a thread ranks per step
constexpr int kStep = kThreads * kRankRows;    // rows a block ranks: a tile
constexpr int kCopy = 8;                       // frame bytes a thread loads before it stores them
constexpr long long kZeroRows = 8192;          // rows of C a zeroing block is launched for
constexpr long long kZeroRowsF = 1024;         // the same under F, where counting is cheap
constexpr long long kCheapCount = 32768;       // shard rows (D * K) a block counts cheaply
constexpr int kMaxZeroBlocks = 128;
constexpr int kFrameBytes = 14;
constexpr int kClasses = 6;
constexpr int kLongBytes = 11;                 // frame bytes the long fields read
constexpr int kShortBytes = 7;                 // raw frame bytes the short fields read
constexpr int kShortBits = 32;                 // data bits of a short frame the CRC covers

// One shard's block-decode outputs, K slots each (bools as bytes).
struct Shard {
  const int32_t* offsets;
  const uint8_t* valid;
  const uint8_t* select;     // DF17: good (K); extended: the six classes (6, K)
  const uint8_t* recovered;  // DF17
  const uint8_t* frames;     // (K, 14)
  const uint8_t* frames_raw; // extended, (K, 14)
  const int32_t* df;         // extended
  const int32_t* icao_short; // extended
  const int32_t* icao_long;  // extended
  const uint8_t* recovered2; // R2
  const int32_t* n_det;
  const uint8_t* overflow;
};

struct Shards {
  Shard s[kMaxShards];
};

// The (C,) outputs and the three scalars (null where the mode has none).
struct Out {
  int32_t* offsets;
  uint8_t* recovered;  // DF17
  uint8_t* classmask;  // extended
  uint8_t* frames;
  uint8_t* frames_raw;
  int32_t* df;
  int32_t* icao_short;
  int32_t* icao_long;
  uint8_t* recovered2;
  int32_t* n_rows;
  int32_t* n_det;
  uint8_t* overflow;
};

// Flag F's outputs: the fields of the C rows (kernels/fields.py::
// field_views), ints (24 or 24 + 15, C) i32 and bytes (9 or 10) * C u8,
// 4-byte aligned.
struct Fields {
  int32_t* ints;
  uint8_t* bytes;
};

// F's short CRC: bit j of a 32-bit message has the syndrome of data bit
// j + 56 of an 88-bit one. This file's copy, filled by
// airjax_load_syndromes (candidate.cu) through load_shard_gather_syndromes.
__constant__ uint32_t c_short_syndromes[kShortBits];

// Exclusive prefix of v over the block; *total gets the block's sum. Every
// thread of the block must call it.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// 0, or the selection of row r (r < k): 1 (DF17), the packed classes
// (extended). Every load is issued before any test.
template <bool kExtended>
__device__ __forceinline__ int row_mask(const Shard& sh, long long k, long long r, long long shard_base,
                                        long long max_offset) {
  const uint8_t valid = __ldg(sh.valid + r);
  const long long offset = static_cast<long long>(__ldg(sh.offsets + r)) + shard_base;
  int m;
  if constexpr (!kExtended) {
    m = __ldg(sh.select + r) != 0;
  } else {
    m = 0;
#pragma unroll
    for (int c = 0; c < kClasses; ++c) m |= (__ldg(sh.select + c * k + r) != 0) << c;
  }
  return valid != 0 && offset <= max_offset ? m : 0;
}

// The selected rows of a shard, summed over the block, and in *before
// those of them below row `split`. Thread t takes rows t, t + kThreads, ...
// Whole steps of kCountRows rows take no bound test, and the last step
// clamps its rows' indices instead, so that no branch separates a thread's
// loads.
template <bool kExtended>
__device__ __forceinline__ int count_rows(const Shard& sh, long long k, long long shard_base, long long max_offset,
                                          long long split, int* warp_sums, int* before) {
  int n = 0, n_before = 0;
  // Row r: `in` false adds nothing (its loads are still made, at r).
  auto count = [&](long long r, bool in) {
    const int hit = in && row_mask<kExtended>(sh, k, r, shard_base, max_offset) != 0;
    n += hit;
    n_before += hit && r < split;
  };
  long long r = threadIdx.x;
  for (; r + (kCountRows - 1) * kThreads < k; r += kCountRows * kThreads) {
#pragma unroll
    for (int j = 0; j < kCountRows; ++j) count(r + j * kThreads, true);
  }
  if (r < k) {
#pragma unroll
    for (int j = 0; j < kCountRows; ++j) {
      const long long rj = r + j * kThreads;
      count(rj < k ? rj : k - 1, rj < k);
    }
  }
  int sum;
  block_scan(n, warp_sums, &sum);
  if (split > 0) block_scan(n_before, warp_sums, before);
  return sum;
}

// n_bytes bytes of a step's selected frames, in list order, to dst: byte b
// is byte b % 14 of the frame of row r0 + list[b / 14]. With kKeep > 0
// (flag F), byte j < kKeep of frame i also goes to stage[i * row + at + j],
// stored after the group's loads.
template <int kKeep = 0>
__device__ __forceinline__ void copy_frames(uint8_t* dst, const uint8_t* src, long long r0, const int* list,
                                            int n_bytes, uint8_t* stage = nullptr, int row = 0, int at = 0) {
  for (int b0 = threadIdx.x; b0 < n_bytes; b0 += kCopy * kThreads) {
    uint8_t v[kCopy];
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const int b = min(b0 + u * kThreads, n_bytes - 1);
      const int i = b / kFrameBytes;
      v[u] = __ldg(src + (r0 + list[i]) * kFrameBytes + (b - i * kFrameBytes));
    }
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const int b = b0 + u * kThreads;
      if (b < n_bytes) {
        dst[b] = v[u];
        if constexpr (kKeep > 0) {
          const int i = b / kFrameBytes, j = b - i * kFrameBytes;
          if (j < kKeep) stage[i * row + at + j] = v[u];
        }
      }
    }
  }
}

// The fields of output row d from its staged bytes: s[0..10] of the frame
// and, extended, s[11..17] of the raw frame; syn: c_short_syndromes in
// shared memory. The short CRC is the XOR of the syndromes of the set bits.
template <bool kExtended>
__device__ __forceinline__ void store_row_fields(const Fields& fo, long long c, long long d, const uint8_t* s,
                                                 const uint32_t* syn) {
  int b[kLongBytes];
#pragma unroll
  for (int i = 0; i < kLongBytes; ++i) b[i] = s[i];
  store_long_fields<true>(fo.ints, fo.bytes, c, d, b);
  if constexpr (kExtended) {
    const uint8_t* r = s + kLongBytes;
    const uint32_t w = (static_cast<uint32_t>(r[0]) << 24) | (r[1] << 16) | (r[2] << 8) | r[3];
    uint32_t crc = 0;
#pragma unroll
    for (int i = 0; i < kShortBits; ++i) {
      if ((w >> (31 - i)) & 1u) crc ^= syn[i];
    }
    store_short_fields(fo.ints, fo.bytes, c, d, w, (r[4] << 16) | (r[5] << 8) | r[6], crc);
  }
}

// The n selected rows of a step (rows r0 + list[i], selections masks[i]) to
// output rows base .. base + n - 1; under F also their fields. Every
// thread of the block calls it (F waits at a barrier).
template <bool kExtended, bool kR2, bool kF>
__device__ __forceinline__ void copy_rows(const Out& out, const Fields& fo, const uint32_t* syn, long long c,
                                          const Shard& sh, long long r0, long long base, int n, const int* list,
                                          const uint8_t* masks, int32_t shard_base) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long r = r0 + list[i];
    const int32_t offset = __ldg(sh.offsets + r) + shard_base;
    int32_t df = 0, icao_short = 0, icao_long = 0;
    uint8_t recovered = 0;
    if constexpr (kExtended) {
      df = __ldg(sh.df + r);
      icao_short = __ldg(sh.icao_short + r);
      icao_long = __ldg(sh.icao_long + r);
    } else {
      recovered = __ldg(sh.recovered + r);
    }
    const uint8_t recovered2 = kR2 ? __ldg(sh.recovered2 + r) : 0;
    const long long d = base + i;
    out.offsets[d] = offset;
    if constexpr (kExtended) {
      out.classmask[d] = masks[i];
      out.df[d] = df;
      out.icao_short[d] = icao_short;
      out.icao_long[d] = icao_long;
    } else {
      out.recovered[d] = recovered;
    }
    if constexpr (kR2) out.recovered2[d] = recovered2;
  }
  if constexpr (kF) {
    // The bytes the fields read, a row of kRow bytes a selected row.
    constexpr int kRow = kExtended ? kLongBytes + kShortBytes : kLongBytes;
    __shared__ uint8_t stage[kStep * kRow];
    copy_frames<kLongBytes>(out.frames + base * kFrameBytes, sh.frames, r0, list, n * kFrameBytes, stage, kRow, 0);
    if constexpr (kExtended) {
      copy_frames<kShortBytes>(out.frames_raw + base * kFrameBytes, sh.frames_raw, r0, list, n * kFrameBytes, stage,
                               kRow, kLongBytes);
    }
    __syncthreads();
    // A warp's rows start on a 32-row boundary of the output, so that its
    // stores fill whole sectors of each field's column.
    for (int i = threadIdx.x - static_cast<int>(base & 31); i < n; i += kThreads) {
      if (i >= 0) store_row_fields<kExtended>(fo, c, base + i, stage + i * kRow, syn);
    }
  } else {
    copy_frames(out.frames + base * kFrameBytes, sh.frames, r0, list, n * kFrameBytes);
    if constexpr (kExtended) copy_frames(out.frames_raw + base * kFrameBytes, sh.frames_raw, r0, list, n * kFrameBytes);
  }
}

template <bool kExtended, bool kR2, bool kF>
__device__ __forceinline__ void zero_row(const Out& out, const Fields& fo, long long c, long long d) {
  out.offsets[d] = 0;
  if constexpr (kExtended) {
    out.classmask[d] = 0;
    out.df[d] = 0;
    out.icao_short[d] = 0;
    out.icao_long[d] = 0;
#pragma unroll
    for (int i = 0; i < kFrameBytes; ++i) out.frames_raw[d * kFrameBytes + i] = 0;
  } else {
    out.recovered[d] = 0;
  }
#pragma unroll
  for (int i = 0; i < kFrameBytes; ++i) out.frames[d * kFrameBytes + i] = 0;
  if constexpr (kR2) out.recovered2[d] = 0;
  if constexpr (kF) {  // the fields of an all-zero frame
    const int b[kLongBytes] = {};
    store_long_fields<true>(fo.ints, fo.bytes, c, d, b);
    if constexpr (kExtended) store_short_fields(fo.ints, fo.bytes, c, d, 0u, 0, 0u);
  }
}

// base0 is the first shard's global offset (0 in one process); fo is read
// under F alone.
template <bool kExtended, bool kR2, bool kF>
__global__ void __launch_bounds__(kThreads)
shard_gather_kernel(const Shards shards, int n_shards, long long k, long long c, long long block,
                    long long max_offset, const Out out, long long base0, const Fields fo) {
  __shared__ int counts[kMaxShards];
  __shared__ int warp_sums[kWarps];
  __shared__ int list[kStep];
  __shared__ uint8_t masks[kStep];
  const int me = blockIdx.x;
  // F's short CRC reads its syndromes from shared memory, loaded here so
  // that a miss of the constant cache overlaps the count below.
  const uint32_t* syn = nullptr;
  if constexpr (kF && kExtended) {
    __shared__ uint32_t short_syndromes[kShortBits];
    if (threadIdx.x < kShortBits) short_syndromes[threadIdx.x] = c_short_syndromes[threadIdx.x];
    syn = short_syndromes;
  }

  // The tile of rows this block ranks, if any: tile t is rows
  // (t % tiles) * kStep .. + kStep - 1 of shard t / tiles.
  const long long tiles = (k + kStep - 1) / kStep;
  const int shard = me < n_shards * tiles ? static_cast<int>(me / tiles) : -1;
  const long long r0 = shard < 0 ? 0 : (me % tiles) * kStep;

  // Every shard's selected rows, and those of this block's shard before its tile.
  int in_shard_before = 0;
  for (int s = 0; s < n_shards; ++s) {
    int before = 0;
    const long long split = s == shard ? r0 : 0;
    const Shard& sh = shards.s[s];
    const int sum = count_rows<kExtended>(sh, k, base0 + s * block, max_offset, split, warp_sums, &before);
    if (threadIdx.x == 0) counts[s] = sum;
    if (s == shard) in_shard_before = before;
  }
  __syncthreads();
  long long base = in_shard_before, total = 0;
  for (int s = 0; s < n_shards; ++s) {
    base += s < shard ? counts[s] : 0;
    total += counts[s];
  }

  // A tile's block: its selected rows, in slot order, at base + rank while
  // below C. A row past k loads row k - 1 and is masked, so that no branch
  // separates a thread's loads.
  if (shard >= 0) {
    const Shard& sh = shards.s[shard];
    const long long shard_base = base0 + shard * block;
    const int local = threadIdx.x * kRankRows;
    int m[kRankRows], n = 0;
#pragma unroll
    for (int j = 0; j < kRankRows; ++j) {
      const long long r = r0 + local + j;
      const int mask = row_mask<kExtended>(sh, k, r < k ? r : k - 1, shard_base, max_offset);
      m[j] = r < k ? mask : 0;
      n += m[j] != 0;
    }
    int chunk;
    int p = block_scan(n, warp_sums, &chunk);
#pragma unroll
    for (int j = 0; j < kRankRows; ++j) {
      if (m[j]) {
        list[p] = local + j;
        masks[p] = static_cast<uint8_t>(m[j]);
        ++p;
      }
    }
    __syncthreads();
    const long long room = c - base;
    const int n_out = room <= 0 ? 0 : room < chunk ? static_cast<int>(room) : chunk;
    copy_rows<kExtended, kR2, kF>(out, fo, syn, c, sh, r0, base, n_out, list, masks,
                                  static_cast<int32_t>(shard_base));
  }

  // The rows past the total are zero; the blocks share them. Under F a
  // warp's rows start on a 32-row boundary (whole sectors of each column).
  if constexpr (kF) {
    for (long long d = (total & ~31LL) + static_cast<long long>(me) * kThreads + threadIdx.x; d < c;
         d += static_cast<long long>(gridDim.x) * kThreads) {
      if (d >= total) zero_row<kExtended, kR2, kF>(out, fo, c, d);
    }
  } else {
    for (long long d = total + static_cast<long long>(me) * kThreads + threadIdx.x; d < c;
         d += static_cast<long long>(gridDim.x) * kThreads) {
      zero_row<kExtended, kR2, kF>(out, fo, c, d);
    }
  }

  // The scalars: a lane a shard, summed over the first warp.
  if (me == 0 && threadIdx.x < 32) {
    int n_det = 0, overflow = 0;
    for (int s = threadIdx.x; s < n_shards; s += 32) {
      n_det += __ldg(shards.s[s].n_det);
      overflow |= __ldg(shards.s[s].overflow) != 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      n_det += __shfl_down_sync(0xffffffffu, n_det, o);
      overflow |= __shfl_down_sync(0xffffffffu, overflow, o);
    }
    if (threadIdx.x == 0) {
      *out.n_rows = static_cast<int32_t>(total);
      *out.n_det = n_det;
      *out.overflow = overflow || total > c;
    }
  }
}

template <bool kExtended, bool kR2, bool kF>
void launch(const Shards& shards, int n_shards, long long k, long long c, long long block, long long max_offset,
            const Out& out, long long first_shard, const Fields& fo, cudaStream_t stream) {
  const long long tiles = n_shards * ((k + kStep - 1) / kStep);
  long long zero_blocks = (c + kZeroRows - 1) / kZeroRows;
  // Under F a zero row also writes its fields (105 or 166 B): more blocks
  // share them where a block's count of every shard's rows is cheap.
  if (kF && n_shards * k <= kCheapCount) zero_blocks = std::max(zero_blocks, (c + kZeroRowsF - 1) / kZeroRowsF);
  const long long blocks = tiles + (zero_blocks < kMaxZeroBlocks ? zero_blocks : kMaxZeroBlocks);
  const int grid = static_cast<int>(blocks > 0 ? blocks : 1);  // block 0 writes the scalars
  shard_gather_kernel<kExtended, kR2, kF><<<grid, kThreads, 0, stream>>>(shards, n_shards, k, c, block, max_offset,
                                                                          out, first_shard * block, fo);
}

template <bool kExtended, bool kR2>
void launch_f(const Shards& shards, int n_shards, long long k, long long c, long long block, long long max_offset,
              const Out& out, long long first_shard, const Fields& fo, cudaStream_t stream) {
  if (fo.ints != nullptr) {
    launch<kExtended, kR2, true>(shards, n_shards, k, c, block, max_offset, out, first_shard, fo, stream);
  } else {
    launch<kExtended, kR2, false>(shards, n_shards, k, c, block, max_offset, out, first_shard, fo, stream);
  }
}

}  // namespace

// Copies data bits 56..87's syndromes of the 88 (uint32, host memory) into
// c_short_syndromes on the current device.
int load_shard_gather_syndromes(const void* host) {
  cudaMemcpyToSymbol(c_short_syndromes, static_cast<const uint32_t*>(host) + 56, sizeof(c_short_syndromes));
  return static_cast<int>(cudaGetLastError());
}

// shard_ptrs: n_shards * 12 pointers, the fields of `Shard` in order for
// each shard; out_ptrs: the 12 pointers of `Out`. All on the current device.
// first_shard: the global index of the first shard (0 in one process).
// fields_ints, fields_bytes: flag F's outputs (`Fields`), or both null
// without F; F's extended short CRC reads the syndromes that
// airjax_load_syndromes loads.
extern "C" int airjax_shard_gather(const void* const* shard_ptrs, int n_shards, long long k, long long c,
                                   long long block, long long max_offset, void* const* out_ptrs, int extended,
                                   int recover2, long long first_shard, void* fields_ints, void* fields_bytes,
                                   void* stream) {
  if (n_shards < 1 || n_shards > kMaxShards || first_shard < 0) return static_cast<int>(cudaErrorInvalidValue);
  Shards shards = {};
  for (int s = 0; s < n_shards; ++s) {
    const void* const* p = shard_ptrs + 12 * s;
    shards.s[s] = Shard{static_cast<const int32_t*>(p[0]), static_cast<const uint8_t*>(p[1]),
                        static_cast<const uint8_t*>(p[2]), static_cast<const uint8_t*>(p[3]),
                        static_cast<const uint8_t*>(p[4]), static_cast<const uint8_t*>(p[5]),
                        static_cast<const int32_t*>(p[6]), static_cast<const int32_t*>(p[7]),
                        static_cast<const int32_t*>(p[8]), static_cast<const uint8_t*>(p[9]),
                        static_cast<const int32_t*>(p[10]), static_cast<const uint8_t*>(p[11])};
  }
  const Out out{static_cast<int32_t*>(out_ptrs[0]), static_cast<uint8_t*>(out_ptrs[1]),
                static_cast<uint8_t*>(out_ptrs[2]), static_cast<uint8_t*>(out_ptrs[3]),
                static_cast<uint8_t*>(out_ptrs[4]), static_cast<int32_t*>(out_ptrs[5]),
                static_cast<int32_t*>(out_ptrs[6]), static_cast<int32_t*>(out_ptrs[7]),
                static_cast<uint8_t*>(out_ptrs[8]), static_cast<int32_t*>(out_ptrs[9]),
                static_cast<int32_t*>(out_ptrs[10]), static_cast<uint8_t*>(out_ptrs[11])};
  const Fields fo{static_cast<int32_t*>(fields_ints), static_cast<uint8_t*>(fields_bytes)};
  if ((fo.ints == nullptr) != (fo.bytes == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (extended) {
    if (recover2) launch_f<true, true>(shards, n_shards, k, c, block, max_offset, out, first_shard, fo, s);
    else launch_f<true, false>(shards, n_shards, k, c, block, max_offset, out, first_shard, fo, s);
  } else {
    if (recover2) launch_f<false, true>(shards, n_shards, k, c, block, max_offset, out, first_shard, fo, s);
    else launch_f<false, false>(shards, n_shards, k, c, block, max_offset, out, first_shard, fo, s);
  }
  return static_cast<int>(cudaGetLastError());
}

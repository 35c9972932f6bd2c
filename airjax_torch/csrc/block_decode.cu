// Block-decode kernel: what the front kernel writes (detection bits,
// packed compares, detections per tile) -> the block's whole candidate
// dict, in one launch. The ordered compaction (csrc/compact.cu) and the
// candidate decode (csrc/candidate.cu) of one block, fused, with the dict's
// small ops folded in.
//
// No Pallas ancestor: on the TPU, XLA fuses airjax/dsp/demod.py::
// compact_detections (:87-126) with the candidate stage of
// airjax/pipeline.py::_decode_mags_common (:82-105, Mode::kDf17) or of
// decode_mags_block_extended (:200-270, Mode::kExtended, recover2=False).
// Its plain torch version is airjax_torch/kernels/block_decode.py::
// decode_block_bits_plain: compact_bits_plain, decode_candidates(_extended)
// _plain, then the dict ops. The staged chain compact.cu -> candidate.cu
// stays as its A/B baseline and second oracle.
//
// Inputs: det_words[w] bit 31-k = detection at offset 32w+k; words, the
// packed compares; tile_counts[t] = the set bits of det_words[256t ..
// 256t+255]. Per slot s < K (capacity):
//   slot of a detection = the prefix of its block's tiles (the counts of
//   the tiles before them) + its rank in them, ascending; detections at or
//   past K are counted, not written. A block whose prefix is below K may
//   run past K part-way through.
//   offsets[s] = the detection's offset, n_off for an empty slot; valid[s];
//   frames[s] = the decode at the offset, with the single-bit repair;
//   DF17: good = CRC ok && valid, recovered = repaired && valid;
//   extended: frames_raw, df, the long and short AP residuals, the six
//   classes (candidate.cuh).
//   An empty slot (s >= min(total, K)) carries the decode at offset 0, with
//   valid and every flag false, as airjax slices an invalid slot at offset
//   0 and leaves its frame unmasked.
// Per call: n_detections = the true total, overflow = total > K, and in
// the DF17 mode n_good.
//
// One block of 256 threads per 8 tiles (65,536 offsets), each thread owning
// 8 consecutive det words: 256 blocks at 2^24 offsets, one wave. The kernel
// is latency-bound: one block's chain of loads, barriers and the candidate
// decode sets its time, so a grid of one block per tile (2048 blocks in
// many waves) took 2.8x (DF17) to 4.5x (extended) as long (PERF.md).
// __launch_bounds__(256, 2) keeps it at 128 registers, one wave at 2^24
// offsets: capped at 80 (3 blocks a SM, spills to L1) it was slower in both
// modes, in every turn of an alternating A/B on the card.
// 1. The prefix without a scan launch: every block sums all the tile counts
//    (n_tiles / 256 loads a thread, 8 in flight: one round at 2^24 offsets,
//    in L2 right after the front), the ones before its first tile apart,
//    while its det words (two 16-byte loads a thread) are in flight. No
//    atomics decide a slot, so the result is the same in every run.
// 2. A block with detections and a prefix below K ranks them with a block
//    scan of __popc, stages its slots' offsets in shared memory, kStage at
//    a time (a block holds up to 65,536 detections), and decodes them
//    there, one candidate per thread, striding: the offsets never reach
//    HBM.
// 3. The empty slots are spread over the whole grid; a thread with one
//    decodes offset 0 once and writes it to each.
// 4. n_good: each block adds its good count to an integer accumulator
//    (exact in any order), then takes a ticket; the last block of the
//    launch copies the sum out and resets both, so no memset is needed.
//    The accumulator and ticket are per device, so the kernel must not run
//    on two streams of one device at once; the wrappers launch it on
//    PyTorch's current stream.
//
// Bound: memory traffic, one bit per offset and the counts in, 32 B of
// compares gathered per slot, and the dict out (21 B per slot in the DF17
// mode, 51 B extended): 2.2 MB, 0.66 us at 2^24 offsets and K = 2048. The
// sum of all counts in every block costs 8 KB of L2 reads a block at 2^24
// offsets; it grows with n_off squared, and stays cheap to ~2^25 offsets.

#include <cuda_runtime.h>
#include <stdint.h>

#include "candidate.cuh"

namespace {

constexpr int kTile = 8192;                // offsets per tile count, as csrc/front.cu
constexpr int kTilesPerBlock = 8;
constexpr int kSpanWords = kTile * kTilesPerBlock / 32;  // det words per block: 2048
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerThread = kSpanWords / kThreads;  // 8 consecutive det words, two 16-byte loads
constexpr int kBatch = 8;                  // tile counts in flight per thread
constexpr int kStage = 1024;               // slot offsets staged in shared memory per round
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(kWordsPerThread == 8, "two uint4 loads per thread");

enum class Mode : int { kDf17 = 0, kExtended = 1 };

struct Out {
  int32_t* offsets;       // (K,)
  bool* valid;            // (K,)
  uint8_t* frames;        // (K, 14)
  int32_t* n_detections;  // ()
  bool* overflow;         // ()
  // Mode::kDf17
  bool* good;             // (K,)
  bool* recovered;        // (K,)
  int32_t* n_good;        // ()
  // Mode::kExtended
  uint8_t* frames_raw;    // (K, 14)
  int32_t* df;            // (K,)
  int32_t* icao_long;     // (K,)
  int32_t* icao_short;    // (K,)
  bool* classes;          // (kClasses, K)
};

__device__ unsigned g_ticket = 0;  // blocks of the running launch that are done
__device__ int g_good = 0;         // good slots of the running launch

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The block-wide sums of x, y and z (every thread gets all three). Called
// by the whole block.
__device__ __forceinline__ int3 block_sum3(int x, int y, int z) {
  __shared__ int3 part[kWarps];
  x = __reduce_add_sync(kFull, x);
  y = __reduce_add_sync(kFull, y);
  z = __reduce_add_sync(kFull, z);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_int3(x, y, z);
  __syncthreads();
  int3 s = make_int3(0, 0, 0);
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    s.x += part[k].x;
    s.y += part[k].y;
    s.z += part[k].z;
  }
  __syncthreads();  // part is rewritten by the next call
  return s;
}

// Writes candidate c, sliced at `offset`, into slot s, repairing it first
// unless `repaired`; returns whether it is good (the DF17 mode's count).
template <Mode M>
__device__ __forceinline__ bool store_slot(Candidate c, bool repaired, int offset, bool valid, long long s,
                                           long long n_off, long long capacity, const Out& out) {
  if constexpr (M == Mode::kDf17) {
    if (!repaired) repair(c);
    out.offsets[s] = valid ? offset : static_cast<int32_t>(n_off);
    out.valid[s] = valid;
    store_frame(out.frames + s * kFrameBytes, c.h, c.flip);
    const bool good = crc_ok(c) && valid;
    out.good[s] = good;
    out.recovered[s] = c.flip >= 0 && valid;
    return good;
  } else {
    out.offsets[s] = valid ? offset : static_cast<int32_t>(n_off);
    out.valid[s] = valid;
    const int df = frame_df(c);
    store_frame(out.frames_raw + s * kFrameBytes, c.h, -1);
    out.df[s] = df;
    out.icao_long[s] = static_cast<int32_t>(c.delta);
    const uint32_t icao_short = short_residual(c);
    out.icao_short[s] = static_cast<int32_t>(icao_short);
    if (!repaired) repair(c);
    store_frame(out.frames + s * kFrameBytes, c.h, c.flip);
    store_classes(out.classes, capacity, s, c, df, icao_short, valid);
    return false;
  }
}

template <Mode M>
__global__ void __launch_bounds__(kThreads, 2)
block_decode_kernel(const uint32_t* __restrict__ det_words, const uint32_t* __restrict__ words,
                    long long n_words, const int* __restrict__ counts, long long n_off,
                    long long capacity, Out out) {
  __shared__ int staged[kStage];
  __shared__ int warp_incl[kWarps];
  const long long b = blockIdx.x;
  const long long n_tiles = (n_off + kTile - 1) / kTile;
  const long long n_det_words = (n_off + 31) / 32;
  const long long first_tile = b * kTilesPerBlock;

  // This thread's 8 det words (offsets 32 w0 .. 32 w0 + 255), loaded
  // before the counts so that both are in flight together.
  const long long w0 = b * kSpanWords + kWordsPerThread * threadIdx.x;
  uint32_t bits[kWordsPerThread];
  if (w0 + kWordsPerThread <= n_det_words) {
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(det_words + w0));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(det_words + w0) + 1);
    bits[0] = lo.x, bits[1] = lo.y, bits[2] = lo.z, bits[3] = lo.w;
    bits[4] = hi.x, bits[5] = hi.y, bits[6] = hi.z, bits[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j) bits[j] = w0 + j < n_det_words ? __ldg(det_words + w0 + j) : 0u;
  }

  // 1. The counts: before this block's tiles (its prefix), its own, and
  //    all of them (the total), kBatch loads in flight per thread.
  int before = 0, mine = 0, total = 0;
  for (long long base = 0; base < n_tiles; base += kBatch * kThreads) {
    int v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const long long k = base + i * kThreads + threadIdx.x;
      v[i] = k < n_tiles ? __ldg(counts + k) : 0;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const long long k = base + i * kThreads + threadIdx.x;
      total += v[i];
      if (k < first_tile) before += v[i];
      else if (k < first_tile + kTilesPerBlock) mine += v[i];
    }
  }
  const int3 sums = block_sum3(before, mine, total);
  before = sums.x;
  mine = sums.y;
  total = sums.z;

  // 2. This block's detections, ranked and decoded where they are found.
  //    Every condition is the same in the whole block.
  int good = 0;
  const bool active = mine > 0 && before < capacity;
  if (active) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j) c += __popc(bits[j]);
    const int incl = warp_inclusive_scan(c);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 31) warp_incl[warp] = incl;
    __syncthreads();
    int rank0 = incl - c;  // the rank of this thread's first detection in the block
    for (int k = 0; k < warp; ++k) rank0 += warp_incl[k];
    const long long room = capacity - before;
    const int take = mine < room ? mine : static_cast<int>(room);
    for (int r0 = 0; r0 < take; r0 += kStage) {
      // Stage the offsets of ranks r0 .. r_end - 1.
      const int r_end = r0 + kStage < take ? r0 + kStage : take;
      if (rank0 < r_end && rank0 + c > r0) {
        int r = rank0;
#pragma unroll
        for (int j = 0; j < kWordsPerThread; ++j) {
          uint32_t x = bits[j];
          for (; x != 0 && r < r_end; ++r) {
            const int k = __clz(x);
            if (r >= r0) staged[r - r0] = static_cast<int>(32 * (w0 + j) + k);
            x ^= 0x80000000u >> k;
          }
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < r_end - r0; i += kThreads) {
        const int o = staged[i];
        good += store_slot<M>(slice_candidate(words, n_words, o), false, o, true, before + r0 + i, n_off, capacity,
                              out);
      }
      __syncthreads();  // staged is rewritten next round
    }
  }

  // 3. The empty slots min(total, K) .. K - 1, spread over the whole grid:
  //    the decode at offset 0, once per thread.
  const long long first_empty = total < capacity ? total : capacity;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long s = first_empty + b * kThreads + threadIdx.x;
  if (s < capacity) {
    Candidate c0 = slice_candidate(words, n_words, 0);
    repair(c0);
    for (; s < capacity; s += stride) store_slot<M>(c0, true, 0, false, s, n_off, capacity, out);
  }
  if (b == 0 && threadIdx.x == 0) {
    *out.n_detections = total;
    *out.overflow = total > capacity;
  }

  if constexpr (M == Mode::kDf17) {
    // 4. n_good: the accumulator and the last block's ticket.
    const int block_good = active ? block_sum3(good, 0, 0).x : 0;
    if (threadIdx.x == 0) {
      if (block_good != 0) atomicAdd(&g_good, block_good);
      __threadfence();
      if (atomicAdd(&g_ticket, 1u) == gridDim.x - 1) {
        *out.n_good = atomicExch(&g_good, 0);
        atomicExch(&g_ticket, 0u);
      }
    }
  }
}

}  // namespace

int load_block_decode_syndromes(const void* host) { return load_syndromes(host); }

// det_words: (ceil(n_off/32),) u32, 16-byte aligned; words: (n_words,) u32 packed compares;
// tile_counts: (ceil(n_off/kTile),) i32; capacity K >= 0. Outputs as in
// struct Out: offsets (K,) i32, valid (K,) bool, frames (K, 14) u8,
// n_detections () i32, overflow () bool; mode 0 (DF17): good, recovered
// (K,) bool, n_good () i32, and the extended outputs null; mode 1
// (extended): frames_raw (K, 14) u8, df, icao_long, icao_short (K,) i32,
// classes (6, K) bool (enum Class), and good, recovered, n_good null.
extern "C" int airjax_block_decode(const void* det_words, const void* words, long long n_words,
                                   const void* tile_counts, long long n_off, long long capacity,
                                   void* offsets, void* valid, void* frames, void* n_detections,
                                   void* overflow, void* good, void* recovered, void* n_good,
                                   void* frames_raw, void* df, void* icao_long, void* icao_short,
                                   void* classes, int mode, void* stream) {
  const long long n_tiles = (n_off + kTile - 1) / kTile;
  long long blocks = (n_tiles + kTilesPerBlock - 1) / kTilesPerBlock;
  if (blocks == 0) blocks = 1;  // block 0 writes n_detections and overflow
  const auto grid = static_cast<unsigned>(blocks);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint32_t*>(det_words);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* t = static_cast<const int*>(tile_counts);
  const Out out{static_cast<int32_t*>(offsets), static_cast<bool*>(valid), static_cast<uint8_t*>(frames),
                static_cast<int32_t*>(n_detections), static_cast<bool*>(overflow), static_cast<bool*>(good),
                static_cast<bool*>(recovered), static_cast<int32_t*>(n_good), static_cast<uint8_t*>(frames_raw),
                static_cast<int32_t*>(df), static_cast<int32_t*>(icao_long), static_cast<int32_t*>(icao_short),
                static_cast<bool*>(classes)};
  if (mode == static_cast<int>(Mode::kExtended)) {
    block_decode_kernel<Mode::kExtended><<<grid, kThreads, 0, s>>>(d, w, n_words, t, n_off, capacity, out);
  } else {
    block_decode_kernel<Mode::kDf17><<<grid, kThreads, 0, s>>>(d, w, n_words, t, n_off, capacity, out);
  }
  return static_cast<int>(cudaGetLastError());
}

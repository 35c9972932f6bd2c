// Ordered compaction of the detection bits: det words + tile counts ->
// ascending candidate offsets, capped at capacity K.
//
// Replaces airjax/dsp/demod.py::compact_detections (:87-126), which XLA
// fused on the TPU (no Pallas ancestor). Its plain torch version is
// airjax_torch/kernels/compact.py::compact_bits_plain (unpack, then
// dsp/demod.py::compact_detections). The inputs are what csrc/front.cu
// writes: det_words[w] bit 31-k = detection at offset 32w+k, and
// tile_counts[t] = the set bits of det_words[256t .. 256t+255].
//
//   offsets[s] = the s-th detection in ascending order, n_off when s >= total
//   gather[s]  = offsets[s], 0 when s >= total (the candidate kernel's
//                in-range offset for an empty slot: torch.where folded in)
//   valid[s]   = s < total;  n_det = total, every detection counted
//
// Two launches:
// 1. compact_scan_kernel, one block of 1024 threads: the exclusive scan of
//    the tile counts into prefix[], and the total. Rounds of 4 counts per
//    thread (a warp scan of the thread sums, then one of the warp sums);
//    the loads of 4 rounds are issued together.
// 2. compact_scatter_kernel: one block per tile of 256 det words. A tile
//    with detections whose prefix is below K ranks its words with a block
//    scan of __popc (per warp, then over the 8 warp sums), and each thread
//    writes its set bits' offsets, MSB first, to prefix + rank onwards,
//    stopping at K. Every thread also settles one slot: valid, and for
//    slots at or past the total the empty offsets.
// No atomics: the result is deterministic.
//
// Bound: memory traffic. It must read one bit per offset (n_off/8 B) and
// the counts, and write 9 B per slot: 2.2 MB, 0.7 us at 2^24 offsets and
// K = 2048. A tile without detections costs its block two loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8192;  // offsets per tile count, as csrc/front.cu
constexpr int kScanThreads = 1024;
constexpr int kItems = 4;    // counts per thread per round
constexpr int kRound = kScanThreads * kItems;
constexpr int kRounds = 4;   // rounds whose loads are issued together
constexpr long long kChunk = static_cast<long long>(kRound) * kRounds;
constexpr int kScatterThreads = kTile / 32;  // one thread per det word of a tile
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kScanThreads)
compact_scan_kernel(const int* __restrict__ counts, long long n_tiles,
                    int* __restrict__ prefix, int* __restrict__ total) {
  __shared__ int warp_excl[kScanThreads / 32];
  __shared__ int round_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;  // the same in every thread
  for (long long base = 0; base < n_tiles; base += kChunk) {  // one chunk at 2^27 offsets
    // Every load of the chunk first (coalesced: round r, thread t reads
    // kItems counts from base + kRound r + kItems t), then one block scan
    // per round.
    int v[kRounds][kItems];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const long long k = base + r * kRound + kItems * threadIdx.x + i;
        v[r][i] = k < n_tiles ? counts[k] : 0;
      }
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (base + r * kRound >= n_tiles) break;  // the same in every thread
      int sum = 0;
#pragma unroll
      for (int i = 0; i < kItems; ++i) sum += v[r][i];
      const int incl = warp_inclusive_scan(sum);
      if (lane == 31) warp_excl[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int x = warp_excl[lane];
        const int xi = warp_inclusive_scan(x);
        warp_excl[lane] = xi - x;
        if (lane == 31) round_total = xi;
      }
      __syncthreads();
      int run = carry + warp_excl[warp] + incl - sum;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const long long k = base + r * kRound + kItems * threadIdx.x + i;
        if (k < n_tiles) prefix[k] = run;
        run += v[r][i];
      }
      carry += round_total;
      __syncthreads();  // warp_excl and round_total are rewritten next round
    }
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kScatterThreads)
compact_scatter_kernel(const uint32_t* __restrict__ det_words, long long n_off,
                       const int* __restrict__ counts, const int* __restrict__ prefix,
                       const int* __restrict__ total, long long capacity,
                       int* __restrict__ offsets, bool* __restrict__ valid,
                       int* __restrict__ gather) {
  __shared__ int warp_excl[kScatterThreads / 32];
  const long long t = static_cast<long long>(blockIdx.x) * kScatterThreads + threadIdx.x;
  const long long tile = blockIdx.x;
  if (tile < (n_off + kTile - 1) / kTile) {  // the same in the whole block
    const int first = prefix[tile];
    if (counts[tile] > 0 && first < capacity) {
      const long long w = t;  // tile * kScatterThreads + thread
      uint32_t bits = w < (n_off + 31) / 32 ? det_words[w] : 0u;
      const int c = __popc(bits);
      const int incl = warp_inclusive_scan(c);
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 31) warp_excl[warp] = incl;
      __syncthreads();
      int before = 0;
      for (int k = 0; k < warp; ++k) before += warp_excl[k];
      long long slot = first + before + incl - c;
      while (bits != 0 && slot < capacity) {
        const int k = __clz(bits);
        const int o = static_cast<int>(32 * w + k);
        offsets[slot] = o;
        gather[slot] = o;
        bits ^= 0x80000000u >> k;
        ++slot;
      }
    }
  }
  if (t < capacity) {
    const bool ok = t < *total;
    valid[t] = ok;
    if (!ok) {
      offsets[t] = static_cast<int>(n_off);
      gather[t] = 0;
    }
  }
}

}  // namespace

// det_words: (ceil(n_off/32),) u32; tile_counts and prefix (scratch):
// (ceil(n_off/kTile),) i32; offsets, gather: (capacity,) i32; valid:
// (capacity,) bool; n_det: () i32.
extern "C" int airjax_compact(const void* det_words, const void* tile_counts, long long n_off,
                              long long capacity, void* prefix, void* offsets, void* valid,
                              void* gather, void* n_det, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (n_off + kTile - 1) / kTile;
  const auto* counts = static_cast<const int*>(tile_counts);
  auto* pre = static_cast<int*>(prefix);
  auto* total = static_cast<int*>(n_det);
  compact_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, n_tiles, pre, total);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = kScatterThreads * n_tiles > capacity ? kScatterThreads * n_tiles : capacity;
  const long long blocks = (threads + kScatterThreads - 1) / kScatterThreads;
  if (blocks == 0) return 0;
  compact_scatter_kernel<<<static_cast<unsigned>(blocks), kScatterThreads, 0, s>>>(
      static_cast<const uint32_t*>(det_words), n_off, counts, pre, total, capacity,
      static_cast<int*>(offsets), static_cast<bool*>(valid), static_cast<int*>(gather));
  return static_cast<int>(cudaGetLastError());
}

// Stand-ins for the CUDA built-ins that csrc/shard_gather.cu (and the
// header it includes, csrc/fields.cuh) and csrc/planes.cu (with
// csrc/magnitude.cuh) use, so that
// their sources compile with a host C++20 compiler and run on the CPU, on one
// host thread: a CUDA thread is a fiber (ucontext) with a stack of its own,
// the blocks run one after another, __syncthreads is a barrier of the block
// and the warp shuffles an exchange through a barrier of the warp (every
// lane of a warp that calls one calls it together, as in that kernel). A
// fiber runs until it waits at a barrier or ends; the scheduler resumes, in
// turn, each fiber whose barrier has filled. Every barrier a block still
// waits at with none of its fibers able to go on aborts the process.
// tests/test_torch_shard_gather_source.py and tests/test_torch_planes_source.py
// turn the kernel's `<<<grid, kThreads, 0, stream>>>` launch into
// emulate(grid, kThreads, ...). The SIMD intrinsics follow their PTX
// definitions (vmin2/vmax2/vset2 on signed halves), __byte_perm CUDA's
// (prmt on the low 3 bits of each selector nibble);
// tests/test_torch_planes_source.py holds each to them.
#pragma once
#include <stdint.h>
#include <stdio.h>
#include <math.h>
#include <stdlib.h>
#include <string.h>
#include <ucontext.h>

#include <algorithm>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __constant__

struct uchar4 {
  unsigned char x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return uint4{x, y, z, w}; }

// The signed 16-bit halves of a word: op on each, the results' halves
// put back in place.
template <class Op>
unsigned emu_halves(unsigned a, unsigned b, Op op) {
  unsigned out = 0;
  for (int h = 0; h < 2; ++h) {
    const int x = static_cast<int16_t>(a >> (16 * h)), y = static_cast<int16_t>(b >> (16 * h));
    out |= (static_cast<unsigned>(op(x, y)) & 0xFFFFu) << (16 * h);
  }
  return out;
}
inline unsigned __vmins2(unsigned a, unsigned b) { return emu_halves(a, b, [](int x, int y) { return x < y ? x : y; }); }
inline unsigned __vmaxs2(unsigned a, unsigned b) { return emu_halves(a, b, [](int x, int y) { return x > y ? x : y; }); }
inline unsigned __vcmpges2(unsigned a, unsigned b) { return emu_halves(a, b, [](int x, int y) { return x >= y ? 0xFFFF : 0; }); }
inline unsigned __vcmpgts2(unsigned a, unsigned b) { return emu_halves(a, b, [](int x, int y) { return x > y ? 0xFFFF : 0; }); }
// Byte n of the result: byte (s >> 4n) & 7 of the 8 bytes {y, x}, x the low four.
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long xy = static_cast<unsigned long long>(y) << 32 | x;
  unsigned out = 0;
  for (int n = 0; n < 4; ++n) out |= static_cast<unsigned>(xy >> (8 * ((s >> (4 * n)) & 7)) & 0xFF) << (8 * n);
  return out;
}

struct EmuDim {
  unsigned x = 0, y = 0, z = 0;
};
inline EmuDim threadIdx, blockIdx, gridDim;  // threadIdx: the running fiber's

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }
template <class T>
int cudaMemcpyToSymbol(T& symbol, const void* src, size_t n) {
  memcpy(&symbol, src, n);
  return cudaSuccess;
}

struct EmuBarrier {
  int expected = 0, arrived = 0;
  long long generation = 0;
};

struct EmuFiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  const EmuBarrier* waiting = nullptr;  // the barrier it waits at, and its generation then
  long long generation = 0;
  bool done = false;
};

inline ucontext_t emu_scheduler;
inline EmuFiber* emu_fibers;
inline int emu_current;
inline const std::function<void()>* emu_body;
inline EmuBarrier emu_block_barrier;
inline EmuBarrier emu_warp_barriers[64];
inline long long emu_exchange[64][32];

inline void emu_wait(EmuBarrier& b) {
  if (++b.arrived == b.expected) {
    b.arrived = 0;
    ++b.generation;
    return;
  }
  EmuFiber& f = emu_fibers[emu_current];
  f.waiting = &b;
  f.generation = b.generation;
  swapcontext(&f.ctx, &emu_scheduler);
}

inline void __syncthreads() { emu_wait(emu_block_barrier); }

template <class T>
T emu_shuffle(T v, int src_lane) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  emu_exchange[warp][lane] = static_cast<long long>(v);
  emu_wait(emu_warp_barriers[warp]);
  const T out = src_lane >= 0 && src_lane < 32 ? static_cast<T>(emu_exchange[warp][src_lane]) : v;
  emu_wait(emu_warp_barriers[warp]);
  return out;
}
template <class T>
T __shfl_up_sync(unsigned, T v, int delta) { return emu_shuffle(v, static_cast<int>(threadIdx.x % 32) - delta); }
template <class T>
T __shfl_down_sync(unsigned, T v, int delta) { return emu_shuffle(v, static_cast<int>(threadIdx.x % 32) + delta); }
template <class T>
T __ldg(const T* p) { return *p; }
// A 16-byte load from an address that is not 16-byte aligned faults on the
// card; here it aborts.
inline uint4 __ldg(const uint4* p) {
  if (reinterpret_cast<uintptr_t>(p) % 16) {
    fprintf(stderr, "__ldg: a 16-byte load from the misaligned address %p\n", static_cast<const void*>(p));
    abort();
  }
  return *p;
}
using std::max;
using std::min;

inline void emu_entry() {
  (*emu_body)();
  emu_fibers[emu_current].done = true;
  swapcontext(&emu_fibers[emu_current].ctx, &emu_scheduler);
}

inline void emulate(int grid, int threads, const std::function<void()>& body) {
  constexpr size_t kStack = 64 << 10;
  gridDim.x = grid;
  emu_body = &body;
  std::vector<EmuFiber> fibers(threads);
  for (auto& f : fibers) f.stack.reset(new char[kStack]);
  emu_fibers = fibers.data();
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    emu_block_barrier = EmuBarrier{threads};
    for (int w = 0; w < threads / 32; ++w) emu_warp_barriers[w] = EmuBarrier{32};
    for (auto& f : fibers) {
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.get();
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, emu_entry, 0);
      f.waiting = nullptr;
      f.done = false;
    }
    for (int left = threads; left > 0;) {
      bool ran = false;
      for (int t = 0; t < threads; ++t) {
        EmuFiber& f = fibers[t];
        if (f.done || (f.waiting && f.waiting->generation == f.generation)) continue;
        f.waiting = nullptr;
        emu_current = t;
        threadIdx.x = t;
        ran = true;
        swapcontext(&emu_scheduler, &f.ctx);
        left -= f.done;
      }
      if (!ran) {
        fprintf(stderr, "emulate: block %d waits at a barrier that no fiber can fill\n", b);
        abort();
      }
    }
  }
}

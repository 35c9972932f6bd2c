// Stand-ins for the CUDA built-ins that csrc/shard_gather.cu uses, so that
// its source compiles with a host C++20 compiler and runs on the CPU, on one
// host thread: a CUDA thread is a fiber (ucontext) with a stack of its own,
// the blocks run one after another, __syncthreads is a barrier of the block
// and the warp shuffles an exchange through a barrier of the warp (every
// lane of a warp that calls one calls it together, as in that kernel). A
// fiber runs until it waits at a barrier or ends; the scheduler resumes, in
// turn, each fiber whose barrier has filled. Every barrier a block still
// waits at with none of its fibers able to go on aborts the process.
// tests/test_torch_shard_gather_source.py turns the kernel's
// `<<<grid, kThreads, 0, stream>>>` launch into emulate(grid, kThreads, ...).
#pragma once
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
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

struct EmuDim {
  unsigned x = 0, y = 0, z = 0;
};
inline EmuDim threadIdx, blockIdx, gridDim;  // threadIdx: the running fiber's

typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

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

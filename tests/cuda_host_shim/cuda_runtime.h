// Host stand-in for the few CUDA names the kernel sources use, so that
// their arithmetic can be compiled with a C++ compiler and run on the CPU.
//
// By default one thread at a time: a kernel with block barriers is
// emulated with a block of ONE thread (its loops stride over all the
// work), and a team of lanes with a team of ONE lane (LR_TEAM=1: every
// shuffle, ballot and warp barrier is the identity). Compiled with
// -DEMU_THREADS=1, the threads of a block run concurrently (std::thread):
// __syncthreads is a barrier of the block, __syncwarp one of the thread's
// warp (threads EMU_WARP w .. EMU_WARP (w + 1) - 1; EMU_WARP is 32 unless
// a build sets a smaller warp to run fewer host threads), and shuffles and
// ballots exchange within the warp through its barrier, so every thread of
// a warp must make the same sequence of them. A barrier that some thread
// never reaches aborts after a timeout instead of hanging.
#pragma once
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <stddef.h>
#include <vector>
#ifndef EMU_WARP
#define EMU_WARP 32
#endif
#if EMU_THREADS
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>
#endif
#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#define __restrict__
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))
#define __ldg(p) (*(p))
struct EmuIdx { int x; };
static EmuIdx blockIdx, blockDim;
static thread_local EmuIdx threadIdx;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaMemcpyHostToDevice = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
#define cudaMemcpyToSymbolAsync(sym, src, n, off, kind, stream) \
  (memcpy((char*)&(sym) + (off), (src), (n)), 0)
#define cudaFuncSetAttribute(fn, attr, value) 0
static inline int cudaGetLastError() { return 0; }
static inline int __popc(unsigned x) { return __builtin_popcount(x); }
static inline int __ffs(int x) { return __builtin_ffs(x); }

// the block's dynamic shared memory: one buffer, sized at each launch
static std::vector<unsigned char> emu_smem_buffer;
static unsigned char* emu_dynamic_smem = nullptr;
#define DYNAMIC_SMEM(name) static unsigned char*& name = emu_dynamic_smem

// the bulk asynchronous copy and its mbarrier: a copy at once
static inline void mbar_init(uint64_t*) {}
static inline void bulk_copy_to_shared(void* dst, const void* src,
                                       unsigned bytes, uint64_t*) {
  memcpy(dst, src, bytes);
}
static inline void mbar_wait(uint64_t*) {}

#if EMU_THREADS
// one barrier for the threads of the running block
struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int count = 0, waiting = 0;
  unsigned long generation = 0;
  void arrive_and_wait() {
    std::unique_lock<std::mutex> lock(m);
    const unsigned long gen = generation;
    if (++waiting == count) {
      waiting = 0;
      ++generation;
      cv.notify_all();
      return;
    }
    if (!cv.wait_for(lock, std::chrono::seconds(20),
                     [&] { return generation != gen; })) {
      fprintf(stderr, "cuda host shim: a barrier was not reached by every "
                      "thread of the block (thread %d)\n", threadIdx.x);
      abort();
    }
  }
};
static EmuBarrier emu_barrier;            // the block's
static EmuBarrier emu_warp_barrier[1024 / EMU_WARP];   // each warp's
static double emu_slots[1024];
#define __syncthreads() emu_barrier.arrive_and_wait()
#define __syncwarp(...) emu_warp_barrier[threadIdx.x / EMU_WARP].arrive_and_wait()
template <class T>
static T emu_exchange(T v, int src) {
  emu_slots[threadIdx.x] = (double)v;
  emu_warp_barrier[threadIdx.x / EMU_WARP].arrive_and_wait();
  const T out = (T)emu_slots[src];
  emu_warp_barrier[threadIdx.x / EMU_WARP].arrive_and_wait();
  return out;
}
template <class T>
static T __shfl_xor_sync(unsigned, T v, int m, int w = 32) {
  const int l = threadIdx.x % w, base = threadIdx.x - l;
  return emu_exchange(v, base + ((l ^ m) % w));
}
template <class T>
static T __shfl_up_sync(unsigned, T v, int d, int w = 32) {
  const int l = threadIdx.x % w, base = threadIdx.x - l;
  return emu_exchange(v, base + (l >= d ? l - d : l));
}
template <class T>
static T __shfl_sync(unsigned, T v, int src, int w = 32) {
  return emu_exchange(v, threadIdx.x - threadIdx.x % w + src % w);
}
static unsigned __ballot_sync(unsigned, bool p) {
  const int base = threadIdx.x - threadIdx.x % EMU_WARP;
  const int n = blockDim.x - base < EMU_WARP ? blockDim.x - base : EMU_WARP;
  emu_slots[threadIdx.x] = p ? 1.0 : 0.0;
  emu_warp_barrier[threadIdx.x / EMU_WARP].arrive_and_wait();
  unsigned bits = 0;
  for (int i = 0; i < n; ++i)
    if (emu_slots[base + i] != 0.0) bits |= 1u << i;
  emu_warp_barrier[threadIdx.x / EMU_WARP].arrive_and_wait();
  return bits;
}
#define EMU_LAUNCH(kernel, grid, block, smem, ...)                \
  do {                                                            \
    blockDim.x = (block);                                         \
    emu_smem_buffer.assign((size_t)(smem) + 16, 0);               \
    emu_dynamic_smem = emu_smem_buffer.data();                    \
    emu_barrier.count = (block);                                  \
    for (int w_ = 0; w_ * EMU_WARP < (block); ++w_)               \
      emu_warp_barrier[w_].count = (block) - EMU_WARP * w_ < EMU_WARP \
                                       ? (block) - EMU_WARP * w_  \
                                       : EMU_WARP;                \
    for (int b_ = 0; b_ < (grid); ++b_) {                         \
      blockIdx.x = b_;                                            \
      std::vector<std::thread> ts_;                               \
      for (int t_ = 0; t_ < (block); ++t_)                        \
        ts_.emplace_back([&, t_] {                                \
          threadIdx.x = t_;                                       \
          kernel(__VA_ARGS__);                                    \
        });                                                       \
      for (auto& th_ : ts_) th_.join();                           \
    }                                                             \
  } while (0)
#else
#define __syncthreads()
#define __syncwarp(...)
template <class T>
static T __shfl_xor_sync(unsigned, T v, int, int = 32) { return v; }
template <class T>
static T __shfl_up_sync(unsigned, T v, int, int = 32) { return v; }
template <class T>
static T __shfl_sync(unsigned, T v, int, int = 32) { return v; }
static inline unsigned __ballot_sync(unsigned, bool p) {
  return p ? 1u << (threadIdx.x % 32) : 0u;
}
#define EMU_LAUNCH(kernel, grid, block, smem, ...)             \
  do {                                                         \
    blockDim.x = (block);                                      \
    emu_smem_buffer.assign((size_t)(smem) + 16, 0);            \
    emu_dynamic_smem = emu_smem_buffer.data();                 \
    for (int b_ = 0; b_ < (grid); ++b_)                        \
      for (int t_ = 0; t_ < (block); ++t_) {                   \
        blockIdx.x = b_; threadIdx.x = t_;                     \
        kernel(__VA_ARGS__);                                   \
      }                                                        \
  } while (0)
#endif

// Host stand-in for the few CUDA names lane_rollout.cu uses, so that its
// arithmetic can be compiled with a C++ compiler and run on the CPU.
#pragma once
#include <math.h>
#include <string.h>
#include <stddef.h>
#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
struct EmuIdx { int x; };
static EmuIdx blockIdx, blockDim, threadIdx;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaMemcpyHostToDevice = 1 };
#define cudaMemcpyToSymbolAsync(sym, src, n, off, kind, stream) \
  (memcpy((void*)&(sym), (src), (n)), 0)
static inline int cudaGetLastError() { return 0; }
#define EMU_LAUNCH(kernel, grid, block, ...)             \
  do {                                                   \
    blockDim.x = (block);                                \
    for (int b_ = 0; b_ < (grid); ++b_)                  \
      for (int t_ = 0; t_ < (block); ++t_) {             \
        blockIdx.x = b_; threadIdx.x = t_;               \
        kernel(__VA_ARGS__);                             \
      }                                                  \
  } while (0)

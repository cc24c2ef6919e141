// Residual header for kernels built without an in-kernel task residual
// (NR == 0): an empty constant block and a no-op device function.
#pragma once

struct TaskConst {
  int unused[1];
};

__device__ __forceinline__ void task_residual(const StepCtx& c,
                                              const TaskConst& tc,
                                              float* res) {}

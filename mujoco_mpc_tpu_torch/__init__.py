"""PyTorch/CUDA port of the predictive-control framework.

Second package beside the JAX one: same module layout and names, plain
PyTorch tensors for array code, hand-written CUDA C++ (ops/csrc) for the
kernels. Everything is float32; matrix products keep full float32
precision (TF32 is switched off here, once, for the whole process).
Entry points take an explicit `device` (default "cuda") and raise when it
is not available — they never carry on silently on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

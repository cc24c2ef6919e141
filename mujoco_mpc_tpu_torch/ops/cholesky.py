"""Batched SPD solve with the batch on the last axis, as one CUDA kernel
launch.

Replaces the TPU kernel `mujoco_mpc_tpu/ops/cholesky.py:chol_solve_lanes`
(Pallas): A (n, n, K), b (n, K) -> x (n, K) with A[..., k] x[:, k] =
b[:, k]; an unrolled Cholesky factorisation whose diagonal is clamped at
1e-10 before the square root, then two triangular solves. The kernel
(ops/csrc/chol_solve_lanes.cu) runs one thread per system, the factor in
registers, neighbouring threads on neighbouring systems so that every
global load and store is coalesced (see the note at the top of the
source).

One known difference from the Pallas kernel: each pivot is inverted once
and multiplied with, where the Pallas kernel divides by it; the plain
version below does what the kernel does. Where a matrix is not positive
definite the clamp gives a finite (wrong) answer, while the library
Cholesky of the pipeline physics' other route (physics/smooth.py) gives
NaN: the two routes differ there by design.

`chol_solve_lanes_plain` is the plain PyTorch version (CPU tensors, the
tests, the on-card comparison); on CUDA tensors `chol_solve_lanes` launches
the kernel or raises. `spd_solve(a (n, n), b (n,))` is the entry point for
code that `torch.func.vmap` traces (the batched pipeline rollouts): a
`torch.autograd.Function` whose vmap rule folds every vmapped dimension
into the lane axis, so one launch serves the whole batch.
"""

from __future__ import annotations

import ctypes

import torch

from mujoco_mpc_tpu_torch.ops import _build, launches

EPS = 1e-10
MAX_N = 32          # the kernel's gate: systems of 1 .. 32 unknowns
BLOCK = 128         # threads (one a system) a block

# launches of the CUDA kernel made by any wrapper of this module, counted
# where a wrapper launches and nowhere else (ops/launches.py): eager ones
# here, those replayed from a CUDA graph on the device
launch_count = 0
replay_counts = {}

_LIBS = {}


def supports(n: int) -> bool:
  return 1 <= n <= MAX_N


def build_defines(n: int) -> dict:
  """Compile-time sizes: n and the threads a block."""
  return dict(CS_N=n, CS_BLOCK=BLOCK)


def layout(n: int) -> dict:
  """The launch of the library for n: one thread a system, BLOCK threads
  (systems) a block, no shared memory."""
  return dict(threads_per_system=1, threads=BLOCK, shared_bytes=0)


def _function(n: int):
  """The launcher of the library for n, bound once (argument types set)."""
  if n not in _LIBS:
    lib = _build.load("chol_solve_lanes.cu", build_defines(n))
    lib.chol_solve_lanes_n.restype = ctypes.c_int
    if lib.chol_solve_lanes_n() != n:
      raise RuntimeError(f"library built for n={lib.chol_solve_lanes_n()}, "
                         f"asked for n={n}")
    fn = lib.chol_solve_lanes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    _LIBS[n] = fn
  return _LIBS[n]


def chol_solve_lanes_plain(a: torch.Tensor, b: torch.Tensor,
                           eps: float = EPS) -> torch.Tensor:
  """The kernel's arithmetic on tensors: a (n, n, K), b (n, K) -> (n, K).
  Column j of L after its pivot; entries above the diagonal unused."""
  n = b.shape[0]
  low = [[None] * n for _ in range(n)]
  dinv = [None] * n
  for j in range(n):
    s = a[j, j]
    for k in range(j):
      s = s - low[j][k] * low[j][k]
    d = torch.sqrt(torch.clamp(s, min=eps))
    dinv[j] = 1.0 / d
    for i in range(j + 1, n):
      si = a[i, j]
      for k in range(j):
        si = si - low[i][k] * low[j][k]
      low[i][j] = si * dinv[j]
  y = [None] * n
  for i in range(n):
    s = b[i]
    for k in range(i):
      s = s - low[i][k] * y[k]
    y[i] = s * dinv[i]
  x = [None] * n
  for i in range(n - 1, -1, -1):
    s = y[i]
    for k in range(i + 1, n):
      s = s - low[k][i] * x[k]
    x[i] = s * dinv[i]
  return torch.stack(x)


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """The kernel on CUDA tensors. The launch path is short because the
  robust path makes ~1,800 of these calls an iteration at n = 8, K = 16,
  where the kernel takes ~2 us: the ctypes function is bound once, inputs
  already contiguous are not copied, and the device context is entered only
  when the tensors are not on the current device."""
  global launch_count
  n, k = b.shape
  if not supports(n):
    raise NotImplementedError(
        f"system size n={n} outside the batched Cholesky kernel's gate "
        f"(1..{MAX_N})")
  dev = a.device
  if a.dtype != torch.float32 or b.dtype != torch.float32 or \
      a.shape != (n, n, k) or b.device != dev:
    raise ValueError(
        f"expected float32 a (n, n, K) and b (n, K) on one device, got "
        f"{a.dtype} {tuple(a.shape)} on {dev} and {b.dtype} "
        f"{tuple(b.shape)} on {b.device}")
  if not a.is_contiguous():
    a = a.contiguous()
  if not b.is_contiguous():
    b = b.contiguous()
  x = torch.empty_like(b)
  fn = _function(n)
  if dev.index is None or dev.index == torch.cuda.current_device():
    err = fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), k,
             torch.cuda.current_stream(dev).cuda_stream)
  else:
    with torch.cuda.device(dev):
      err = fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), k,
               torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"chol_solve_lanes launch failed: CUDA error {err}")
  launch_count += launches.count(replay_counts, dev)
  return x


def chol_solve_lanes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """a (n, n, K), b (n, K) -> x (n, K): the kernel on CUDA tensors, the
  plain version on CPU tensors."""
  if a.device.type == "cuda":
    return _launch(a, b)
  return chol_solve_lanes_plain(a, b)


class _LaneSolve(torch.autograd.Function):
  """chol_solve_lanes as a function `torch.func.vmap` can batch: the vmap
  rule moves each vmapped dimension next to the lane axis and folds it in,
  so the ctypes launch happens on plain, contiguous tensors (inside vmap a
  tensor has no usable data pointer). Nested vmaps fold one level per call.
  There is no derivative rule (forward or reverse): code that is
  differentiated takes the library route (physics/smooth.py)."""

  @staticmethod
  def forward(a, b):
    return chol_solve_lanes(a, b)

  @staticmethod
  def setup_context(ctx, inputs, output):
    pass

  @staticmethod
  def backward(ctx, grad):
    raise NotImplementedError("the batched Cholesky kernel has no "
                              "derivative rule")

  @staticmethod
  def vmap(info, in_dims, a, b):
    size = info.batch_size
    ad, bd = in_dims
    a = a.movedim(ad, -1) if ad is not None else \
        a[..., None].expand(*a.shape, size)
    b = b.movedim(bd, -1) if bd is not None else \
        b[..., None].expand(*b.shape, size)
    n, k = b.shape[0], b.shape[1]
    x = _LaneSolve.apply(a.reshape(n, n, k * size), b.reshape(n, k * size))
    return x.reshape(n, k, size), 2


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve a x = b for one SPD system a (n, n), b (n,) through the kernel
  (its plain version on CPU tensors); under `torch.func.vmap` one launch
  solves the whole batch."""
  return _LaneSolve.apply(a[..., None], b[:, None])[:, 0]

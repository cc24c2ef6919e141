"""The iLQG backward Riccati/boxQP sweep as one CUDA kernel launch.

Replaces the TPU kernel `mujoco_mpc_tpu/ops/riccati_lane.py:
build_backward_kernel` (Pallas). The recursion is strictly sequential in
time over small dense matrices; as separate PyTorch ops every step is some
hundred launches, so the time is launch overhead. The kernel
(ops/csrc/riccati_backward.cu) runs the WHOLE sweep — Q expansions, the
projected-Newton box QP with its free-set Gauss-Jordan inverse, the gain,
the value update — inside one thread block: the workspace in shared
memory, the box QP in the registers of one warp, five block barriers a
step.

What bounds it on an H100: the dependent chain (T-1 steps of a fixed
sequence of phases), not bytes or operations; see the note at the top of
the source for what the design does about it.

Its plain PyTorch version is `planners.ilqg.backward_pass` (a Python loop
over t of torch ops), used for CPU tensors, by the tests and by the
on-card comparison. On CUDA tensors the wrapper launches the kernel or
raises.

Eligibility (`supports`): ndx <= 128, nu <= 32, horizon <= 512 — the sizes
at which one block's loops stay short. Outside it callers take
`backward_pass`.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from mujoco_mpc_tpu_torch.ops import _build

REG_CONTROL, REG_STATE_CONTROL, REG_VALUE, REG_NONE = 0, 1, 2, 3

# launches of the CUDA kernel made by any wrapper of this module
# (incremented where a wrapper launches, nowhere else)
launch_count = 0

# what a profiling build's (RB_PROFILE) stamps of a step delimit
PROFILE_PHASES = ("Vxx A, Vxx B, Qx, Qu", "Q expansions",
                  "box QP (thread 0's warp)", "Quu k, P = Quu F inv, dv",
                  "gain K, Quu K", "new Vx, new Vxx (symmetric)")

# dynamic shared memory one block may use on sm_90 (227 KB)
_SMEM_LIMIT_BYTES = 232448


def supports(ndx: int, nu: int, horizon: int) -> bool:
  """Kernel eligibility."""
  return ndx <= 128 and nu <= 32 and 2 <= horizon <= 512 and nu >= 1


def workspace_floats(ndx: int, nu: int) -> int:
  """Size of the kernel's workspace (W_TOTAL in the source), all of its
  dynamic shared memory."""
  return (2 * ndx * ndx + 5 * ndx * nu + 2 * nu * nu + nu * (nu | 1) +
          3 * ndx + 4 * nu + 1)


def block_size(ndx: int) -> int:
  """Threads of the one block: 256 to ndx 32, else 512 (the sweep,
  scripts/torch_kernel_sweep.py --only tune: the fastest of 64 to 1,024 at
  ndx 16, 36 and 128; at 128 the QP warp's registers spill a little at 512
  and a lot at 1,024)."""
  return 256 if ndx <= 32 else 512


def build_backward_kernel(ndx: int, nu: int, horizon: int,
                          boxqp_iters: int, reg_type: int, *,
                          _profile: bool = False) -> Callable:
  """Returns fn(a, b, cx, cu, cxx, cxu, cuu, du_lower, du_upper, reg)
  -> (ks (T-1, nu), kmats (T-1, nu, ndx), (dv1, dv2), ok) with the same
  semantics as planners.ilqg.backward_pass. `reg` is a 0-d tensor (it stays
  on the device: the kernel reads it from memory). The one block has
  `block_size(ndx)` threads and its workspace in shared memory at every
  size of the gate (`fn.layout`).

  A measuring build (scripts/torch_kernel_sweep.py): `_profile` builds with
  -DRB_PROFILE=1, and each launch leaves the clock64() stamps of every
  step's phases in `backward.last_profile` (T-1, stamps), step T-2 first.
  """
  if not supports(ndx, nu, horizon):
    raise ValueError(
        f"sizes outside the Riccati kernel's gate: ndx={ndx} (<=128), "
        f"nu={nu} (1..32), horizon={horizon} (2..512)")
  from mujoco_mpc_tpu_torch.planners import ilqg as ilqg_lib

  t_len = horizon
  block = block_size(ndx)
  ws_floats = workspace_floats(ndx, nu)
  smem = 4 * ws_floats
  if smem > _SMEM_LIMIT_BYTES:
    raise ValueError(f"workspace of {smem} B past the {_SMEM_LIMIT_BYTES} B "
                     f"of shared memory a block may have")
  state = dict(lib=None, fn=None)

  def defines():
    return dict(RB_NX=ndx, RB_NU=nu, RB_T=t_len, RB_QP_ITERS=boxqp_iters,
                RB_REG_TYPE=reg_type, RB_BLOCK=block,
                **(dict(RB_PROFILE=1) if _profile else {}))

  def library():
    if state["lib"] is None:
      lib = _build.load("riccati_backward.cu", defines())
      lib.riccati_workspace_floats.restype = ctypes.c_int
      lib.riccati_profile_stamps.restype = ctypes.c_int
      fn = lib.riccati_backward
      fn.restype = ctypes.c_int
      fn.argtypes = [ctypes.c_void_p] * 15
      if lib.riccati_workspace_floats() != ws_floats:
        raise RuntimeError(
            f"workspace layout mismatch: kernel expects "
            f"{lib.riccati_workspace_floats()} floats, wrapper {ws_floats}")
      state["lib"], state["fn"] = lib, fn
    return state["lib"]

  def backward_plain(a, b, cx, cu, cxx, cxu, cuu, du_lower, du_upper, reg):
    return ilqg_lib.backward_pass(a, b, cx, cu, cxx, cxu, cuu, du_lower,
                                  du_upper, reg, boxqp_iters, reg_type)

  shapes = dict(
      a=(t_len - 1, ndx, ndx), b=(t_len - 1, ndx, nu), cx=(t_len, ndx),
      cu=(t_len, nu), cxx=(t_len, ndx, ndx), cxu=(t_len, ndx, nu),
      cuu=(t_len, nu, nu), du_lower=(t_len - 1, nu),
      du_upper=(t_len - 1, nu), reg=())

  def backward_cuda(*args):
    global launch_count
    dev = args[0].device
    ins = []
    for (name, shape), x in zip(shapes.items(), args):
      if x.device != dev or x.dtype != torch.float32 or \
          tuple(x.shape) != shape:
        raise ValueError(
            f"{name}: expected a float32 tensor of shape {shape} on {dev}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}")
      ins.append(x.contiguous())
    lib = library()
    f32 = dict(dtype=torch.float32, device=dev)
    ks = torch.empty((t_len - 1, nu), **f32)
    kmats = torch.empty((t_len - 1, nu, ndx), **f32)
    out = torch.empty((3,), **f32)
    prof = None
    if _profile:
      prof = torch.zeros((t_len - 1, lib.riccati_profile_stamps()),
                         dtype=torch.int64, device=dev)
      backward.last_profile = prof
    with torch.cuda.device(dev):
      stream = torch.cuda.current_stream().cuda_stream
      err = state["fn"](
          *[x.data_ptr() for x in ins], ks.data_ptr(), kmats.data_ptr(),
          out.data_ptr(), None if prof is None else prof.data_ptr(), stream)
    if err != 0:
      raise RuntimeError(f"riccati_backward launch failed: CUDA error {err}")
    launch_count += 1
    return ks, kmats, (out[0], out[1]), out[2] == 0.0

  def backward(a, b, cx, cu, cxx, cxu, cuu, du_lower, du_upper, reg):
    args = (a, b, cx, cu, cxx, cxu, cuu, du_lower, du_upper, reg)
    if a.device.type == "cuda":
      return backward_cuda(*args)
    return backward_plain(*args)

  backward.plain = backward_plain
  backward.build_defines = defines
  backward.workspace_floats = ws_floats
  backward.layout = dict(block=block, shared_bytes=smem,
                         workspace_in_shared_memory=True)
  return backward

"""Fused trajectory scoring as one CUDA kernel launch.

Replaces the TPU kernel `mujoco_mpc_tpu/ops/scoring.py:score_fused`
(Pallas): residual rows -> per-term quadratic / L2 / smooth-abs norms ->
weighted sum -> mean over the horizon -> one return per candidate, without
materialising the per-step, per-term costs. The kernel
(ops/csrc/score_fused.cu) runs a tile of neighbouring candidates by
several slices of the horizon a block, the slices' sums added by a fixed
tree (shuffles, then shared memory); it is bound by bytes (see the note at
the top of the source). `layout(k, t, sms)` is its launch rule.

Layout: the scorer takes residuals (T, nr, K) — candidates on the last
axis — as any strided tensor: the kernel reads them through their strides,
so the rollout kernel's (T, nr, K) rows and the batched pipeline rollouts'
(K, T, nr) batch permuted to (T, nr, K) (rollout.py) go in without a copy,
and so do the weights and the norm parameters (column 0 read through the
row stride). One scorer call on CUDA tensors is one device kernel.
`score_reference` keeps the JAX package's (K, T, nr).

The gate is the JAX package's: a cost with another norm, or a
risk-sensitive cost (risk != 0), is not what the kernel computes.
`make_scorer` reads the gate once, when it is built (the risk is one host
read), and says which route it took (`scorer.route`, `scorer.gate`): the
kernel ("kernel": on CUDA tensors the CUDA kernel, on CPU tensors its plain
version) or the plain cost ("plain"). On the CPU the route follows the
gate, as the JAX function does; on a CUDA device a refused gate raises
`NotImplementedError` naming it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mujoco_mpc_tpu_torch.costs import norms
from mujoco_mpc_tpu_torch.ops import _build, launches

SUPPORTED = (int(norms.NormType.QUADRATIC), int(norms.NormType.L2),
             int(norms.NormType.SMOOTH_ABS))
RISK_NEUTRAL_TOL = 1e-6
MAX_TERMS = 16
MAX_THREADS = 1024    # threads a block (the source's MAX_THREADS)
MAX_TILE = 32         # candidates a block: one warp's row of a step
ROUTE_KERNEL = "kernel"
ROUTE_PLAIN = "plain"

# launches of the CUDA kernel made by any wrapper of this module, counted
# where a wrapper launches and nowhere else (ops/launches.py): eager ones
# here, those replayed from a CUDA graph on the device
launch_count = 0
replay_counts = {}

_LIBS = {}


def gate(cost_spec) -> Optional[str]:
  """Why the kernel does not compute this cost (None if it does). Reads the
  risk back once."""
  bad = [norms.NormType(t).name for t in cost_spec.norm_types
         if int(t) not in SUPPORTED]
  if bad:
    return f"norms {bad} (the kernel computes quadratic, L2, smooth-abs)"
  if not 1 <= len(cost_spec.norm_types) <= MAX_TERMS:
    return (f"{len(cost_spec.norm_types)} cost terms (the kernel takes "
            f"1..{MAX_TERMS})")
  if abs(float(cost_spec.risk)) > RISK_NEUTRAL_TOL:
    return f"risk-sensitive cost (risk={float(cost_spec.risk)})"
  return None


def build_defines(cost_spec) -> dict:
  """The term structure as compile-time defines (see the source)."""
  out, off = {}, 0
  for i, (ntype, dim) in enumerate(zip(cost_spec.norm_types,
                                       cost_spec.dims)):
    out.update({f"SF_TYPE_{i}": int(ntype), f"SF_OFF_{i}": off,
                f"SF_DIM_{i}": int(dim)})
    off += int(dim)
  return dict(out, SF_NTERM=len(cost_spec.norm_types), SF_NR=off)


@functools.lru_cache(maxsize=None)
def layout(k: int, t_hor: int, sms: int) -> tuple:
  """The launch rule: (tile, slices) of a block for K candidates over T
  steps on a card of `sms` SMs. The tile is the smallest power of two of
  at least K / sms candidates (at most MAX_TILE), so the blocks spread over
  the SMs; the slices the smallest power of two of at least T (one step a
  thread), within MAX_THREADS threads a block
  (scripts/torch_kernel_sweep.py --only tune_b3)."""
  tile = min(MAX_TILE, 1 << (max(1, -(-k // sms)) - 1).bit_length())
  slices = min(1 << (max(1, t_hor) - 1).bit_length(), MAX_THREADS // tile)
  return tile, slices


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
  """Streaming multiprocessors of CUDA device `index`."""
  return torch.cuda.get_device_properties(index).multi_processor_count


def _function(cost_spec):
  """The launcher of the library for this cost's term structure, bound once
  (argument types set)."""
  key = (cost_spec.norm_types, cost_spec.dims)
  if key not in _LIBS:
    defines = build_defines(cost_spec)
    lib = _build.load("score_fused.cu", defines)
    lib.score_fused_nterm.restype = ctypes.c_int
    if lib.score_fused_nterm() != defines["SF_NTERM"]:
      raise RuntimeError("score_fused library built for another cost")
    fn = lib.score_fused
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
    _LIBS[key] = fn
  return _LIBS[key]


def score_reference(residuals: torch.Tensor, cost_spec) -> torch.Tensor:
  """Plain version: mean over the horizon of the cost; residuals (K, T, nr)
  -> (K,)."""
  return torch.mean(cost_spec.cost(residuals), dim=-1)


def _launch(residuals: torch.Tensor, cost_spec) -> torch.Tensor:
  """The kernel on CUDA tensors: residuals (T, nr, K) of any strides, the
  cost's weights and norm parameters as they are (copied only when they
  lie on another device or in another type). No host synchronisation; the
  device context is entered only when the tensors are not on the current
  device."""
  global launch_count
  t_hor, nr, k = residuals.shape
  if residuals.dtype != torch.float32 or nr != cost_spec.num_residual:
    raise ValueError(
        f"expected float32 residuals (T, {cost_spec.num_residual}, K), got "
        f"{residuals.dtype} {tuple(residuals.shape)}")
  dev = residuals.device
  weights, params = cost_spec.weights, cost_spec.norm_params
  if weights.device != dev or weights.dtype != torch.float32:
    weights = weights.to(dev, torch.float32)
  if params.device != dev or params.dtype != torch.float32:
    params = params.to(dev, torch.float32)
  out = torch.empty((k,), dtype=torch.float32, device=dev)
  fn = _function(cost_spec)
  current = torch.cuda.current_device()
  index = current if dev.index is None else dev.index
  tile, slices = layout(k, t_hor, sm_count(index))
  st, sr, sc = residuals.stride()
  args = (residuals.data_ptr(), st, sr, sc, weights.data_ptr(),
          weights.stride(0), params.data_ptr(), params.stride(0),
          out.data_ptr(), t_hor, k, tile.bit_length() - 1, slices)
  if index == current:
    err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
  else:
    with torch.cuda.device(dev):
      err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"score_fused launch failed: CUDA error {err}")
  launch_count += launches.count(replay_counts, dev)
  return out


def make_scorer(cost_spec, device):
  """Returns `scorer(residuals (T, nr, K), cost_spec=None) -> (K,)`, the
  horizon-mean cost of each candidate. `cost_spec` at call time may carry
  other weights and norm parameters (run-time arguments of the kernel) but
  the same term structure. `scorer.route` is "kernel" or "plain",
  `scorer.gate` the gate's reason (None when the kernel takes the cost)."""
  reason = gate(cost_spec)
  if reason is not None and torch.device(device).type == "cuda":
    raise NotImplementedError(
        f"the fused scoring kernel does not compute this cost: {reason}")
  fused = reason is None
  spec0 = cost_spec

  def scorer(residuals, cost_spec=None):
    cs = spec0 if cost_spec is None else cost_spec
    if fused and residuals.device.type == "cuda":
      return _launch(residuals, cs)
    return score_reference(residuals.permute(2, 0, 1), cs)

  scorer.route = ROUTE_KERNEL if fused else ROUTE_PLAIN
  scorer.gate = reason
  return scorer


"""Fused trajectory scoring as one CUDA kernel launch.

Replaces the TPU kernel `mujoco_mpc_tpu/ops/scoring.py:score_fused`
(Pallas): residual rows -> per-term quadratic / L2 / smooth-abs norms ->
weighted sum -> mean over the horizon -> one return per candidate, without
materialising the per-step, per-term costs. The kernel
(ops/csrc/score_fused.cu) runs one thread per candidate; it is bound by
bytes (see the note at the top of the source).

Layout: the kernel takes residuals (T, nr, K) — candidates on the last
axis, the layout in which the rollout kernel and the batched pipeline
rollouts (rollout.py) record them; `score_reference` keeps the JAX
package's (K, T, nr).

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
from typing import Optional

import torch

from mujoco_mpc_tpu_torch.costs import norms
from mujoco_mpc_tpu_torch.ops import _build

SUPPORTED = (int(norms.NormType.QUADRATIC), int(norms.NormType.L2),
             int(norms.NormType.SMOOTH_ABS))
RISK_NEUTRAL_TOL = 1e-6
MAX_TERMS = 16
ROUTE_KERNEL = "kernel"
ROUTE_PLAIN = "plain"

# launches of the CUDA kernel made by any wrapper of this module
# (incremented where a wrapper launches, nowhere else)
launch_count = 0

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


def _library(cost_spec):
  defines = build_defines(cost_spec)
  key = tuple(sorted(defines.items()))
  if key not in _LIBS:
    lib = _build.load("score_fused.cu", defines)
    lib.score_fused_nterm.restype = ctypes.c_int
    lib.score_fused.restype = ctypes.c_int
    lib.score_fused.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    if lib.score_fused_nterm() != defines["SF_NTERM"]:
      raise RuntimeError("score_fused library built for another cost")
    _LIBS[key] = lib
  return _LIBS[key]


def score_reference(residuals: torch.Tensor, cost_spec) -> torch.Tensor:
  """Plain version: mean over the horizon of the cost; residuals (K, T, nr)
  -> (K,)."""
  return torch.mean(cost_spec.cost(residuals), dim=-1)


def _launch(residuals: torch.Tensor, cost_spec) -> torch.Tensor:
  global launch_count
  t_hor, nr, k = residuals.shape
  if residuals.dtype != torch.float32 or nr != cost_spec.num_residual:
    raise ValueError(
        f"expected float32 residuals (T, {cost_spec.num_residual}, K), got "
        f"{residuals.dtype} {tuple(residuals.shape)}")
  dev = residuals.device
  res = residuals.contiguous()
  weights = cost_spec.weights.to(dev, torch.float32).contiguous()
  p0 = cost_spec.norm_params[:, 0].to(dev, torch.float32).contiguous()
  out = torch.empty((k,), dtype=torch.float32, device=dev)
  lib = _library(cost_spec)
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.score_fused(res.data_ptr(), weights.data_ptr(), p0.data_ptr(),
                          out.data_ptr(), t_hor, k, stream)
  if err != 0:
    raise RuntimeError(f"score_fused launch failed: CUDA error {err}")
  launch_count += 1
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


"""Task cost specification parsed from MJCF conventions.

  * leading `<sensor><user .../>` entries define cost terms; their `user`
    attribute is [norm_type, weight, weight_lo, weight_hi, params...];
  * `<custom><numeric name="residual_X" data=".."/>` define residual
    params;
  * the `task_risk` custom numeric sets the exponential risk transform
    (e^{R*cost}-1)/R.

The static structure (term dims, norm types) is host data; weights and
norm params are tensors so they can change at run time. The parsers are
duck-typed on a compiled MuJoCo model object and import no `mujoco`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mujoco_mpc_tpu_torch.costs import norms

RISK_NEUTRAL_TOL = 1e-6
_SENS_USER = 48  # mjtSensor.mjSENS_USER


def get_number_or_default(mjm, name: str, default):
  """First value of the custom numeric `name`, or `default`."""
  for i in range(mjm.nnumeric):
    if mjm.numeric(i).name == name:
      return float(mjm.numeric_data[mjm.numeric_adr[i]])
  return default


@dataclasses.dataclass(frozen=True)
class CostSpec:
  """Weighted sum of norms over residual slices (+ risk transform)."""
  term_names: tuple
  norm_types: tuple          # tuple[int]
  dims: tuple                # residual dims
  weights: torch.Tensor      # (nterm,)
  norm_params: torch.Tensor  # (nterm, 3) padded
  risk: torch.Tensor         # scalar

  @property
  def num_term(self) -> int:
    return len(self.norm_types)

  @property
  def num_residual(self) -> int:
    return sum(self.dims)

  def replace(self, **kw) -> "CostSpec":
    return dataclasses.replace(self, **kw)

  def cost_terms(self, residual: torch.Tensor,
                 weighted: bool = True) -> torch.Tensor:
    """Per-term costs; residual (..., num_residual) -> (..., nterm)."""
    outs = []
    off = 0
    for k in range(self.num_term):
      x = residual[..., off:off + self.dims[k]]
      y = norms.norm_value(x, self.norm_types[k], self.norm_params[k])
      outs.append(self.weights[k] * y if weighted else y)
      off += self.dims[k]
    return torch.stack(outs, dim=-1)

  def cost(self, residual: torch.Tensor) -> torch.Tensor:
    """Total (risk-transformed) cost; (..., num_residual) -> (...)."""
    c = torch.sum(self.cost_terms(residual), dim=-1)
    neutral = torch.abs(self.risk) < RISK_NEUTRAL_TOL
    risk_safe = torch.where(neutral, torch.ones_like(self.risk), self.risk)
    risked = (torch.exp(risk_safe * c) - 1.0) / risk_safe
    return torch.where(neutral, c, risked)

  def set_weight(self, name: str, value) -> "CostSpec":
    idx = self.term_names.index(name)
    weights = self.weights.clone()
    weights[idx] = float(value)
    return self.replace(weights=weights)


def parse_cost_spec(mjm, device="cuda") -> CostSpec:
  """Build a CostSpec from the leading user sensors of a compiled model."""
  names, ntypes, dims, weights, params = [], [], [], [], []
  for i in range(mjm.nsensor):
    if int(mjm.sensor_type[i]) != _SENS_USER:
      break
    s = mjm.sensor_user[i]
    names.append(mjm.sensor(i).name)
    ntypes.append(int(s[0]))
    dims.append(int(mjm.sensor_dim[i]))
    weights.append(float(s[1]))
    npar = norms.num_norm_params(int(s[0]))
    pvec = np.zeros(3)
    pvec[:npar] = s[4:4 + npar]
    params.append(pvec)
  risk = get_number_or_default(mjm, "task_risk", 0.0)
  f32 = dict(dtype=torch.float32, device=device)
  return CostSpec(
      term_names=tuple(names), norm_types=tuple(ntypes), dims=tuple(dims),
      weights=torch.tensor(weights, **f32),
      norm_params=torch.tensor(np.array(params).reshape(-1, 3), **f32),
      risk=torch.tensor(risk, **f32))


def parse_residual_params(mjm, device="cuda") -> torch.Tensor:
  """Concatenate the FIRST value of each `residual_*` custom numeric (the
  rest of each entry are slider ranges)."""
  vals = []
  for i in range(mjm.nnumeric):
    if mjm.numeric(i).name.startswith("residual_"):
      vals.append(float(mjm.numeric_data[mjm.numeric_adr[i]]))
  return torch.tensor(vals, dtype=torch.float32, device=device)

"""ctypes binding of the native policy host (policy_runtime.cc).

The host is a lock-free double-buffered spline: the planner publishes plans
with `update`, a control thread samples them with `action` at servo rate,
with no Python-side lock and no torch on the read path. The shared library
is built at first use with g++ into `build/` at the repository root (the
directory the CUDA kernels build into, ops/_build.py), keyed by a hash of
the source, so a changed source rebuilds and an unchanged one is reused.
The build runs under a file lock: pytest-xdist workers or several services
starting at once wait for one build instead of racing it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np

from mujoco_mpc_tpu_torch.ops import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "policy_runtime.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def library_path() -> str:
  """Path of the library built from the current source."""
  with open(SOURCE, "rb") as f:
    hs = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
  return os.path.join(_build.build_dir(),
                      f"libpolicy_runtime_{hs.hexdigest()[:16]}.so")


def build() -> str:
  """Build the library unless it is there; returns its path."""
  path = library_path()
  if os.path.exists(path):
    return path
  os.makedirs(_build.build_dir(), exist_ok=True)
  with open(os.path.join(_build.build_dir(), ".policy_runtime.lock"),
            "w") as lock:
    fcntl.flock(lock, fcntl.LOCK_EX)
    if not os.path.exists(path):
      tmp = f"{path}.{os.getpid()}.tmp"
      out = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                           capture_output=True, text=True)
      if out.returncode != 0:
        raise RuntimeError(f"g++ failed ({out.returncode}) building "
                           f"{SOURCE}:\n{out.stderr}")
      os.replace(tmp, path)
  return path


_lib = None


def get_lib() -> ctypes.CDLL:
  global _lib
  if _lib is None:
    path = build()
    lib = ctypes.CDLL(path)
    dp = ctypes.POINTER(ctypes.c_double)
    # the read path keeps the GIL: the call takes about a microsecond, and
    # a caller that released the GIL around it would wait to take it back
    # from a thread that is dispatching a plan
    lib.action_keep_gil = ctypes.PyDLL(path).mpc_policy_action
    lib.action_keep_gil.argtypes = [ctypes.c_void_p, ctypes.c_double, dp]
    lib.mpc_policy_create.restype = ctypes.c_void_p
    lib.mpc_policy_create.argtypes = [ctypes.c_int32] * 3
    lib.mpc_policy_destroy.argtypes = [ctypes.c_void_p]
    lib.mpc_policy_set_ctrlrange.argtypes = [ctypes.c_void_p, dp, dp]
    lib.mpc_policy_update.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                      ctypes.c_double, dp]
    lib.mpc_policy_action.argtypes = [ctypes.c_void_p, ctypes.c_double, dp]
    lib.mpc_policy_version.restype = ctypes.c_uint64
    lib.mpc_policy_version.argtypes = [ctypes.c_void_p]
    _lib = lib
  return _lib


def _ptr(x: np.ndarray):
  return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class PolicyRuntime:
  """Native double-buffered policy host: one writer (`update`), any number
  of readers (`action`)."""

  def __init__(self, nu: int, num_nodes: int, interp: int = 0,
               ctrl_lo=None, ctrl_hi=None):
    self.lib = get_lib()
    self.nu = nu
    self.num_nodes = num_nodes
    self.handle = self.lib.mpc_policy_create(nu, num_nodes, interp)
    if ctrl_lo is not None:
      self.set_ctrlrange(ctrl_lo, ctrl_hi)

  def set_ctrlrange(self, lo, hi):
    lo = np.ascontiguousarray(lo, dtype=np.float64)
    hi = np.ascontiguousarray(hi, dtype=np.float64)
    self.lib.mpc_policy_set_ctrlrange(self.handle, _ptr(lo), _ptr(hi))

  def update(self, t0: float, dt: float, values: np.ndarray):
    """Publish spline nodes (num_nodes, nu) on the grid t0 + k dt."""
    values = np.ascontiguousarray(values, dtype=np.float64)
    if values.shape != (self.num_nodes, self.nu):
      raise ValueError(f"values: expected ({self.num_nodes}, {self.nu}), "
                       f"got {values.shape}")
    self.lib.mpc_policy_update(self.handle, float(t0), float(dt),
                               _ptr(values))

  def action(self, time: float) -> np.ndarray:
    """The newest published policy at `time`, clamped to the ctrl range
    (lock-free against `update`, which releases the GIL while it copies)."""
    out = np.empty(self.nu, dtype=np.float64)
    self.lib.action_keep_gil(self.handle, float(time), _ptr(out))
    return out

  @property
  def version(self) -> int:
    """Number of plans published so far."""
    return int(self.lib.mpc_policy_version(self.handle))

  def close(self):
    if self.handle is not None:
      self.lib.mpc_policy_destroy(self.handle)
      self.handle = None

  def __del__(self):
    self.close()

"""Build and load the hand-written CUDA kernels.

Each kernel is a plain-C shared library compiled with `nvcc` for sm_90a
from the sources under ops/csrc/ (no PyTorch headers, so a build takes
seconds) and loaded with `ctypes`. Libraries are built at first use into
`build/` at the repository root, keyed by a hash of every source file plus
the compile-time defines, so a changed source or a different model
rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO_ROOT = os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# build log per library path: seconds, ptxas resource lines
BUILD_LOG: Dict[str, dict] = {}


def build_dir() -> str:
  return os.path.join(_REPO_ROOT, "build")


def find_nvcc() -> str:
  nvcc = shutil.which("nvcc")
  if nvcc is None:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
      nvcc = cand
  if nvcc is None:
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use and "
        "need the CUDA toolkit (looked on PATH and under CUDA_HOME)")
  return nvcc


def _source_hash() -> str:
  hs = hashlib.sha256()
  for name in sorted(os.listdir(CSRC)):
    if name.endswith((".cu", ".cuh")):
      hs.update(name.encode())
      with open(os.path.join(CSRC, name), "rb") as f:
        hs.update(f.read())
  return hs.hexdigest()


def library_path(source: str, defines: Dict[str, object]) -> Tuple[str, list]:
  """Path of the library for `source` with `defines`, and the -D flags."""
  flags = [f"-D{k}={v}" for k, v in sorted(defines.items())]
  hs = hashlib.sha256((_source_hash() + source + " ".join(flags)).encode())
  stem = os.path.splitext(os.path.basename(source))[0]
  return os.path.join(build_dir(),
                      f"lib{stem}_{hs.hexdigest()[:16]}.so"), flags


def start_build(source: str, defines: Dict[str, object]
                ) -> Tuple[str, Optional[subprocess.Popen]]:
  """Start `nvcc` for one library unless it is already built; returns the
  library path and the running process (None if nothing had to be built).
  Several builds may run side by side; `finish_build` waits for one."""
  path, flags = library_path(source, defines)
  if os.path.exists(path):
    BUILD_LOG.setdefault(path, dict(seconds=0.0, ptxas=[], cached=True))
    return path, None
  os.makedirs(build_dir(), exist_ok=True)
  tmp = f"{path}.{os.getpid()}.tmp"
  cmd = [find_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", *flags, "-o", tmp,
         os.path.join(CSRC, source)]
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
  proc.lane_build = (path, tmp, time.perf_counter(), cmd)
  return path, proc


def finish_build(proc: Optional[subprocess.Popen]) -> None:
  if proc is None:
    return
  path, tmp, t0, cmd = proc.lane_build
  out, _ = proc.communicate()
  if proc.returncode != 0:
    raise RuntimeError(
        f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
  os.replace(tmp, path)
  ptxas = [ln.strip() for ln in out.splitlines()
           if "registers" in ln or "spill" in ln or "stack frame" in ln]
  BUILD_LOG[path] = dict(seconds=time.perf_counter() - t0, ptxas=ptxas,
                         cached=False)


def load(source: str, defines: Dict[str, object]) -> ctypes.CDLL:
  """Build (if needed) and load the library for `source` + `defines`."""
  path, proc = start_build(source, defines)
  finish_build(proc)
  if path not in _LOADED:
    _LOADED[path] = ctypes.CDLL(path)
  return _LOADED[path]

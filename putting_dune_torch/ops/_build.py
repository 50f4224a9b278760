"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain C function (no PyTorch headers), so
nvcc builds it in seconds. Libraries go to `putting_dune_torch/_build/`
(git-ignored), named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is reused. `build_all` starts one
nvcc per source, all at once. Nothing here runs at import time.

Every wrapper also counts its launches in `LAUNCHES` (one per kernel
launch, nowhere else), so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / 'csrc'
BUILD_DIR = _PKG_DIR / '_build'

# --fmad=false: no contraction of a*b+c into one fused multiply-add, so
# the kernels round every step as the plain PyTorch twins do; the twins
# are then exact oracles (a contracted add can move a Poisson count or a
# histogram bin across a floor/cast boundary).
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a',
    '-std=c++17', '-O3', '--fmad=false',
    '-shared', '-Xcompiler', '-fPIC',
)

KERNELS = ('noise_chain', 'clahe_hist_lut', 'clahe_remap', 'clahe_small')

LAUNCHES = {name: 0 for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def count_launch(name: str) -> None:
  LAUNCHES[name] += 1


def reset_launches() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


def nvcc_path() -> str:
  home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
  candidate = os.path.join(home, 'bin', 'nvcc')
  if os.path.exists(candidate):
    return candidate
  found = shutil.which('nvcc')
  if found is None:
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH.')
  return found


def library_path(name: str) -> pathlib.Path:
  source = (SRC_DIR / f'{name}.cu').read_bytes()
  digest = hashlib.sha256(source + ' '.join(NVCC_FLAGS).encode()).hexdigest()
  return BUILD_DIR / f'{name}-{digest[:16]}.so'


def build_all(names=KERNELS, *, verbose: bool = False) -> dict[str, str]:
  """Compiles every missing library, one nvcc process per source in
  parallel. Returns {name: ptxas report} when verbose (else empty text).

  Raises RuntimeError with nvcc's output if any build fails.
  """
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  procs = {}
  for name in names:
    out = library_path(name)
    if out.exists() and not verbose:
      continue
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
      cmd += ['-Xptxas', '-v']
    cmd += ['-o', str(tmp), str(SRC_DIR / f'{name}.cu')]
    procs[name] = (subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    ), tmp, out)
  reports, failures = {}, []
  for name, (proc, tmp, out) in procs.items():
    text, _ = proc.communicate()
    reports[name] = text
    if proc.returncode != 0:
      failures.append(f'{name}: nvcc exited {proc.returncode}\n{text}')
      continue
    os.replace(tmp, out)
  if failures:
    raise RuntimeError('CUDA build failed:\n' + '\n'.join(failures))
  return reports


def load(name: str) -> ctypes.CDLL:
  """Returns the loaded library for `name`, building it on first use."""
  with _lock:
    lib = _libs.get(name)
    if lib is None:
      path = library_path(name)
      if not path.exists():
        build_all((name,))
      lib = ctypes.CDLL(str(path))
      _libs[name] = lib
    return lib


def check_status(name: str, status: int) -> None:
  if status != 0:
    raise RuntimeError(
        f'{name}: kernel launch failed with cudaError {status}.'
    )


def ptr(tensor) -> ctypes.c_void_p:
  return ctypes.c_void_p(0 if tensor is None else tensor.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
  return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_tensor(tensor, name: str, dtype, ndim: int) -> None:
  if tensor.dtype != dtype:
    raise TypeError(f'{name}: expected {dtype}, got {tensor.dtype}.')
  if tensor.dim() != ndim:
    raise ValueError(f'{name}: expected {ndim} dims, got {tuple(tensor.shape)}.')
  if not tensor.is_contiguous():
    raise ValueError(f'{name}: tensor must be contiguous.')

"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). All
sources are compiled together, one ``nvcc`` process each, the first time any
kernel is needed. Libraries go to ``build/kernels/`` beside the package, named
by a hash of their source and flags, so an edited source is rebuilt and never
loaded stale. ``--use_fast_math`` is deliberately absent: the voxelizer must
be bit-exact with its plain version and the IoU kernel needs accurate
``sinf``/``cosf`` and IEEE division. ``-fmad=false`` keeps nvcc from fusing a
multiply and an add into one rounding: every operation then rounds as the
plain PyTorch version's separate elementwise kernels do. Without it the IoU
kernel's shoelace sums (products of coordinates of ~30 m that cancel to
areas of a few m^2) drift from the plain version by 1e-4 at the reference
geometry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> Dict[str, str]:
    return {
        f[:-3]: os.path.join(CSRC, f) for f in sorted(os.listdir(CSRC)) if f.endswith(".cu")
    }


def _target(src: str) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    name = os.path.basename(src)[:-3]
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source that has no up-to-date library; returns name -> path.

    Raises with the compiler's output if any build fails.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources = _sources()
    targets = {name: _target(src) for name, src in sources.items()}
    procs = {}
    for name, src in sources.items():
        out = targets[name]
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, targets[name])  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all kernels if needed."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build_all()[name])
    return _libs[name]

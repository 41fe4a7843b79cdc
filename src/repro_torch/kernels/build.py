"""Build the CUDA sources under ``csrc/`` into shared libraries, at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface; ``nvcc`` compiles it for
``sm_90a`` into ``build/kernels/<name>-<digest>.so`` at the root of the
checkout (``.gitignore`` lists ``build/``), where ``<digest>`` hashes the
source and the flags, so an edited source builds anew.  The library is loaded
with ``ctypes``.  The compiler's output (``-Xptxas -v``: registers, shared
memory, spills) is kept beside it and returned by :func:`build_log`.

Nothing here runs at import: the CPU has no ``nvcc``, and the wrappers call
:func:`load` only for tensors on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the CUDA "
                       "toolkit is needed to build the port's kernels")


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    stem = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def nvcc_command(name: str, out: Path) -> List[str]:
    src, _, _ = _paths(name)
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source's library exists."""
    _, so, log = _paths(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(name, Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def build_log(name: str) -> str:
    """The compiler's output from the build of ``name`` (ptxas resources)."""
    _, _, log = _paths(name)
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib

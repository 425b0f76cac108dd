"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``; ``build_all`` starts every compiler at once.  No
PyTorch headers are compiled, so a build takes seconds.  The libraries
go into ``synthanatomy_tpu_torch/.build/`` (listed in ``.gitignore``)
under names keyed by a hash of the source, the shared headers and the
flags, at first use: a fresh checkout builds everything it needs on its
own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["SMEM_PER_BLOCK", "build_all", "load_library", "ptxas_report", "sources"]

# bytes of dynamic shared memory one block may take on Hopper (sm_90)
SMEM_PER_BLOCK = 232448

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / ".build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return [p.stem for p in sorted(_CSRC.glob("*.cu"))]


def _library_path(name: str) -> Path:
    """Where the library built from the current source, headers and flags lives."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> None:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together; raises with the compiler's output if
    any fails."""
    todo = [n for n in (names or sources()) if not _library_path(n).exists()]
    if not todo:
        return
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
        jobs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}\n{err}")
            continue
        lib = _library_path(name)
        lib.with_suffix(".ptxas.txt").write_text(err)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per hash) and load it."""
    build_all([name])
    return ctypes.CDLL(str(_library_path(name)))


def ptxas_report() -> str:
    """What ``ptxas -v`` said when the current libraries were built
    (registers, shared memory and spills per kernel)."""
    reports = [_library_path(n).with_suffix(".ptxas.txt") for n in sources()]
    return "".join(r.read_text() for r in reports if r.exists())

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

__all__ = ["SMEM_PER_BLOCK", "build_all", "load_library", "ptxas_report", "sass", "sources"]

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


def _source(name) -> Path:
    """``csrc/<name>.cu``, or ``name`` itself where it is a path to a
    ``.cu`` elsewhere (built against the port's headers)."""
    return name if isinstance(name, Path) else _CSRC / f"{name}.cu"


def _library_path(name) -> Path:
    """Where the library built from the current source, headers and flags lives."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in [_source(name), *sorted(_CSRC.glob("*.cuh")), *sorted(_CSRC.glob("*.h"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return _BUILD_DIR / f"lib{_source(name).stem}_{digest.hexdigest()[:16]}.so"


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
        cmd = [nvcc, *_FLAGS, f"-I{_CSRC}", "-o", tmp, str(_source(name))]
        jobs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc {_source(name).name} failed ({proc.returncode}):\n{out}\n{err}")
            continue
        lib = _library_path(name)
        lib.with_suffix(".ptxas.txt").write_text(err)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load_library(name) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu``, or the ``.cu`` at the path ``name`` (once
    per hash), and load it."""
    build_all([name])
    return ctypes.CDLL(str(_library_path(name)))


def ptxas_report() -> str:
    """What ``ptxas -v`` said when the current libraries were built
    (registers, shared memory and spills per kernel)."""
    reports = [_library_path(n).with_suffix(".ptxas.txt") for n in sources()]
    return "".join(r.read_text() for r in reports if r.exists())


def ptxas_kernels(name: str) -> dict:
    """Per kernel of ``csrc/<name>.cu``'s library: {mangled name: {"registers",
    "spill_stores", "spill_loads", "stack"}} from what ``ptxas -v`` said."""
    import re

    report = _library_path(name).with_suffix(".ptxas.txt")
    out, cur = {}, None
    for line in report.read_text().splitlines() if report.exists() else []:
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def sass(name: str) -> dict:
    """{mangled kernel name: (demangled name, its SASS)} of ``csrc/<name>.cu``'s
    library, by the toolkit's ``cuobjdump -sass`` and ``cu++filt`` (built
    first if missing)."""
    build_all([name])
    bin_dir = os.path.dirname(_nvcc())
    text = subprocess.run([os.path.join(bin_dir, "cuobjdump"), "-sass", str(_library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    parts = [part.partition("\n") for part in text.split("Function : ")[1:]]
    names = [head.strip() for head, _, _ in parts]
    plain = subprocess.run([os.path.join(bin_dir, "cu++filt")], input="\n".join(names),
                           capture_output=True, text=True, check=True).stdout.splitlines()
    labels = [(p[:p.rfind("(")] if p.endswith(")") else p).replace("void ", "", 1)
              .replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
              .replace("(int)", "") for p in plain]
    return {n: (label, body) for n, label, (_, _, body) in zip(names, labels, parts)}

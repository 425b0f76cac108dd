"""ctypes bindings for the native (C++) data-path components.

The port's own copy of ``synthanatomy_tpu/native``.  Builds
``nifti_loader.cpp`` on demand with g++ into
``synthanatomy_tpu_torch/.build/`` (listed in ``.gitignore``), under a
name keyed by a hash of the source, and exposes
:func:`load_nifti_native` with the same contract as the pure-Python
``synthanatomy_tpu_torch.data.nifti.load_nifti`` — fused gzip inflate +
dtype→float32 + scl scaling + optional [0,1] normalization in one C++
pass.  Falls back cleanly (raises ``NativeUnavailable``) when no
compiler is present; callers keep the Python path as fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = ["load_nifti_native", "native_available", "NativeUnavailable"]


class NativeUnavailable(RuntimeError):
    pass


_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "nifti_loader.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), ".build")
_lock = threading.Lock()
_lib = None
_failed: Optional[str] = None


def _library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libsat_nifti_{digest}.so")


def _build(so: str) -> None:
    """Compile into a private name, then rename: processes that build at
    once never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    # libdeflate's single-shot gzip decompressor is 2-3x zlib; optional
    for extra in (["-lz", "-ldeflate", "-DHAVE_LIBDEFLATE"], ["-lz"]):
        proc = subprocess.run(base + extra, capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, so)
            return
    raise NativeUnavailable(f"native build failed:\n{proc.stderr}")


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return _lib
        if _failed is not None:
            raise NativeUnavailable(_failed)
        try:
            so = _library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            lib.sat_nifti_shape.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.sat_nifti_shape.restype = ctypes.c_int
            lib.sat_load_nifti.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
            ]
            lib.sat_load_nifti.restype = ctypes.c_int
            lib.sat_load_nifti_v2.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.sat_load_nifti_v2.restype = ctypes.c_int
            _lib = lib
            return _lib
        except Exception as e:  # compiler missing, load error, ...
            _failed = str(e)
            raise NativeUnavailable(_failed) from e


def native_available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


_ERRORS = {
    -1: "cannot open file",
    -2: "bad NIfTI-1 header",
    -3: "unsupported datatype",
    -4: "volume larger than buffer",
    -5: "truncated payload",
}


def load_nifti_native(
    path: str, *, normalize: bool = False, canonical: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a `.nii`/`.nii.gz` file natively.

    Returns ``(volume float32 (X, Y, Z) C-contiguous, affine (4, 4))``,
    matching the Python reader's output.  With ``canonical=True`` the
    volume is reoriented to closest-canonical RAS and the affine
    rebuilt accordingly (``data.nifti.closest_canonical`` equivalent) —
    all inside the C++ gather pass, no extra numpy copies.
    """
    lib = _load()
    shape = (ctypes.c_int64 * 3)()
    rc = lib.sat_nifti_shape(path.encode(), shape)
    if rc != 0:
        raise IOError(f"{path}: {_ERRORS.get(rc, rc)}")
    n = shape[0] * shape[1] * shape[2]
    out = np.empty(n, np.float32)
    affine = np.empty(16, np.float32)
    ornt = np.empty(6, np.int32)
    rc = lib.sat_load_nifti_v2(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        shape,
        affine.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        1 if normalize else 0,
        1 if canonical else 0,
        ornt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise IOError(f"{path}: {_ERRORS.get(rc, rc)}")
    vol = out.reshape((shape[0], shape[1], shape[2]))
    aff = affine.reshape(4, 4).astype(np.float64)
    if canonical:
        from synthanatomy_tpu_torch.data.nifti import canonical_affine

        ornt2 = ornt.reshape(3, 2).astype(np.float64)
        in_shape = tuple(
            int(shape[int(ornt2[a, 0])]) for a in range(3)
        )
        aff = canonical_affine(aff, ornt2, in_shape)
    return vol, aff

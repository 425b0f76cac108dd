"""First-party NIfTI-1 reader/writer (no nibabel in this environment).

Replaces the reference's ``LoadImaged(reader="NibabelReader",
as_closest_canonical=...)`` (src/utils/vqvae.py:206-210).  Supports the
subset the pipeline needs: `.nii` / `.nii.gz`, the common datatypes,
scl_slope/inter scaling, sform/qform affines, and
``as_closest_canonical`` reorientation to RAS (nibabel-equivalent
``io_orientation`` + ``apply_orientation`` math).

The port's own copy of ``synthanatomy_tpu/data/nifti.py``.  One change:
``.nii.gz`` files are written at gzip level 1, nibabel's default and so
the reference's writer's, where the JAX copy takes ``gzip.open``'s 9.
Level 9 spends minutes on a bf16 reconstruction (few distinct values,
long match chains) and gains a few percent of size; the bytes it
decodes to are the same.
"""

from __future__ import annotations

import functools
import gzip
import struct
from typing import Optional

import numpy as np

__all__ = [
    "load_nifti",
    "save_nifti",
    "closest_canonical",
    "canonical_affine",
    "NiftiImage",
]

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class NiftiImage:
    """Minimal in-memory NIfTI volume: data + affine."""

    def __init__(self, data: np.ndarray, affine: np.ndarray):
        self.data = data
        self.affine = affine

    @property
    def shape(self):
        return self.data.shape


def _quaternion_to_affine(b, c, d, qx, qy, qz, pixdim, qfac):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    Z = np.diag([pixdim[0], pixdim[1], pixdim[2] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R @ Z
    aff[:3, 3] = [qx, qy, qz]
    return aff


def load_nifti(path: str, *, as_closest_canonical: bool = True) -> NiftiImage:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()

    if len(raw) < 348:
        raise ValueError(f"{path}: too short for a NIfTI-1 header")
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    byte_order = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        byte_order = ">"

    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(byte_order + "8h", raw, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + max(ndim, 3)])
    # squeeze trailing singleton dims beyond 3
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]

    (datatype,) = struct.unpack_from(byte_order + "h", raw, 70)
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(byte_order)

    pixdim = struct.unpack_from(byte_order + "8f", raw, 76)
    (vox_offset,) = struct.unpack_from(byte_order + "f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from(byte_order + "2f", raw, 112)
    qform_code, sform_code = struct.unpack_from(byte_order + "2h", raw, 252)

    n = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=dtype, count=n, offset=int(vox_offset)
    ).reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    else:
        data = np.asarray(data)

    if sform_code > 0:
        srow = np.array(
            [
                struct.unpack_from(byte_order + "4f", raw, 280),
                struct.unpack_from(byte_order + "4f", raw, 296),
                struct.unpack_from(byte_order + "4f", raw, 312),
                [0, 0, 0, 1],
            ]
        )
        affine = srow
    elif qform_code > 0:
        b, c, d = struct.unpack_from(byte_order + "3f", raw, 256)
        qx, qy, qz = struct.unpack_from(byte_order + "3f", raw, 268)
        qfac = -1.0 if pixdim[0] < 0 else 1.0
        affine = _quaternion_to_affine(b, c, d, qx, qy, qz, pixdim[1:4], qfac)
    else:
        affine = np.diag(list(pixdim[1:4]) + [1.0])

    img = NiftiImage(data, affine)
    if as_closest_canonical:
        img = closest_canonical(img)
    return img


def _io_orientation(affine: np.ndarray) -> np.ndarray:
    """(3, 2) array of (output_axis, flip) per input axis — the greedy
    dominant-direction assignment (nibabel ``io_orientation``
    equivalent for non-degenerate affines)."""
    R = affine[:3, :3].astype(np.float64).copy()
    # normalize columns (zoom removal)
    zooms = np.sqrt((R**2).sum(axis=0))
    zooms[zooms == 0] = 1
    Rn = R / zooms
    ornt = np.full((3, 2), np.nan)
    A = np.abs(Rn.copy())
    for _ in range(3):
        i, j = np.unravel_index(np.argmax(A), A.shape)  # output i ← input j
        ornt[j, 0] = i
        ornt[j, 1] = 1.0 if Rn[i, j] >= 0 else -1.0
        A[i, :] = -1
        A[:, j] = -1
    return ornt


def canonical_affine(
    affine: np.ndarray, ornt: np.ndarray, in_shape
) -> np.ndarray:
    """Rebuild the affine after a (flip, permute) reorientation given
    the ``_io_orientation`` table and the ORIGINAL data shape —
    ``aff' = aff @ t @ p`` (shared with the native loader's canonical
    path, which does the data movement in C++)."""
    t = np.eye(4)
    for ax in range(3):
        if ornt[ax, 1] < 0:
            t[ax, ax] = -1
            t[ax, 3] = in_shape[ax] - 1
    p = np.zeros((4, 4))
    p[3, 3] = 1
    for in_ax in range(3):
        p[in_ax, int(ornt[in_ax, 0])] = 1
    return affine @ t @ p


def closest_canonical(img: NiftiImage) -> NiftiImage:
    """Reorient data + affine to the closest RAS axes (nibabel
    ``as_closest_canonical``)."""
    ornt = _io_orientation(img.affine)
    data = img.data
    shape = data.shape[:3]

    # flip axes with negative direction
    for ax in range(3):
        if ornt[ax, 1] < 0:
            data = np.flip(data, axis=ax)
    # permute so input axis ax maps to output ornt[ax,0]
    perm = np.argsort(ornt[:, 0])  # input axes sorted by output position
    extra = tuple(range(3, data.ndim))
    data = np.transpose(data, tuple(perm) + extra)

    # data' [i_out] = data[perm[i_out]] ; affine' maps out-voxels to world
    affine = canonical_affine(img.affine, ornt, shape)
    return NiftiImage(np.ascontiguousarray(data), affine)


def save_nifti(
    path: str, data: np.ndarray, affine: Optional[np.ndarray] = None
) -> None:
    """Write a NIfTI-1 file (.nii or .nii.gz) with an sform affine."""
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    ndim = data.ndim
    dims = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *zooms, *([1.0] * (7 - 3)))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform=0, sform=1
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    opener = functools.partial(gzip.open, compresslevel=1) if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)

"""3D→1D sequence orderings for the autoregressive prior (NumPy).

The port's own copy of ``synthanatomy_tpu/models/ordering.py``, which
holds no JAX: ``Ordering`` (raster, S-curve, random and generalized
Hilbert curves with the transpose / rotate / reflect template
transformations), ``gilbert2d``, ``gilbert3d``, ``ORDERING_TYPES`` and
``TRANSFORMATION_TYPES``.  The permutations are bit-identical to the JAX
package's (``tests/test_torch_vqvae_train.py`` holds them against it).
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

__all__ = [
    "Ordering",
    "gilbert2d",
    "gilbert3d",
    "ORDERING_TYPES",
    "TRANSFORMATION_TYPES",
]

ORDERING_TYPES = ("raster_scan", "s_curve", "random", "hilbert_curve")
# The reference CLI enum value is "hilbert_curve"
# (img2seq_ordering.py:15); "hilbert" is kept as an accepted alias.
_ORDERING_ALIASES = {"hilbert": "hilbert_curve"}
TRANSFORMATION_TYPES = ("rotate_90", "transpose", "reflect")


# ---------------------------------------------------------------------------
# Generalized Hilbert ("gilbert") space-filling curves for arbitrary
# rectangles / cuboids.  Algorithm: recursive halving along the longest
# axis with parity correction so sub-curves stay connected (Červený's
# generalized-Hilbert construction; reference vendors the same public
# algorithm at gilbert/gilbert2d.py:6-69 and gilbert/gilbert3d.py:6-167).
# This is an independent implementation using integer vectors.
# ---------------------------------------------------------------------------


def _sgn(v: int) -> int:
    return (v > 0) - (v < 0)


def _vsgn(vec: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(_sgn(c) for c in vec)


def _vlen(vec: Tuple[int, ...]) -> int:
    return abs(sum(vec))


def _vadd(u, v):
    return tuple(a + b for a, b in zip(u, v))


def _vsub(u, v):
    return tuple(a - b for a, b in zip(u, v))


def _vneg(u):
    return tuple(-a for a in u)


def _vhalf(u):
    return tuple(a // 2 for a in u)


def gilbert2d(width: int, height: int) -> Iterator[Tuple[int, int]]:
    """Yield (x, y) cells of a generalized Hilbert curve over a
    ``width × height`` grid.  Every cell is visited exactly once and
    consecutive cells are 4-neighbours."""
    if width >= height:
        yield from _gilbert2d_rec((0, 0), (width, 0), (0, height))
    else:
        yield from _gilbert2d_rec((0, 0), (0, height), (width, 0))


def _gilbert2d_rec(p, a, b):
    w, h = _vlen(a), _vlen(b)
    da, db = _vsgn(a), _vsgn(b)

    if h == 1:
        for _ in range(w):
            yield p
            p = _vadd(p, da)
        return
    if w == 1:
        for _ in range(h):
            yield p
            p = _vadd(p, db)
        return

    a2, b2 = _vhalf(a), _vhalf(b)
    w2, h2 = _vlen(a2), _vlen(b2)

    if 2 * w > 3 * h:
        if (w2 % 2) and (w > 2):
            a2 = _vadd(a2, da)
        # long case: split along the major axis only
        yield from _gilbert2d_rec(p, a2, b)
        yield from _gilbert2d_rec(_vadd(p, a2), _vsub(a, a2), b)
    else:
        if (h2 % 2) and (h > 2):
            b2 = _vadd(b2, db)
        # standard case: U-shaped traversal of three sub-rectangles
        yield from _gilbert2d_rec(p, b2, a2)
        yield from _gilbert2d_rec(_vadd(p, b2), a, _vsub(b, b2))
        yield from _gilbert2d_rec(
            _vadd(p, _vadd(_vsub(a, da), _vsub(b2, db))),
            _vneg(b2),
            _vneg(_vsub(a, a2)),
        )


def gilbert3d(width: int, height: int, depth: int) -> Iterator[Tuple[int, int, int]]:
    """Yield (x, y, z) cells of a generalized Hilbert curve over a
    ``width × height × depth`` cuboid (all cells once, unit steps)."""
    if width >= height and width >= depth:
        yield from _gilbert3d_rec(
            (0, 0, 0), (width, 0, 0), (0, height, 0), (0, 0, depth)
        )
    elif height >= width and height >= depth:
        yield from _gilbert3d_rec(
            (0, 0, 0), (0, height, 0), (width, 0, 0), (0, 0, depth)
        )
    else:
        yield from _gilbert3d_rec(
            (0, 0, 0), (0, 0, depth), (width, 0, 0), (0, height, 0)
        )


def _gilbert3d_rec(p, a, b, c):
    w, h, d = _vlen(a), _vlen(b), _vlen(c)
    da, db, dc = _vsgn(a), _vsgn(b), _vsgn(c)

    # degenerate: a single row along one axis
    if h == 1 and d == 1:
        for _ in range(w):
            yield p
            p = _vadd(p, da)
        return
    if w == 1 and d == 1:
        for _ in range(h):
            yield p
            p = _vadd(p, db)
        return
    if w == 1 and h == 1:
        for _ in range(d):
            yield p
            p = _vadd(p, dc)
        return

    a2, b2, c2 = _vhalf(a), _vhalf(b), _vhalf(c)
    w2, h2, d2 = _vlen(a2), _vlen(b2), _vlen(c2)

    # parity fixes keep sub-curve endpoints adjacent
    if (w2 % 2) and (w > 2):
        a2 = _vadd(a2, da)
    if (h2 % 2) and (h > 2):
        b2 = _vadd(b2, db)
    if (d2 % 2) and (d > 2):
        c2 = _vadd(c2, dc)

    if (2 * w > 3 * h) and (2 * w > 3 * d):
        # wide case: split along the major axis only
        yield from _gilbert3d_rec(p, a2, b, c)
        yield from _gilbert3d_rec(_vadd(p, a2), _vsub(a, a2), b, c)
    elif 3 * h > 4 * d:
        # tall case: three sub-cuboids
        yield from _gilbert3d_rec(p, b2, c, a2)
        yield from _gilbert3d_rec(_vadd(p, b2), a, _vsub(b, b2), c)
        yield from _gilbert3d_rec(
            _vadd(p, _vadd(_vsub(a, da), _vsub(b2, db))),
            _vneg(b2),
            c,
            _vneg(_vsub(a, a2)),
        )
    elif 3 * d > 4 * h:
        # deep case: three sub-cuboids
        yield from _gilbert3d_rec(p, c2, a2, b)
        yield from _gilbert3d_rec(_vadd(p, c2), a, b, _vsub(c, c2))
        yield from _gilbert3d_rec(
            _vadd(p, _vadd(_vsub(a, da), _vsub(c2, dc))),
            _vneg(c2),
            _vneg(_vsub(a, a2)),
            b,
        )
    else:
        # regular case: split into five sub-cuboids
        yield from _gilbert3d_rec(p, b2, c2, a2)
        yield from _gilbert3d_rec(_vadd(p, b2), c, a2, _vsub(b, b2))
        yield from _gilbert3d_rec(
            _vadd(p, _vadd(_vsub(b2, db), _vsub(c, dc))),
            a,
            _vneg(b2),
            _vneg(_vsub(c, c2)),
        )
        yield from _gilbert3d_rec(
            _vadd(p, _vadd(_vsub(a, da), _vadd(b2, _vsub(c, dc)))),
            _vneg(c),
            _vneg(_vsub(a, a2)),
            _vsub(b, b2),
        )
        yield from _gilbert3d_rec(
            _vadd(p, _vadd(_vsub(a, da), _vsub(b2, db))),
            _vneg(b2),
            c2,
            _vneg(_vsub(a, a2)),
        )


# ---------------------------------------------------------------------------
# Ordering
# ---------------------------------------------------------------------------


class Ordering:
    """Builds a fixed permutation linearizing a 2D/3D latent grid into a
    token sequence, plus its inverse.

    Mirrors the capability of the reference ``Ordering``
    (img2seq_ordering.py:24-201): an index template
    ``arange(prod(dims)).reshape(dims)`` is optionally transformed by a
    user-ordered chain of template transformations, then linearized by
    the chosen curve.  Because JAX programs need static gather indices,
    the permutation is a host-side ``np.ndarray`` that callers bake into
    jitted fns as a constant.

    Args:
      ordering_type: one of ``ORDERING_TYPES``.
      spatial_dims: 2 or 3.
      dimensions: grid shape, either ``(H, W[, D])`` or with a leading
        batch/channel dim of 1 (``(1, H, W[, D])``) as the reference
        accepts.
      reflected_spatial_dims: per-axis bools; reflect (flip) that axis.
      transpositions_axes: sequence of axis pairs to swap.
      rot90_axes: sequence of axis pairs for 90° rotations.
      transformation_order: order in which the three template
        transformations are applied; subset of TRANSFORMATION_TYPES,
        no duplicates.
      seed: RNG seed for the ``random`` ordering (deterministic).
    """

    def __init__(
        self,
        ordering_type: str,
        spatial_dims: int,
        dimensions: Sequence[int],
        reflected_spatial_dims: Sequence[bool] = (),
        transpositions_axes: Sequence[Tuple[int, ...]] = (),
        rot90_axes: Sequence[Tuple[int, ...]] = (),
        transformation_order: Sequence[str] = ("transpose", "rotate_90", "reflect"),
        seed: int = 0,
    ):
        ordering_type = _ORDERING_ALIASES.get(ordering_type, ordering_type)
        if ordering_type not in ORDERING_TYPES:
            raise ValueError(
                f"ordering_type must be one of {ORDERING_TYPES}, got {ordering_type!r}"
            )
        if spatial_dims not in (2, 3):
            raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")

        dimensions = tuple(int(d) for d in dimensions)
        if len(dimensions) == spatial_dims + 1:
            if dimensions[0] != 1:
                raise ValueError(
                    "leading (batch/channel) dimension must be 1, got "
                    f"{dimensions}"
                )
            dimensions = dimensions[1:]
        if len(dimensions) != spatial_dims:
            raise ValueError(
                f"dimensions {dimensions} incompatible with spatial_dims={spatial_dims}"
            )

        seen = set()
        for t in transformation_order:
            if t not in TRANSFORMATION_TYPES:
                raise ValueError(f"unknown transformation {t!r}")
            if t in seen:
                raise ValueError(f"duplicated transformation {t!r}")
            seen.add(t)

        self.ordering_type = ordering_type
        self.spatial_dims = spatial_dims
        self.dimensions = dimensions
        self._seed = seed

        template = np.arange(int(np.prod(dimensions)), dtype=np.int64).reshape(
            dimensions
        )
        for name in transformation_order:
            if name == "transpose":
                for axes in transpositions_axes:
                    # Reference semantics (img2seq_ordering.py:107-111):
                    # np.transpose with a FULL axes permutation (the paper
                    # config passes ((2,0,1),)).  A 2-tuple on a 3D grid is
                    # additionally accepted as an axis swap.
                    if len(axes) == template.ndim:
                        template = np.transpose(template, axes=axes)
                    elif len(axes) == 2:
                        template = np.swapaxes(template, *axes)
                    else:
                        raise ValueError(
                            f"transposition axes {axes} incompatible with "
                            f"template of rank {template.ndim}"
                        )
            elif name == "rotate_90":
                for axes in rot90_axes:
                    template = np.rot90(template, axes=axes)
            elif name == "reflect":
                flip_axes = [
                    i for i, f in enumerate(reflected_spatial_dims) if f
                ]
                if flip_axes:
                    template = np.flip(template, axis=flip_axes)
        self._template = template

        self._sequence_ordering = self._linearize(template)
        self._revert_ordering = np.argsort(self._sequence_ordering)

    # -- curve linearizations ------------------------------------------------

    def _linearize(self, template: np.ndarray) -> np.ndarray:
        if self.ordering_type == "raster_scan":
            return template.reshape(-1).copy()
        if self.ordering_type == "s_curve":
            return self._s_curve(template)
        if self.ordering_type == "random":
            rng = np.random.default_rng(self._seed)
            flat = template.reshape(-1).copy()
            rng.shuffle(flat)
            return flat
        # hilbert_curve
        shape = template.shape
        if len(shape) == 2:
            coords = gilbert2d(shape[0], shape[1])
        else:
            coords = gilbert3d(shape[0], shape[1], shape[2])
        return np.array([template[c] for c in coords], dtype=np.int64)

    @staticmethod
    def _s_curve(template: np.ndarray) -> np.ndarray:
        """Serpentine scan with the reference's exact traversal
        (``img2seq_ordering.py:158-177``): the column axis reverses on
        odd *rows*, and the depth axis reverses on odd *column values*
        (the actual column index, not the iteration position — so after
        a reversed column sweep the depth direction is keyed to ``c``,
        which is what makes trained-checkpoint orderings bit-compatible)."""
        t = template
        if t.ndim == 2:
            rows = [t[r, :] if r % 2 == 0 else t[r, ::-1] for r in range(t.shape[0])]
            return np.concatenate(rows)
        out = []
        for r in range(t.shape[0]):
            cols = (
                range(t.shape[1])
                if r % 2 == 0
                else range(t.shape[1] - 1, -1, -1)
            )
            for c in cols:
                out.append(t[r, c, :] if c % 2 == 0 else t[r, c, ::-1])
        return np.concatenate(out)

    # -- public API ------------------------------------------------------

    def get_sequence_ordering(self) -> np.ndarray:
        """Permutation ``perm`` with ``seq = flat_grid[perm]``."""
        return self._sequence_ordering

    def get_revert_sequence_ordering(self) -> np.ndarray:
        """Inverse permutation with ``flat_grid = seq[revert]``."""
        return self._revert_ordering

    @property
    def template(self) -> np.ndarray:
        return self._template

    def __call__(self, x):
        """Reorder the last-but-batch flat axis of ``x`` by the sequence
        ordering (works on ``np.ndarray`` and ``torch.Tensor``)."""
        return x[self._sequence_ordering]

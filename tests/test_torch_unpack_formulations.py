"""The four nibble-unpack formulations of row 9b (``probes.unpack_int4_plain``,
the plain twins of ``csrc/int4_unpack.cu``) on every one of the 256 byte
values, held exactly against the JAX probe's arithmetic.

``tools/probe_int4_unpack.py`` defines its formulations inside ``main``;
they are written out here as it has them (A ``unpack_bits_i32``, B
``unpack_arith_i32``, C ``unpack_float``, D ``unpack_bits_i8``), and each
plain twin must equal its own JAX formulation and A's arithmetic, the
one the probe's E and F bodies and ``quant.unpack_int4`` use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu_torch.ops import probes


def unpack_bits_i32(p8):
    p = p8.astype(jnp.int32)
    lo = ((p & 15) ^ 8) - 8
    hi = (((p >> 4) & 15) ^ 8) - 8
    return lo.astype(jnp.float32), hi.astype(jnp.float32)


def unpack_arith_i32(p8):
    p = p8.astype(jnp.int32)
    pu = p - 256 * jnp.floor_divide(p, 256)
    hu = jnp.floor_divide(pu, 16)
    lu = pu - 16 * hu
    lo = lu - 16 * jnp.floor_divide(lu + 8, 16)
    hi = hu - 16 * jnp.floor_divide(hu + 8, 16)
    return lo.astype(jnp.float32), hi.astype(jnp.float32)


def unpack_float(p8):
    p = p8.astype(jnp.float32)
    pu = p - 256.0 * jnp.floor(p / 256.0)
    hu = jnp.floor(pu / 16.0)
    lu = pu - 16.0 * hu
    lo = lu - 16.0 * jnp.floor((lu + 8.0) / 16.0)
    hi = hu - 16.0 * jnp.floor((hu + 8.0) / 16.0)
    return lo, hi


def unpack_bits_i8(p8):
    lo = ((p8 & jnp.int8(15)) ^ jnp.int8(8)) - jnp.int8(8)
    hi = (((p8 >> 4) & jnp.int8(15)) ^ jnp.int8(8)) - jnp.int8(8)
    return lo.astype(jnp.float32), hi.astype(jnp.float32)


JAX_FORMULATIONS = (unpack_bits_i32, unpack_arith_i32, unpack_float, unpack_bits_i8)
EVERY_BYTE = np.arange(256, dtype=np.uint8).view(np.int8).reshape(16, 16)


def _jax(fn, packed):
    lo, hi = fn(jnp.asarray(packed))
    return np.concatenate([np.asarray(lo), np.asarray(hi)]).astype(np.float32)


@pytest.mark.parametrize("variant", range(4), ids=[v[0] for v in probes.UNPACK_VARIANTS])
def test_every_byte_equals_the_jax_probe(variant):
    """All 256 bytes: the plain twin equals its JAX formulation and A's
    int32 arithmetic bit for bit; the low nibble and the high nibble each
    take every value of -8 … 7 sixteen times."""
    got = probes.unpack_int4_plain(torch.from_numpy(EVERY_BYTE), variant).numpy()
    assert got.dtype == np.float32 and got.shape == (32, 16)
    np.testing.assert_array_equal(got, _jax(JAX_FORMULATIONS[variant], EVERY_BYTE))
    np.testing.assert_array_equal(got, _jax(unpack_bits_i32, EVERY_BYTE))
    for half in (got[:16], got[16:]):
        values, counts = np.unique(half, return_counts=True)
        assert values.tolist() == list(range(-8, 8)) and (counts == 16).all()

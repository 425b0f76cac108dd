"""Row 2 (``int8_matmul``) and the decode-side probes (rows 9a-9c) of the
port against the JAX package, on the CPU, where every wrapper takes its
plain twin.  The CUDA kernels are held against the same twins on the
card by tests/test_torch_kernels_gpu.py and chip_smoke.py.

- ``int8_matmul_plain`` (the kernel's arithmetic: bf16(x)·bf16(w_q) in
  f32, then × scale) against a ``pallas_call`` of JAX's own kernel body
  ``quant._kernel`` in interpret mode, with the block specs of
  ``_int8_matmul_pallas`` (no VMEM memory spaces): f32 rounding
  (rtol 1e-6).  Against JAX's public ``int8_matmul``, which on the CPU
  runs ``int8_matmul_ref`` and rounds w·scale to bf16 BEFORE the product
  (``quant.py:97``): that rounding is a deliberate difference of the two
  JAX paths, so the bound is 2^-8 relative (rtol 1e-2 of the output
  scale).  The port's ``int8_matmul_ref`` equals JAX's exactly.
- The four unpack formulations equal JAX's ``quant.unpack_int4`` on every
  byte value, exactly.
- The probes' plain chains against numpy copies of each probe's own XLA
  reference formula (they live inside the probes' ``main`` and cannot be
  imported): exact bf16 products summed in f32, rtol 1e-5.
- The probe CLIs run end to end with ``--cpu`` at small shapes.

Packed bytes are built as uint8 and viewed as int8: numpy's cast of
128-255 to int8 is not two's complement on every platform.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from synthanatomy_tpu.ops import quant as jq
from synthanatomy_tpu_torch.ops import probes, quant
from synthanatomy_tpu_torch.tools import (
    bench_decode_quant,
    probe_int4,
    probe_int4_unpack,
    probe_pallas_overhead,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _int8_case(r, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(r, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    w_q, scale = jq.quantize_int8(jnp.asarray(w))
    return x, np.array(w_q), np.array(scale)


def _pallas_int8(x, w_q, scale, block_n):
    """JAX's kernel body under the launcher's block specs, interpreted."""
    r, k = x.shape
    n = w_q.shape[1]
    return pl.pallas_call(
        jq._kernel,
        grid=(n // block_n,),
        in_specs=[pl.BlockSpec((r, k), lambda j: (0, 0)),
                  pl.BlockSpec((k, block_n), lambda j: (0, j)),
                  pl.BlockSpec((1, block_n), lambda j: (0, j))],
        out_specs=pl.BlockSpec((r, block_n), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((r, n), jnp.float32),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale))


@pytest.mark.parametrize("r,k,n,block_n", [(8, 64, 256, 128), (16, 512, 1024, 512)])
def test_int8_matmul_plain_matches_pallas_kernel(r, k, n, block_n):
    x, w_q, scale = _int8_case(r, k, n, r + k)
    want = np.asarray(_pallas_int8(x, w_q, scale, block_n))
    got = quant.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(w_q),
                                  torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("r,k,n", [(16, 512, 2048), (1, 200, 96), (5, 64, 1000), (33, 128, 256)])
def test_int8_matmul_matches_jax_public_op(r, k, n):
    x, w_q, scale = _int8_case(r, k, n, 7 * r + n)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale)))
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale))
    assert quant.int8_matmul.launches == before  # a CPU tensor launches nothing
    assert got.dtype == torch.float32 and got.shape == (r, n)
    # JAX rounds w·scale to bf16 before the product: 2^-8 relative
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2 * np.abs(want).max())
    ref = quant.int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(w_q),
                                torch.from_numpy(scale))
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_int8_matmul_flattens_leading_dims():
    x, w_q, scale = _int8_case(6, 32, 48, 3)
    xt = torch.from_numpy(x).reshape(2, 3, 32)
    got = quant.int8_matmul(xt, torch.from_numpy(w_q), torch.from_numpy(scale))
    flat = quant.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(w_q),
                                   torch.from_numpy(scale))
    assert got.shape == (2, 3, 48)
    torch.testing.assert_close(got.reshape(6, 48), flat, rtol=0, atol=0)


def test_int8_matmul_rejects_other_devices():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError):
        quant.int8_matmul(x, torch.zeros(8, 4, dtype=torch.int8, device="meta"),
                          torch.ones(1, 4, device="meta"))


def _packed_bytes(hi, lo):
    return (((hi & 15) << 4) | (lo & 15)).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("variant", range(4), ids=[v[0] for v in probes.UNPACK_VARIANTS])
def test_unpack_formulations_equal_jax(variant):
    rng = np.random.default_rng(variant)
    every_byte = np.arange(256, dtype=np.uint8).view(np.int8).reshape(16, 16)
    packed = np.concatenate([every_byte, _packed_bytes(rng.integers(-8, 8, (16, 16)),
                                                       rng.integers(-8, 8, (16, 16)))])
    lo, hi = jq.unpack_int4(jnp.asarray(packed))
    want = np.concatenate([np.asarray(lo), np.asarray(hi)]).astype(np.float32)
    got = probes.int4_unpack(torch.from_numpy(packed), variant)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int4_matmul_plain_matches_probe_formula():
    """The body of probe_int4_unpack's E (kernel_dot) and F (kernel_grid,
    the last of L layers), in numpy."""
    rng = np.random.default_rng(11)
    b, k, n, layers = 4, 32, 48, 3
    x = rng.normal(size=(b, k)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    hi = rng.integers(-7, 8, (layers, k // 2, n))
    lo = rng.integers(-7, 8, (layers, k // 2, n))
    packed = _packed_bytes(hi, lo)
    sc = rng.uniform(0.01, 0.02, (layers, 2, n)).astype(np.float32)
    want = ((xb[:, : k // 2] @ lo[-1].astype(np.float32)) * sc[-1, 0:1]
            + (xb[:, k // 2:] @ hi[-1].astype(np.float32)) * sc[-1, 1:2])
    got = quant.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(sc))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    one = quant.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed[-1]),
                            torch.from_numpy(sc[-1]))
    torch.testing.assert_close(one, got, rtol=0, atol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed-int4"])
def test_weight_stream_plain_matches_probe_reference(packed):
    rng = np.random.default_rng(12)
    b, k, n, layers = 4, 32, 96, 3
    x = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(torch.bfloat16)
    w_i8 = rng.integers(-7, 8, size=(layers, k, n)).astype(np.int8)
    scales = rng.uniform(0.01, 0.02, size=(layers, 1, n)).astype(np.float32)
    want = probe_int4.reference(x.float().numpy(), w_i8, scales)
    w = probe_int4.pack(w_i8) if packed else w_i8
    got = probes.weight_stream(x, torch.from_numpy(w), torch.from_numpy(scales), packed)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_probe_int4_reference_is_the_probe_formula():
    """``probe_int4.reference`` against the probe's own loop written out in
    JAX (``tools/probe_int4.py`` ``ref``)."""
    rng = np.random.default_rng(13)
    b, k, n, layers = 2, 16, 32, 2
    x = rng.normal(size=(b, k)).astype(np.float32)
    w = rng.integers(-7, 8, size=(layers, k, n)).astype(np.int8)
    s = rng.uniform(0.01, 0.02, size=(layers, 1, n)).astype(np.float32)
    acc = jnp.zeros((b, k), jnp.float32)
    for i in range(layers):
        y = (jnp.asarray(x) @ jnp.asarray(w[i]).astype(jnp.float32)) * s[i]
        acc = acc + jnp.sum(y.reshape(b, n // k, k), axis=1) * 1e-3
    np.testing.assert_allclose(probe_int4.reference(x, w, s), np.asarray(acc), rtol=1e-6,
                               atol=1e-7)


def test_tile_steps_plain_matches_probe_kernel():
    """``steps`` passes of acc += x · w, written as bf16, against the probe
    kernel's arithmetic in numpy."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32)).to(torch.bfloat16)
    acc = np.zeros((64, 64), np.float32)
    for _ in range(3):
        acc = acc + x.float().numpy() @ w.float().numpy()
    want = torch.from_numpy(acc).to(torch.bfloat16)
    got = probes.tile_steps(x, w, 3)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


def test_probe_wrappers_reject_other_devices():
    meta = torch.empty(4, 4, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        probes.int4_unpack(meta, 0)
    with pytest.raises(ValueError):
        probes.tile_steps(meta.to(torch.bfloat16), meta.to(torch.bfloat16), 1)
    with pytest.raises(ValueError):
        probes.weight_stream(meta.float(), meta[None], meta.float())


def test_probe_cli_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(probe_int4, "L", 3)
    monkeypatch.setattr(probe_int4, "N", 1024)
    res = probe_int4.main(["--cpu", "--reps", "1"])
    out = capsys.readouterr().out
    assert "int4: PyTorch has no int4 tensor type" in out and "speedup" in out
    assert res["int8"]["err"] <= probe_int4.TOL and res["packed-int4"]["err"] <= probe_int4.TOL

    res = probe_int4_unpack.main(["--cpu"])
    assert all(res[v] for v in probes.UNPACK_VARIANTS) and res["E"] == res["F"] == 0.0

    for name, value in (("M", 64), ("K_DIM", 64), ("N", 64), ("SWEEP", (2, 4))):
        monkeypatch.setattr(probe_pallas_overhead, name, value)
    res = probe_pallas_overhead.main(["--cpu", "--reps", "1"])
    out = capsys.readouterr().out
    assert "per-invocation overhead (96-call slope, eager)" in out and "graph" not in res
    assert set(res["sweep"]) == {2, 4}


def test_bench_decode_quant_cli_runs_on_cpu():
    res = bench_decode_quant.main(["--cpu", "--depth", "1", "--dim", "128", "--heads", "2",
                                   "--local-heads", "1", "--window", "6", "--grid", "2,2,2",
                                   "--batches", "2", "--reps", "1"])
    assert set(res) == {(2, "int8"), (2, "int4")} and all(v > 0 for v in res.values())

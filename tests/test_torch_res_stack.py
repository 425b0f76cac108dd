"""Port fused residual layer (synthanatomy_tpu_torch/ops/res_stack.py)
against the JAX package on the CPU: the plain twin (the CPU route of
``fused_residual_layer``) against JAX's ``residual_layer_reference`` and
against the Pallas kernels in interpret mode, forward and gradients, in
f32 and bf16.  Weights and inputs come from numpy seeds; JAX's (3, 3, 3,
C, R) / (R, C) weights and NDHWC volumes are transposed to the port's
PyTorch conv weights and NCDHW."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.ops import res_stack_pallas as jrs
from synthanatomy_tpu_torch.ops import res_stack as rs

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _make(shape, r, seed=0):
    rng = np.random.default_rng(seed)
    b, d, h, w, c = shape
    return (rng.normal(size=shape).astype(np.float32),
            (rng.normal(size=(3, 3, 3, c, r)) * 0.05).astype(np.float32),
            (rng.normal(size=(r,)) * 0.1).astype(np.float32),
            (rng.normal(size=(r, c)) * 0.05).astype(np.float32),
            (rng.normal(size=(c,)) * 0.1).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _to_port(x, w1, b1, w2, b2, dtype):
    c, r = w2.shape[1], w2.shape[0]
    return (torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous().to(dtype),
            torch.from_numpy(np.transpose(w1, (4, 3, 0, 1, 2)).copy()),
            torch.from_numpy(b1),
            torch.from_numpy(w2.T.reshape(c, r, 1, 1, 1).copy()),
            torch.from_numpy(b2))


def _port_grads(fn, args, gy, dtype):
    leaves = [a.clone().requires_grad_() for a in args]
    y = fn(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(gy).permute(0, 4, 1, 2, 3).to(dtype))
    dx, dw1, db1, dw2, db2 = (g.float().numpy() for g in grads)
    c = dw2.shape[0]
    return (y.detach().float().permute(0, 2, 3, 4, 1).numpy(), dx.transpose(0, 2, 3, 4, 1),
            dw1.transpose(2, 3, 4, 1, 0), db1, dw2.reshape(c, -1).T, db2)


def _jax_grads(fn, x, w1, b1, w2, b2, gy, dtype):
    xj = jnp.asarray(x, dtype)
    y, vjp = jax.vjp(fn, xj, *(jnp.asarray(a) for a in (w1, b1, w2, b2)))
    grads = vjp(jnp.asarray(gy, y.dtype))
    return (np.asarray(y, np.float32),) + tuple(np.asarray(g, np.float32) for g in grads)


def _close(got, want, tol, name):
    """max abs error within tol of the largest magnitude"""
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max() + 1e-7, (name, err, np.abs(want).max())


NAMES = ("y", "dx", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("shape,r", [((2, 3, 4, 5, 6), 5), ((1, 4, 6, 3, 7), 8)])
def test_plain_matches_jax_reference_f32(shape, r):
    x, w1, b1, w2, b2, gy = _make(shape, r, seed=r)
    got = _port_grads(rs.fused_residual_layer, _to_port(x, w1, b1, w2, b2, torch.float32), gy,
                      torch.float32)
    want = _jax_grads(jrs.residual_layer_reference, x, w1, b1, w2, b2, gy, jnp.float32)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, 1e-5, name)  # f32, sums in other orders


@pytest.mark.parametrize("dtype,jdtype,tol", [(torch.float32, jnp.float32, 1e-5),
                                              (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_plain_matches_pallas_interpret(dtype, jdtype, tol):
    """The Pallas kernels (forward and backward) in interpret mode at the
    shape of tests/test_res_stack_pallas.py.  bf16: both round at the
    same points but sum in other orders, so a value on a rounding
    boundary may round the other way (2^-8 relative) and move what it
    feeds; a wrong tap or mask gives errors of order 1."""
    x, w1, b1, w2, b2, gy = _make((1, 8, 8, 16, 128), 128, seed=1)
    got = _port_grads(rs.fused_residual_layer, _to_port(x, w1, b1, w2, b2, dtype), gy, dtype)
    want = _jax_grads(lambda *a: jrs.fused_residual_layer(*a, True), x, w1, b1, w2, b2, gy,
                      jdtype)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, tol, name)


def test_port_reference_matches_jax_reference_bf16():
    """``residual_layer_reference`` against JAX's, in bf16."""
    x, w1, b1, w2, b2, gy = _make((1, 6, 5, 4, 8), 8, seed=3)
    got = _port_grads(rs.residual_layer_reference,
                      _to_port(x, w1, b1, w2, b2, torch.bfloat16), gy, torch.bfloat16)
    want = _jax_grads(jrs.residual_layer_reference, x, w1, b1, w2, b2, gy, jnp.bfloat16)
    _close(got[0], want[0], 2e-2, "y")


def test_plain_bwd_matches_autograd_of_plain_fwd():
    """The plain backward formula is the gradient of the plain forward (f32)."""
    x, w1, b1, w2, b2, gy = _make((2, 5, 4, 6, 3), 4, seed=4)
    args = _to_port(x, w1, b1, w2, b2, torch.float32)
    got = _port_grads(rs.fused_residual_layer, args, gy, torch.float32)
    want = _port_grads(lambda *a: rs.residual_layer_plain(*a)[0], args, gy, torch.float32)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, 1e-5, name)


def test_no_hidden_saved_without_gradient():
    x, w1, b1, w2, b2, _ = _make((1, 3, 3, 3, 2), 3)
    with torch.no_grad():
        y = rs.fused_residual_layer(*_to_port(x, w1, b1, w2, b2, torch.float32))
    assert y.grad_fn is None and y.shape == (1, 2, 3, 3, 3)


def test_support_gate_and_refusals():
    assert rs.supports_fused_residual((3, 128, 80, 112, 80), 128)
    assert rs.supports_fused_residual((1, 3, 5, 7, 9), 5)  # no lane or sublane rule
    assert not rs.supports_fused_residual((1, 8, 8, 8), 8)
    assert not rs.supports_fused_residual((1, 8, 4, 4, 4), 513)
    assert not rs.supports_fused_residual((1, 8, 256, 256, 256), 8)  # 2^24 voxels
    x = torch.zeros(1, 4, 3, 3, 3, device="meta")
    with pytest.raises(ValueError):
        rs.fused_residual_layer(x, torch.zeros(4, 4, 3, 3, 3, device="meta"),
                                torch.zeros(4, device="meta"),
                                torch.zeros(4, 4, 1, 1, 1, device="meta"),
                                torch.zeros(4, device="meta"))


@pytest.mark.parametrize("dtype,jdtype,tol", [(torch.float32, jnp.float32, 1e-5),
                                              (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_channels_last_input_matches_ncdhw_and_jax(dtype, jdtype, tol):
    """x in channels-last memory (the format the VQ-VAE hands a fused
    stack): y, h and the gradients equal the NCDHW call's, agree with
    JAX's reference at this file's tolerances, and y and dx keep x's
    memory format."""
    cl = torch.channels_last_3d
    x, w1, b1, w2, b2, gy = _make((2, 5, 4, 6, 16), 8, seed=6)
    args = _to_port(x, w1, b1, w2, b2, dtype)
    args_cl = (args[0].contiguous(memory_format=cl),) + args[1:]
    assert args_cl[0].is_contiguous(memory_format=cl) and not args_cl[0].is_contiguous()

    got = _port_grads(rs.fused_residual_layer, args_cl, gy, dtype)
    ref = _port_grads(rs.fused_residual_layer, args, gy, dtype)
    want = _jax_grads(jrs.residual_layer_reference, x, w1, b1, w2, b2, gy, jdtype)
    for name, a, b, w in zip(NAMES, got, ref, want):
        _close(a, b, tol, name)
        _close(a, w, tol, name)
    wc = (args_cl[1].to(dtype), args_cl[2].to(dtype), args_cl[3].to(dtype), args_cl[4].to(dtype))
    _, h_cl = rs.residual_layer_plain(args_cl[0], *wc)
    _, h = rs.residual_layer_plain(args[0], *wc)
    _close(h_cl.float().numpy(), h.float().numpy(), tol, "h")

    leaves = [a.clone().requires_grad_() for a in args_cl]
    y = rs.fused_residual_layer(*leaves)
    (dx,) = torch.autograd.grad(y, leaves[:1], torch.ones_like(y))
    assert y.is_contiguous(memory_format=cl) and dx.is_contiguous(memory_format=cl)
    assert rs.kernel_layout(args_cl[0], 8) is args_cl[0]  # a CPU tensor stays as it is

"""Splash local attention in the port (synthanatomy_tpu_torch/ops/
local_attention_splash.py) against the JAX package's
``local_attention_splash``, which runs JAX's stock splash kernel here in
interpret mode.  On the CPU the port takes the kernel's plain version.

Tolerances: the JAX tests hold splash against the XLA path at atol 3e-5
in f32 (gradients: 3e-5 of the largest magnitude, at least 1); the plain
version follows splash's own rounding points and tile order, so the same
bounds hold here.  In bf16 both round q, k, v, the output and (backward)
p and ds to bf16 at the same points and differ only where an f32 sum in
another order lands a value on the other side of a bf16 rounding
boundary: one bf16 ulp (2^-8 relative) of an output, so the bound is
1e-2 of the largest output magnitude.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.splash_attention import splash_attention_mask as sm

from synthanatomy_tpu.ops import local_attention_splash as j_splash_mod
from synthanatomy_tpu.ops.local_attention_splash import local_attention_splash as j_splash
from synthanatomy_tpu_torch.ops import local_attention_splash as ts
from synthanatomy_tpu_torch.ops.local_attention import local_attention

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _drop_traced_kernels():
    """JAX's ``_make_kernel`` caches the kernel it builds, and one built
    under this file's ``jax.jit`` holds its masks as tracers; a later test
    in the same process at the same shape would reuse them.  Start and end
    each test with the cache empty."""
    j_splash_mod._make_kernel.cache_clear()
    yield
    j_splash_mod._make_kernel.cache_clear()


def _qkv(b=2, h=3, n=300, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3)]


def _jax(q, k, v, **kw):
    return np.asarray(j_splash(*(jnp.asarray(x) for x in (q, k, v)), interpret=True, **kw))


def _port(q, k, v, **kw):
    with torch.no_grad():
        return ts.local_attention_splash(*(torch.tensor(x) for x in (q, k, v)), **kw).numpy()


@pytest.mark.parametrize("window,n", [(37, 300), (64, 128), (420, 700)])
def test_forward_matches_jax_splash(window, n):
    q, k, v = _qkv(n=n)
    kw = dict(window=window, compute_dtype=jnp.float32, block_q=128, block_kv=128)
    want = _jax(q, k, v, **kw)
    got = _port(q, k, v, **dict(kw, compute_dtype=torch.float32))
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_gradients_match_jax_splash(fused):
    q, k, v = _qkv(n=200)
    kw = dict(window=37, block_q=128, block_kv=128, use_fused_bwd=fused)

    def loss(*xs):
        return jnp.sum(j_splash(*xs, compute_dtype=jnp.float32, interpret=True, **kw) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (ts.local_attention_splash(*leaves, compute_dtype=torch.float32, **kw) ** 2).sum().backward()
    for name, a, b in zip("qkv", leaves, want):
        scale = float(jnp.max(jnp.abs(b)))
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=3e-5 * max(scale, 1.0),
                                   err_msg=f"d{name}")


def test_no_rotary_and_padding_boundary():
    """n 130 pads to 256: the padded tail must not leak into real rows."""
    q, k, v = _qkv(n=130, h=2)
    kw = dict(window=17, use_rotary=False, block_q=128, block_kv=128)
    want = _jax(q, k, v, compute_dtype=jnp.float32, **kw)
    got = _port(q, k, v, compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(got, want, atol=3e-5)
    xla = local_attention(*(torch.tensor(x) for x in (q, k, v)), window=17, use_rotary=False,
                          compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, xla, atol=3e-5)


def test_bf16_matches_jax_splash():
    q, k, v = _qkv(b=1, h=2, n=300, seed=3)
    kw = dict(window=37, block_q=128, block_kv=128)
    want = _jax(q, k, v, compute_dtype=jnp.bfloat16, **kw)
    got = _port(q, k, v, compute_dtype=torch.bfloat16, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_gradients_match_jax_splash(fused):
    """bf16 gradients: p and ds rounded to bf16 before their products, and
    (fused) dq partials per key tile in bf16.  Bound: 2e-2 of each
    gradient's largest magnitude, 1e-2 in norm."""
    q, k, v = _qkv(b=1, h=2, n=260, seed=4)
    kw = dict(window=45, block_q=128, block_kv=128, use_fused_bwd=fused)

    def loss(*xs):
        out = j_splash(*xs, compute_dtype=jnp.bfloat16, interpret=True, **kw)
        return jnp.sum(out * jnp.asarray(q[..., ::-1]))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = ts.local_attention_splash(*leaves, compute_dtype=torch.bfloat16, **kw)
    (out * torch.tensor(q[..., ::-1].copy())).sum().backward()
    for name, a, b in zip("qkv", leaves, want):
        a, b = a.grad.numpy(), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * np.abs(b).max(), err_msg=f"d{name}")
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), f"d{name}"


TILE_CASES = [  # (n_pad, window, block_q, block_kv)
    (256, 37, 128, 128), (256, 1, 64, 64), (512, 600, 128, 256), (384, 128, 64, 64),
    (1536, 420, 256, 256), (1536, 420, 64, 64), (192, 64, 64, 32), (128, 129, 64, 64),
]


@pytest.mark.parametrize("case", TILE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_tile_map_matches_dense_local_mask(case):
    """Each tile pair's class equals what the dense splash LocalMask holds
    over it: no visible pair (empty), all visible (full), or some."""
    n, w, bq, bkv = case
    dense = np.asarray(sm.LocalMask((n, n), (w - 1, 0), 0)[:, :])
    blocks = dense.reshape(n // bq, bq, n // bkv, bkv).transpose(0, 2, 1, 3)
    want = np.where(blocks.all((2, 3)), ts.FULL, np.where(blocks.any((2, 3)), ts.PARTIAL, ts.EMPTY))
    np.testing.assert_array_equal(ts.tile_classes(n, w, bq, bkv), want)


@pytest.mark.parametrize("n_pad,window", [(256, 1), (1536, 420), (512, 700), (320, 128)])
def test_kernel_tile_map_lists(n_pad, window):
    """The kernel's CSR lists (built on the host, here on the CPU) hold
    every non-empty pair once in each direction, in tile order, with the
    partial flag and the pair's q-major slot."""
    tmap, nt, nnz = ts._device_map(n_pad, window, torch.device("cpu"))
    m = tmap.numpy()
    q_ptr, q_ent = m[:nt + 1], m[nt + 1:nt + 1 + nnz]
    k_ptr = m[nt + 1 + nnz:2 * nt + 2 + nnz]
    k_ent, k_slot = m[2 * nt + 2 + nnz:2 * nt + 2 + 2 * nnz], m[2 * nt + 2 + 2 * nnz:]
    cls = ts.tile_classes(n_pad, window, ts.KERNEL_TILE, ts.KERNEL_TILE)
    assert nnz == int((cls != ts.EMPTY).sum()) and k_slot.size == nnz
    pairs = {}
    for qt in range(nt):
        kts = q_ent[q_ptr[qt]:q_ptr[qt + 1]] >> 1
        np.testing.assert_array_equal(kts, np.flatnonzero(cls[qt]))
        for s in range(q_ptr[qt], q_ptr[qt + 1]):
            pairs[(qt, q_ent[s] >> 1)] = (s, q_ent[s] & 1)
    for kt in range(nt):
        for e in range(k_ptr[kt], k_ptr[kt + 1]):
            qt = k_ent[e] >> 1
            assert pairs[(qt, kt)] == (k_slot[e], k_ent[e] & 1)
            assert (k_ent[e] & 1) == (cls[qt, kt] == ts.PARTIAL)
    assert k_ptr[-1] == nnz


def test_plain_backward_matches_autograd():
    """The plain backward (the kernel's recipe) equals autograd through the
    plain forward in f32."""
    q, k, v = (torch.tensor(x) * s for x, s in zip(_qkv(1, 2, 256, seed=5), (0.125, 1, 1)))
    g = torch.tensor(_qkv(1, 2, 256, seed=6)[0])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ts.splash_attention_core(*leaves, 45, 128, 128).backward(g)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    s = (ref[0] @ ref[1].transpose(-1, -2)).masked_fill(~ts._allowed(256, 45, "cpu"),
                                                         float("-inf"))
    (torch.softmax(s, -1) @ ref[2]).backward(g)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-5 * float(b.grad.abs().max()))


def test_routing_cpu_and_non_causal():
    """A CPU tensor takes the plain version and launches nothing; a
    non-causal call takes the plain local_attention; a device without a
    kernel raises."""
    q, k, v = (torch.tensor(x) for x in _qkv(1, 2, 96, seed=7))
    before = ts.local_attention_splash.launches
    got = ts.local_attention_splash(q, k, v, window=9, compute_dtype=torch.float32)
    assert ts.local_attention_splash.launches == before
    want = local_attention(q, k, v, window=9, compute_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=3e-5)
    nc = ts.local_attention_splash(q, k, v, window=9, causal=False, compute_dtype=torch.float32)
    torch.testing.assert_close(nc, local_attention(q, k, v, window=9, causal=False,
                                                   compute_dtype=torch.float32))
    meta = torch.zeros(1, 1, 64, 64, device="meta")
    with pytest.raises(ValueError, match="no splash attention kernel"):
        ts.splash_attention_core(meta, meta, meta, 4)

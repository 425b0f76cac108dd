"""Causal FAVOR+ with fused feature maps: the CUDA kernel and its plain twin.

Port of ``synthanatomy_tpu/ops/favor_pallas.py::favor_attention_fused``
(TPU kernels ``_fwd_kernel`` :148, ``_bwd_dq_kernel`` :180,
``_bwd_dkv_kernel`` :218).  ``favor_attention_fused(q, k, v, projection,
chunk)`` takes q/k/v (B, H, L, d) in the compute dtype (bf16 or f32) and
the (m, d) projection, and returns (B, H, L, d) f32.  Softmax-kernel
features with the row-max query stabilizer and the zero key stabilizer,
a causal prefix scan over chunks; products take operands in the compute
dtype and accumulate in f32; S and z are f32 and rounded only where they
enter a product.  The backward is the TPU kernel's two sweeps: dq in
forward order recomputing the prefix (S, z), dk/dv in reverse order
carrying the suffix; the output cotangent is rounded to the compute
dtype first, as JAX rounds it, and the projection's cotangent is zeros.

A CUDA tensor launches ``csrc/favor_attention.cu`` or raises; a CPU
tensor takes the plain version (``favor_fwd_plain`` / ``favor_bwd_plain``,
the same sweeps in PyTorch at the same rounding points).  The library's
plan (``csrc/favor_plan.h``) picks the route from the shape: d a multiple
of 8 up to 64 and m up to 256 (every model of the port) take the
chunk-parallel route (``csrc/favor_core.cuh``: a state launch, the state
scan, the consumer; forward 3 launches, backward 4), the rest the earlier
one-block-per-(batch, head) kernels (forward 1, backward 2).
``favor_attention_fused.launches`` counts kernel launches;
:func:`launches_per_call` gives a forward + backward call's count.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK, load_library
from synthanatomy_tpu_torch.ops.local_attention import rounded

__all__ = [
    "favor_attention_fused",
    "favor_attention_fused_plain",
    "favor_fwd_plain",
    "favor_bwd_plain",
    "launches_per_call",
]

_EPS = 1e-4  # the feature map's epsilon


# ---------------------------------------------------------------------------
# plain PyTorch version (rows are (N, L, ·) with N = B·H)
# ---------------------------------------------------------------------------


def _features(q, k, proj, cd):
    """Feature maps of one chunk: (qp, kp, e_q, e_k, u_q), all f32."""
    d, m = q.shape[-1], proj.shape[0]
    dn, r = d ** -0.25, m ** -0.5
    p = rounded(proj, cd)
    u_q = rounded(q * dn, cd) @ p.T
    u_k = rounded(k * dn, cd) @ p.T
    diag_q = (q * q).sum(-1, keepdim=True) * (0.5 * dn * dn)
    diag_k = (k * k).sum(-1, keepdim=True) * (0.5 * dn * dn)
    e_q = torch.exp(u_q - diag_q - u_q.amax(-1, keepdim=True))
    e_k = torch.exp(u_k - diag_k)
    return r * (e_q + _EPS), r * (e_k + _EPS), e_q, e_k, u_q


def _id_features(q, k, proj, cd):
    """The kernel-body probe's identity features (``body="idfeat"``):
    the raw products u = x·rnd(P)ᵀ stand for the features and for e_q,
    e_k, as the TPU probe's patched ``_features`` returns them (no
    d^-1/4 scale)."""
    p = rounded(proj, cd)
    u_q = rounded(q, cd) @ p.T
    u_k = rounded(k, cd) @ p.T
    return u_q, u_k, u_q, u_k, u_q


def _chunks(n, chunk, reverse=False):
    starts = list(range(0, n, chunk))
    for c0 in reversed(starts) if reverse else starts:
        yield slice(c0, min(c0 + chunk, n))


def _tri(c, device, body="full"):
    ones = torch.ones(c, c, dtype=torch.bool, device=device)
    return ones if body == "nomask" else torch.tril(ones)


def favor_fwd_plain(q, k, v, proj, chunk, body="full"):
    """q, k, v: (N, L, d) in the compute dtype → (out (N, L, d) f32,
    den (N, L) f32).  ``body`` other than "full" is an ablation of the
    kernel-body probe (``ops/kernel_body.py``): "idfeat" (identity
    features) or "nomask" (no causal select)."""
    features = _id_features if body == "idfeat" else _features
    cd = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    n_bh, n, d = q.shape
    m = proj.shape[0]
    S = q.new_zeros(n_bh, m, d)
    z = q.new_zeros(n_bh, m)
    out, den = torch.empty_like(q), q.new_empty(n_bh, n)
    for sl in _chunks(n, chunk):
        qp, kp, _, _, _ = features(q[:, sl], k[:, sl], proj, cd)
        qc, kc = rounded(qp, cd), rounded(kp, cd)
        c = qc.shape[1]
        scores = torch.where(_tri(c, q.device, body), qc @ kc.transpose(1, 2), 0.0)
        num = rounded(scores, cd) @ v[:, sl] + qc @ rounded(S, cd)
        dn_ = scores.sum(-1) + (qc * rounded(z, cd)[:, None, :]).sum(-1)
        out[:, sl] = num * (1.0 / torch.clamp(dn_, min=1e-12))[..., None]
        den[:, sl] = dn_
        S = S + kc.transpose(1, 2) @ v[:, sl]
        z = z + kp.sum(1)
    return out, den


def _out_cotangent(g, out, den):
    inv = 1.0 / torch.clamp(den, min=1e-12)[..., None]
    return g * inv, -(g * out).sum(-1, keepdim=True) * inv


def dq_terms(q, k, v, proj, g, out, den, chunk, body="full", cd=None):
    """The dq sweep of :func:`favor_bwd_plain` up to its last product,
    chunk by chunk: yields a dict of the chunk's slice ``sl`` and its
    f32 intermediates, among them du (N, c, m) and w (N, c, 1), from
    which dq = rnd(du)·rnd(P)·d^-1/4 − w·d^-1/2·q, and the operands of
    dq_p = rnd(ds)·kc + rnd(dnum)·rnd(S)ᵀ + gd·z.  q, k, v, g in f32
    holding values of the compute dtype ``cd``."""
    features = _id_features if body == "idfeat" else _features
    cd = cd or q.dtype
    q, k, v, g = q.float(), k.float(), v.float(), g.float()
    n_bh, n, d = q.shape
    m = proj.shape[0]
    r = m ** -0.5
    S = q.new_zeros(n_bh, m, d)
    z = q.new_zeros(n_bh, m)
    for sl in _chunks(n, chunk):
        qp, kp, e_q, _, u_q = features(q[:, sl], k[:, sl], proj, cd)
        kc = rounded(kp, cd)
        dnum, gd = _out_cotangent(g[:, sl], out[:, sl], den[:, sl])
        c = kc.shape[1]
        ds = torch.where(_tri(c, q.device, body),
                         rounded(dnum, cd) @ v[:, sl].transpose(1, 2) + gd, 0.0)
        dqp = (rounded(ds, cd) @ kc + rounded(dnum, cd) @ rounded(S, cd).transpose(1, 2)
               + gd * z[:, None, :])
        # through φ_q; the row max's cotangent −w splits evenly over ties
        dE = dqp * (r * e_q)
        w = dE.sum(-1, keepdim=True)
        ties = (u_q == u_q.amax(-1, keepdim=True)).float()
        yield {"sl": sl, "ds": ds, "kc": kc, "dnum": dnum, "S": S, "gd": gd, "z": z,
               "e_q": e_q, "ties": ties, "dqp": dqp, "w": w,
               "du": dE - ties * (w / ties.sum(-1, keepdim=True))}
        S = S + kc.transpose(1, 2) @ v[:, sl]
        z = z + kp.sum(1)


def favor_bwd_plain(q, k, v, proj, g, out, den, chunk, body="full"):
    """The two backward sweeps.  g: (N, L, d) in the compute dtype; out,
    den: the forward's f32 results → (dq, dk, dv) f32.  ``body`` as for
    :func:`favor_fwd_plain`."""
    features = _id_features if body == "idfeat" else _features
    cd = q.dtype
    q, k, v, g = q.float(), k.float(), v.float(), g.float()
    n_bh, n, d = q.shape
    m = proj.shape[0]
    dn, r = d ** -0.25, m ** -0.5
    p = rounded(proj, cd)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)

    for t in dq_terms(q, k, v, proj, g, out, den, chunk, body, cd):
        dq[:, t["sl"]] = rounded(t["du"], cd) @ p * dn - t["w"] * (dn * dn) * q[:, t["sl"]]

    dS = q.new_zeros(n_bh, m, d)
    dz = q.new_zeros(n_bh, m)
    for sl in _chunks(n, chunk, reverse=True):
        qp, kp, _, e_k, _ = features(q[:, sl], k[:, sl], proj, cd)
        qc, kc = rounded(qp, cd), rounded(kp, cd)
        dnum, gd = _out_cotangent(g[:, sl], out[:, sl], den[:, sl])
        tri = _tri(qc.shape[1], q.device, body)
        scores = torch.where(tri, qc @ kc.transpose(1, 2), 0.0)
        ds = torch.where(tri, rounded(dnum, cd) @ v[:, sl].transpose(1, 2) + gd, 0.0)
        dkp = (rounded(ds, cd).transpose(1, 2) @ qc
               + v[:, sl] @ rounded(dS, cd).transpose(1, 2) + dz[:, None, :])
        dv[:, sl] = (rounded(scores, cd).transpose(1, 2) @ rounded(dnum, cd)
                     + kc @ rounded(dS, cd))
        dE = dkp * (r * e_k)
        w = dE.sum(-1, keepdim=True)
        dk[:, sl] = rounded(dE, cd) @ p * dn - w * (dn * dn) * k[:, sl]
        dS = dS + qc.transpose(1, 2) @ rounded(dnum, cd)
        dz = dz + (qp * gd).sum(1)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("favor_attention")
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.favor_fwd.argtypes = [i] * 6 + [f] * 4 + [p] * 8
    lib.favor_bwd.argtypes = [i] * 7 + [f] * 4 + [p] * 12
    for fn in (lib.favor_fwd, lib.favor_bwd, lib.favor_route, lib.favor_launches):
        fn.restype = ctypes.c_int
    lib.favor_route.argtypes = [i] * 4
    lib.favor_launches.argtypes = [i] * 5
    lib.favor_work_bytes.argtypes = [i] * 7
    lib.favor_smem_bytes.argtypes = [i] * 4
    lib.favor_launch_smem.argtypes = [i] * 3
    for fn in (lib.favor_work_bytes, lib.favor_smem_bytes, lib.favor_launch_smem):
        fn.restype = ctypes.c_longlong
    return lib


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _code(dtype):
    return int(dtype == torch.bfloat16)


def _check_kernel_inputs(q, k, v, proj, chunk):
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"favor kernel takes f32 or bf16 q/k/v, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != dev or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(f"{name} must match q ({q.dtype}, {tuple(q.shape)}, {dev}); "
                             f"got {x.dtype}, {tuple(x.shape)}, {x.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, L, d), got {tuple(q.shape)}")
    if proj.device != dev or proj.dim() != 2 or proj.shape[1] != q.shape[-1]:
        raise ValueError(f"projection must be (m, {q.shape[-1]}) on {dev}, got "
                         f"{tuple(proj.shape)} on {proj.device}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    smem = _lib().favor_smem_bytes(q.shape[-1], proj.shape[0], chunk, _code(q.dtype))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"projection {tuple(proj.shape)} with chunk {chunk} needs {smem} "
                         f"bytes of shared memory per block; the card has {SMEM_PER_BLOCK}")


def launches_per_call(q, proj, chunk: int = 128) -> int:
    """Kernel launches of one forward + backward call on q's shape and
    dtype (the library's plan: 7 on the chunk-parallel route, 3 on the
    earlier kernels)."""
    d, m, code = q.shape[-1], proj.shape[0], _code(q.dtype)
    return sum(_lib().favor_launches(d, m, chunk, code, bwd) for bwd in (0, 1))


def _work(q, m, chunk, bwd):
    b, h, n, d = q.shape
    nbytes = _lib().favor_work_bytes(b * h, n, d, m, chunk, _code(q.dtype), bwd)
    return torch.empty(nbytes, dtype=torch.uint8, device=q.device)


def _consts(d, m):
    dn = d ** -0.25
    return [dn, 0.5 * dn * dn, dn * dn, m ** -0.5]


def _kernel_fwd(q, k, v, proj, chunk):
    b, h, n, d = q.shape
    m, code = proj.shape[0], _code(q.dtype)
    out = torch.empty(b, h, n, d, dtype=torch.float32, device=q.device)
    den = torch.empty(b * h, n, dtype=torch.float32, device=q.device)
    work = _work(q, m, chunk, 0)
    err = _lib().favor_fwd(
        b * h, n, d, m, chunk, code, *_consts(d, m), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        proj.data_ptr(), out.data_ptr(), den.data_ptr(), work.data_ptr(), _stream(q))
    if err:
        raise RuntimeError(f"favor_fwd: CUDA error {err}")
    favor_attention_fused.launches += _lib().favor_launches(d, m, chunk, code, 0)
    return out, den


def _kernel_bwd(q, k, v, proj, g, out, den, chunk):
    b, h, n, d = q.shape
    m, code = proj.shape[0], _code(q.dtype)
    dq, dk, dv = (torch.empty(b, h, n, d, dtype=torch.float32, device=q.device)
                  for _ in range(3))
    work = _work(q, m, chunk, 1)
    err = _lib().favor_bwd(
        3, b * h, n, d, m, chunk, code, *_consts(d, m), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), proj.data_ptr(), g.data_ptr(), out.data_ptr(), den.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(), _stream(q))
    if err:
        raise RuntimeError(f"favor_bwd: CUDA error {err}")
    favor_attention_fused.launches += _lib().favor_launches(d, m, chunk, code, 1)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _flat(x):
    return x.reshape(-1, *x.shape[2:])


class _Plain:
    @staticmethod
    def fwd(q, k, v, proj, chunk):
        out, den = favor_fwd_plain(_flat(q), _flat(k), _flat(v), proj.float(), chunk)
        return out.view(q.shape), den

    @staticmethod
    def bwd(q, k, v, proj, g, out, den, chunk):
        grads = favor_bwd_plain(_flat(q), _flat(k), _flat(v), proj.float(), _flat(g),
                                _flat(out), den, chunk)
        return tuple(x.view(q.shape) for x in grads)


class _Kernel:
    fwd = staticmethod(_kernel_fwd)
    bwd = staticmethod(_kernel_bwd)


class _FavorFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, proj, chunk, impl):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        proj = proj.to(torch.float32).contiguous()
        out, den = impl.fwd(q, k, v, proj, chunk)
        ctx.save_for_backward(q, k, v, proj, out, den)
        ctx.chunk, ctx.impl = chunk, impl
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, proj, out, den = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        dq, dk, dv = ctx.impl.bwd(q, k, v, proj, g, out, den, ctx.chunk)
        dproj = torch.zeros_like(proj) if ctx.needs_input_grad[3] else None
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dproj, None, None


def favor_attention_fused(q, k, v, projection, chunk: int = 128):
    """Causal FAVOR+ with fused feature maps (see module docstring).
    q/k/v: (B, H, L, d) in the compute dtype; projection (m, d) → (B, H,
    L, d) f32.  CUDA tensors launch the kernel (anything it cannot take
    raises); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return _FavorFused.apply(q, k, v, projection, chunk, _Plain)
    if q.device.type != "cuda":
        raise ValueError(f"no FAVOR kernel for device {q.device}")
    _check_kernel_inputs(q, k, v, projection, chunk)
    return _FavorFused.apply(q, k, v, projection, chunk, _Kernel)


favor_attention_fused.launches = 0


def favor_attention_fused_plain(q, k, v, projection, chunk: int = 128):
    """The plain version of :func:`favor_attention_fused` on any device
    (forward and backward), for holding the kernel against it."""
    return _FavorFused.apply(q, k, v, projection, chunk, _Plain)

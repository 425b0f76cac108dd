"""The kernel-body probe's kernels: ablated bodies of rows 5 and 6, with their plain twins.

Port of the Pallas kernels of ``tools/probe_kernel_body.py``
(``local_fwd_variant`` :93, ``local_bwd_variant`` :168,
``favor_variant`` :264), whose CLI is
``synthanatomy_tpu_torch/tools/probe_kernel_body.py``.  The TPU probe
rebuilds the bodies of the banded local-attention kernels and patches
the FAVOR+ kernels' ``_features`` and ``_tri``; here the ablations are
compile-time template parameters of the port's own bodies
(``csrc/local_attention.cu``, ``csrc/favor_core.cuh``), so the
production kernels keep their instantiations.

- :func:`local_fwd_body` — the banded forward with body one of
  ``LOCAL_FWD_BODIES``: "foldscale" (the production forward: d^-1/2
  folded into q, Σe divided after P·V), "full" (scores scaled, P
  normalised before P·V), "defer" (scores scaled, Σe divided after
  P·V), "nomax" (as "full" without the row max), "matmuls" (P = the
  scaled scores, 0 outside the band: out = rnd(S ⊙ band)·v);
- :func:`local_bwd_body` — the two backward launches with body "full"
  (the production backward) or "matmuls" (P = S ⊙ band and dS = dP ⊙
  band, S = q·kᵀ·d^-1/2, dP = g·vᵀ: dq = rnd(dS)·k·d^-1/2, dk =
  rnd(dS)ᵀ·q·d^-1/2, dv = rnd(P)ᵀ·g), gradients written in the compute
  dtype or in f32;
- :func:`favor_fwd_body` / :func:`favor_bwd_body` — the FAVOR+ forward
  and the dq or dk/dv sweep with body "full" (production), "idfeat"
  (the raw products u = x·rnd(P)ᵀ, without the d^-1/4 scale, stand for
  the features and for exp(u − diag − stab) in the backward's chain, as
  the TPU probe's patched ``_features`` hands them) or "nomask" (the
  causal selects of the chunk's scores and dscores are unconditional).
  They run on row 5's chunk-parallel route (``csrc/favor_core.cuh``): "full"
  is production's own launches (``csrc/favor_attention.cu``), each
  ablation a library of its own (``csrc/favor_probe_idfeat.cu``,
  ``csrc/favor_probe_nomask.cu``); a shape off the route (d above 64, m
  above 256) raises ValueError, as do the f32 ablations above m 64.

For the identity-features dq's comparison (``tools/probe_kernel_body``'s
``dq_cancellation`` and ``idfeat_dq_bound``): :func:`favor_dq_terms`
hands out the plain twin's dq sweep chunk by chunk, and
:func:`mma_steps` runs chained ``mma.sync`` m16n8k16 steps on given bf16
fragments and reads each step's accumulator (``csrc/favor_probe.cuh``'s
diagnostic kernel; :func:`mma_steps_exact` rounds each step exactly).

Both local kernels take ``heads_per_block``: the (batch·head) rows one
block walks in turn with the same shared memory, the counterpart of the
TPU kernels' batch·head tile ``bt``.  The local bodies are those of row
6's tile form, built for head dim at most ``LOCAL_MAX_D`` (64, that of
every configuration; a wider head raises ValueError).  Each
wrapper launches its kernel for CUDA tensors (raising for anything it
cannot take, and raising :class:`DoesNotFit` before the launch for a
FAVOR variant whose shared memory exceeds ``SMEM_PER_BLOCK``) and takes
the plain twin (``*_plain``) for CPU tensors; ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK, load_library
from synthanatomy_tpu_torch.ops import favor_attention as fa
from synthanatomy_tpu_torch.ops import local_attention_flash as lf
from synthanatomy_tpu_torch.ops.local_attention import rounded

__all__ = [
    "DoesNotFit",
    "FAVOR_BODIES",
    "FAVOR_SWEEPS",
    "LOCAL_BWD_BODIES",
    "LOCAL_FWD_BODIES",
    "favor_bwd_body",
    "favor_bwd_body_plain",
    "favor_dq_terms",
    "favor_fwd_body",
    "favor_fwd_body_plain",
    "favor_production",
    "local_bwd_body",
    "local_bwd_body_plain",
    "local_fwd_body",
    "local_fwd_body_plain",
    "local_production",
    "mma_steps",
    "mma_steps_exact",
]

# in the order of the kernels' template arguments
LOCAL_FWD_BODIES = ("foldscale", "full", "defer", "nomax", "matmuls")
LOCAL_BWD_BODIES = ("full", "matmuls")
FAVOR_BODIES = ("full", "idfeat", "nomask")
FAVOR_SWEEPS = ("dq", "dkv")
LOCAL_MAX_D = 64  # the local bodies' staged head dim (csrc/local_attention.cu builds no other)


class DoesNotFit(ValueError):
    """A variant whose shared memory exceeds the card's per-block limit."""

    def __init__(self, name: str, nbytes: int):
        self.nbytes = nbytes
        super().__init__(f"{name}: does not fit: {nbytes} bytes of shared memory per block "
                         f"(the card has {SMEM_PER_BLOCK})")


def _body_index(body, bodies):
    if body not in bodies:
        raise ValueError(f"body must be one of {bodies}, got {body!r}")
    return bodies.index(body)


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def local_fwd_body_plain(q, k, v, window, body="foldscale"):
    """q, k, v: (..., L, d) post-rotary in the compute dtype → (..., L,
    d) in the compute dtype, by forward body ``body``."""
    if body == "foldscale":
        return lf.local_fwd_plain(q, k, v, window)
    _body_index(body, LOCAL_FWD_BODIES)
    cd = q.dtype
    band = lf._band(q.shape[-2], window, q.device)
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if body == "matmuls":
        return (rounded(s.masked_fill(~band, 0.0), cd) @ v.float()).to(cd)
    s = s.masked_fill(~band, float("-inf"))
    e = torch.exp(s if body == "nomax" else s - s.amax(-1, keepdim=True))
    if body == "defer":
        return ((rounded(e, cd) @ v.float()) / e.sum(-1, keepdim=True)).to(cd)
    return (rounded(e / e.sum(-1, keepdim=True), cd) @ v.float()).to(cd)


def local_bwd_body_plain(q, k, v, g, window, body="full", out_f32=False):
    """The backward by body ``body``: g in the compute dtype → (dq, dk,
    dv) in the compute dtype, or in f32 with ``out_f32``."""
    od = torch.float32 if out_f32 else q.dtype
    if body == "full":
        return lf.local_bwd_plain(q, k, v, g, window, out_dtype=od)
    _body_index(body, LOCAL_BWD_BODIES)
    cd = q.dtype
    scale = q.shape[-1] ** -0.5
    band = lf._band(q.shape[-2], window, q.device)
    q, k, v, g = q.float(), k.float(), v.float(), g.float()
    p = ((q @ k.transpose(-1, -2)) * scale).masked_fill(~band, 0.0)
    ds = (g @ v.transpose(-1, -2)).masked_fill(~band, 0.0)
    dq = (rounded(ds, cd) @ k) * scale
    dk = (rounded(ds, cd).transpose(-1, -2) @ q) * scale
    dv = rounded(p, cd).transpose(-1, -2) @ g
    return dq.to(od), dk.to(od), dv.to(od)


def favor_fwd_body_plain(q, k, v, proj, chunk=128, body="full"):
    """q, k, v (B, H, L, d) in the compute dtype, proj (m, d) → (out (B,
    H, L, d) f32, den (B·H, L) f32) by body ``body``."""
    _body_index(body, FAVOR_BODIES)
    out, den = fa.favor_fwd_plain(fa._flat(q), fa._flat(k), fa._flat(v), proj.float(), chunk,
                                  body)
    return out.view(q.shape), den


def favor_bwd_body_plain(q, k, v, proj, g, out, den, chunk=128, body="full", sweep="dq"):
    """One backward sweep by body ``body``: dq (``sweep="dq"``) or (dk,
    dv) (``sweep="dkv"``), f32 (B, H, L, d); g in the compute dtype, out
    and den the forward's."""
    _body_index(body, FAVOR_BODIES)
    _body_index(sweep, FAVOR_SWEEPS)
    dq, dk, dv = (x.view(q.shape) for x in fa.favor_bwd_plain(
        fa._flat(q), fa._flat(k), fa._flat(v), proj.float(), fa._flat(g), fa._flat(out), den,
        chunk, body))
    return dq if sweep == "dq" else (dk, dv)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib(name):
    lib = load_library(name)
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    if name == "local_attention":
        lib.local_fwd_probe.argtypes = [i] * 7 + [f] + [p] * 5
        lib.local_bwd_probe.argtypes = [i] * 8 + [f] + [p] * 11
        lib.local_fwd_probe.restype = lib.local_bwd_probe.restype = i
    else:
        lib.favor_probe.argtypes = [i] * 7 + [f] * 4 + [p] * 11
        lib.favor_probe_mma.argtypes = [p] * 3 + [i] + [p] * 2
        lib.favor_probe.restype = lib.favor_probe_mma.restype = i
    return lib


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _require_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {q.device}")


def _local_checks(name, q, k, v, window, heads_per_block):
    _require_cuda(name, q)
    if heads_per_block < 1:
        raise ValueError(f"heads_per_block must be positive, got {heads_per_block}")
    if q.shape[-1] > LOCAL_MAX_D:
        raise ValueError(f"{name}: the bodies are built for head dim at most {LOCAL_MAX_D}; "
                         f"got {q.shape[-1]}")
    lf._check_kernel_inputs(q, k, v, window)


def local_fwd_body(q, k, v, window, body="foldscale", heads_per_block=1):
    """The forward by body ``body`` (see the module docstring): q, k, v
    (B, H, L, d) post-rotary in the compute dtype → (B, H, L, d) in the
    compute dtype.  One launch."""
    if q.device.type == "cpu":
        return local_fwd_body_plain(q, k, v, window, body)
    idx = _body_index(body, LOCAL_FWD_BODIES)
    _local_checks("local_fwd_body", q, k, v, window, heads_per_block)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    err = _lib("local_attention").local_fwd_probe(
        idx, heads_per_block, b * h, n, d, window, int(q.dtype == torch.bfloat16), d ** -0.5,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _stream(q))
    if err:
        raise RuntimeError(f"local_fwd_probe ({body}): CUDA error {err}")
    local_fwd_body.launches += 1
    return out


local_fwd_body.launches = 0


def local_bwd_body(q, k, v, g, window, body="full", heads_per_block=1, out_f32=False):
    """The backward by body ``body``: (dq, dk, dv) in the compute dtype,
    or in f32 with ``out_f32``.  Two launches (dq with the row
    statistics, then dk/dv)."""
    if q.device.type == "cpu":
        return local_bwd_body_plain(q, k, v, g, window, body, out_f32)
    idx = _body_index(body, LOCAL_BWD_BODIES)
    _local_checks("local_bwd_body", q, k, v, window, heads_per_block)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must match q ({q.dtype}, {tuple(q.shape)}); got {g.dtype}, "
                         f"{tuple(g.shape)} on {g.device}")
    q, k, v, g = q.contiguous(), k.contiguous(), v.contiguous(), g.contiguous()
    b, h, n, d = q.shape
    od = torch.float32 if out_f32 else q.dtype
    dq, dk, dv = (torch.empty(q.shape, dtype=od, device=q.device) for _ in range(3))
    stats = torch.empty(3, b * h, n, dtype=torch.float32, device=q.device)
    err = _lib("local_attention").local_bwd_probe(
        idx, heads_per_block, int(out_f32), b * h, n, d, window,
        int(q.dtype == torch.bfloat16), d ** -0.5, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), stats[2].data_ptr(), _stream(q))
    if err:
        raise RuntimeError(f"local_bwd_probe ({body}): CUDA error {err}")
    local_bwd_body.launches += 2
    return dq, dk, dv


local_bwd_body.launches = 0


def _favor_launch(which, body, q, k, v, proj, chunk, g=None, out=None, den=None):
    """One FAVOR probe call: which 0 forward → (out, den), 1 dq sweep → dq,
    2 dk/dv sweep → (dk, dv).  Body "full" is production's own launches
    (``csrc/favor_attention.cu``), the others ``csrc/favor_probe_*.cu``'s;
    either way the route's state and scan launches, then the consumer (3
    launches).  Returns the outputs and the launch count."""
    name = ("favor_fwd_body", "favor_bwd_body", "favor_bwd_body")[which]
    _body_index(body, FAVOR_BODIES)
    _require_cuda(name, q)
    lib, code = fa._lib(), fa._code(q.dtype)
    d, m = q.shape[-1], proj.shape[0]
    smem = lib.favor_smem_bytes(d, m, chunk, code)
    if smem > SMEM_PER_BLOCK:
        raise DoesNotFit(name, smem)
    fa._check_kernel_inputs(q, k, v, proj, chunk)
    if not lib.favor_route(d, m, chunk, code):
        raise ValueError(f"{name}: the probe's bodies run on the chunk-parallel route (d a "
                         f"multiple of 8 up to 64, m up to 256); got d {d}, m {m}")
    if body != "full" and q.dtype == torch.float32 and m > 64:
        raise ValueError(f"{name}: the f32 ablations are built for m up to 64; got {m}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    proj = proj.to(torch.float32).contiguous()
    b, h, n, _ = q.shape
    bh = b * h
    if which:
        if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
            raise ValueError(f"g must match q ({q.dtype}, {tuple(q.shape)}); got {g.dtype}, "
                             f"{tuple(g.shape)} on {g.device}")
        if out.shape != q.shape or out.dtype != torch.float32 or den.shape != (bh, n) \
                or den.dtype != torch.float32:
            raise ValueError(f"out must be f32 {tuple(q.shape)} and den f32 {(bh, n)}; got "
                             f"{out.dtype} {tuple(out.shape)}, {den.dtype} {tuple(den.shape)}")
        g, out, den = g.contiguous(), out.contiguous(), den.contiguous()
    o1 = torch.empty(b, h, n, d, dtype=torch.float32, device=q.device)
    o2 = (torch.empty(bh, n, dtype=torch.float32, device=q.device) if which == 0 else
          torch.empty_like(o1) if which == 2 else None)
    work = fa._work(q, m, chunk, int(which > 0))
    ptr = (lambda x: None if x is None else x.data_ptr())
    shape = [bh, n, d, m, chunk, code, *fa._consts(d, m)]
    if body == "full" and which == 0:
        err = lib.favor_fwd(*shape, q.data_ptr(), k.data_ptr(), v.data_ptr(), proj.data_ptr(),
                            o1.data_ptr(), o2.data_ptr(), work.data_ptr(), _stream(q))
    elif body == "full":
        err = lib.favor_bwd(which, *shape, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            proj.data_ptr(), g.data_ptr(), out.data_ptr(), den.data_ptr(),
                            ptr(o1) if which == 1 else None, ptr(o1) if which == 2 else None,
                            ptr(o2), work.data_ptr(), _stream(q))
    else:
        err = _lib(f"favor_probe_{body}").favor_probe(
            which, *shape, q.data_ptr(), k.data_ptr(), v.data_ptr(), proj.data_ptr(),
            ptr(g), ptr(out), ptr(den), o1.data_ptr(), ptr(o2), work.data_ptr(), _stream(q))
    if err:
        raise RuntimeError(f"{name} ({body}): CUDA error {err}")
    return (o1 if which == 1 else (o1, o2)), 3


def favor_fwd_body(q, k, v, proj, chunk=128, body="full"):
    """The FAVOR+ forward by body ``body`` → (out (B, H, L, d) f32, den
    (B·H, L) f32).  Three launches (state, scan, forward)."""
    if q.device.type == "cpu":
        return favor_fwd_body_plain(q, k, v, proj, chunk, body)
    res, launches = _favor_launch(0, body, q, k, v, proj, chunk)
    favor_fwd_body.launches += launches
    return res


favor_fwd_body.launches = 0


def favor_bwd_body(q, k, v, proj, g, out, den, chunk=128, body="full", sweep="dq"):
    """One backward sweep by body ``body``: dq (``sweep="dq"``) or (dk,
    dv) (``sweep="dkv"``), f32; out and den from :func:`favor_fwd_body`
    of the same body.  Three launches (state, scan, the sweep's consumer)."""
    if q.device.type == "cpu":
        return favor_bwd_body_plain(q, k, v, proj, g, out, den, chunk, body, sweep)
    res, launches = _favor_launch(1 + _body_index(sweep, FAVOR_SWEEPS), body, q, k, v, proj,
                                  chunk, g, out, den)
    favor_bwd_body.launches += launches
    return res


favor_bwd_body.launches = 0


# ---------------------------------------------------------------------------
# the tensor cores' sum inside one product step (the diagnostic of the
# identity-features dq, tools/probe_kernel_body.dq_cancellation)
# ---------------------------------------------------------------------------


def _mma_operands(a, bt, c):
    steps = a.shape[1] // 16
    if a.shape != (16, 16 * steps) or bt.shape != (8, 16 * steps) or c.shape != (16, 8) \
            or steps < 1:
        raise ValueError(f"a (16, 16·s), bt (8, 16·s) and c (16, 8) expected; got "
                         f"{tuple(a.shape)}, {tuple(bt.shape)}, {tuple(c.shape)}")
    return steps


def mma_steps_exact(a, bt, c):
    """The accumulators after each of the chained m16n8k16 steps of
    :func:`mma_steps`, each step's sum (its accumulator and 16 products,
    each exact) taken in float64 and rounded to f32 once, from the
    accumulator the step started from → (steps, 16, 8) f32."""
    steps = _mma_operands(a, bt, c)
    a64, b64 = a.double().reshape(16, steps, 16), bt.double().reshape(8, steps, 16)
    acc, out = c.float(), []
    for s in range(steps):
        acc = (acc.double() + a64[:, s] @ b64[:, s].T).float()
        out.append(acc)
    return torch.stack(out)


def mma_steps(a, bt, c):
    """a (16, 16·s) and bt (8, 16·s) bf16, c (16, 8) f32 → the
    accumulators after each of s chained ``mma.sync`` m16n8k16 steps on
    the card, (s, 16, 8) f32 (``csrc/favor_probe.cuh``'s diagnostic
    kernel, one launch); the CPU takes :func:`mma_steps_exact`."""
    steps = _mma_operands(a, bt, c)
    if a.device.type == "cpu":
        return mma_steps_exact(a, bt, c)
    _require_cuda("mma_steps", a)
    if a.dtype != torch.bfloat16 or bt.dtype != torch.bfloat16 or bt.device != a.device \
            or c.device != a.device:
        raise TypeError("a and bt must be bf16 on a's device, c f32 there")
    a, bt, c = a.contiguous(), bt.contiguous(), c.float().contiguous()
    d = torch.empty(steps, 16, 8, dtype=torch.float32, device=a.device)
    err = _lib("favor_probe_idfeat").favor_probe_mma(a.data_ptr(), bt.data_ptr(), c.data_ptr(),
                                                     steps, d.data_ptr(), _stream(a))
    if err:
        raise RuntimeError(f"mma_steps: CUDA error {err}")
    mma_steps.launches += 1
    return d


mma_steps.launches = 0


def favor_dq_terms(q, k, v, proj, g, out, den, chunk=128, body="full"):
    """The plain twin's dq sweep, chunk by chunk (``ops/favor_attention.dq_terms``):
    a list of dicts of f32 intermediates, rows (B·H, ·)."""
    _body_index(body, FAVOR_BODIES)
    qf, kf, vf, gf = (fa._flat(x).float() for x in (q, k, v, g))
    return list(fa.dq_terms(qf, kf, vf, proj.float(), gf, fa._flat(out), den, chunk, body,
                            q.dtype))


# ---------------------------------------------------------------------------
# the production kernels, for the bit-for-bit checks
# ---------------------------------------------------------------------------


def local_production(q, k, v, g, window):
    """Row 6's production launches (the plain version on the CPU): (out,
    dq, dk, dv) in the compute dtype."""
    impl = lf._Kernel if q.device.type == "cuda" else lf._Plain
    return (impl.fwd(q, k, v, window), *impl.bwd(q, k, v, g, window))


def favor_production(q, k, v, proj, g, chunk=128):
    """Row 5's production launches (the plain version on the CPU): (out,
    den, dq, dk, dv), f32."""
    impl = fa._Kernel if q.device.type == "cuda" else fa._Plain
    proj = proj.to(torch.float32)
    out, den = impl.fwd(q, k, v, proj, chunk)
    return (out, den, *impl.bwd(q, k, v, proj, g, out, den, chunk))

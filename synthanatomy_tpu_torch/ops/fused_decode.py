"""Fused Performer decode step: one AR token through all L layers.

Port of ``synthanatomy_tpu/ops/fused_decode.py``.  The TPU kernel
(``_build_kernel``, launched by ``make_fused_decode_step``) becomes the
hand-written CUDA kernels in ``csrc/fused_decode.cu``, reached through
:func:`fused_decode_step`.  :func:`fused_decode_step_ref` is the plain
PyTorch version of the same step: the CPU path, and what the kernel is
held against on the card.

Layouts (shared by kernel, plain version and the JAX reference):

- per-layer weights are stacked (L, K, N) int8 — or packed int4, (L,
  K/2, N) with byte k holding row k (low nibble) and row k+K/2 (high
  nibble) — with per-output-channel f32 scales (L, 1|2, N);
- FAVOR state ``S`` (L, m, B·gh·dh) bf16 with flat column
  ``(b·gh + h)·dh + d``, and ``z`` (L, B·gh, m) f32;
- local-head rings ``ck``/``cv`` (L, R, B·lh·dh), bf16 or int8 with
  per-(slot, batch·head) f32 scales ``ck_s``/``cv_s`` (L, R, B·lh).

Rounding points follow the TPU kernel: GEMV inputs are rounded to bf16
(weights are exact in bf16), ``q_p`` and ``S`` are rounded to bf16
before the numerator product, ``K·q`` and ``q·k`` are rounded to bf16
before the score sums, and the ring probabilities are rounded to bf16
before the value sum.  LayerNorm eps is 1e-6 (flax), GELU is the tanh
approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from synthanatomy_tpu_torch._build import SMEM_PER_BLOCK, load_library
from synthanatomy_tpu_torch.ops.quant import (
    quantize_int4_packed,
    quantize_int8,
    unpack_int4,
)

__all__ = [
    "FusedDecodeConfig",
    "supports_fused_decode",
    "pack_fused_params",
    "strip_reference_weights",
    "init_fused_state",
    "update_rings",
    "fused_decode_step_ref",
    "fused_decode_step",
    "count_graph_replay",
]


@dataclass(frozen=True)
class FusedDecodeConfig:
    depth: int
    batch: int
    dim: int
    heads: int
    dim_head: int
    local_heads: int
    local_window: int
    nb_features: int
    ff_mult: int = 4
    ring: int = 0  # 0 → round the window up to a multiple of 64
    weight_quant: str = "int8"  # "int8" or "int4" (packed along K)
    ring_quant: bool = False  # int8 rings with per-(slot, head) scales
    use_rezero: bool = False  # gains folded into wout/w2/b2, no pre-norms

    @property
    def gh(self) -> int:
        return self.heads - self.local_heads

    @property
    def ring_size(self) -> int:
        if self.ring:
            return self.ring
        return max(128, ((self.local_window + 63) // 64) * 64)

    @property
    def ff_inner(self) -> int:
        return self.dim * self.ff_mult

    @property
    def bg(self) -> int:  # FAVOR flat width (B·gh·dh)
        return self.batch * self.gh * self.dim_head

    @property
    def bl(self) -> int:  # ring flat width (B·lh·dh)
        return self.batch * self.local_heads * self.dim_head


def supports_fused_decode(model) -> bool:
    """The fused step covers causal softmax-kernel FAVOR heads with a
    projection plus optional local heads, pre-LayerNorm or ReZero blocks,
    no biases on q/k/v/out, non-GLU FF, no per-layer rotary — at widths
    the kernels tile (dh 64 or 128, dim a multiple of 128).  For a model
    on a card, the kernel library's plan (``csrc/fused_plan.h``) must
    also take its launches, with either weight and ring format: what
    :func:`fused_decode_step` checks before it launches."""
    plain_heads = (model.causal and not model.generalized_attention
                   and not model.no_projection and not model.qkv_bias
                   and not model.attn_out_bias and not model.use_scalenorm
                   and not model.ff_glu and not model.rotary_position_emb)
    if not (plain_heads and _widths_ok(model.heads - model.local_attn_heads, model.dim_head,
                                       model.dim, model.dim * model.ff_mult)):
        return False
    if model.token_emb.weight.device.type != "cuda":
        return True
    cfg = FusedDecodeConfig(
        depth=model.depth, batch=1, dim=model.dim, heads=model.heads, dim_head=model.dim_head,
        local_heads=model.local_attn_heads, local_window=model.local_window_size,
        nb_features=model.nb_features, ff_mult=model.ff_mult)
    return all(_plan_refusal(_lib(), dataclasses.replace(cfg, weight_quant=wq, ring_quant=rq))
               is None for wq in ("int8", "int4") for rq in (False, True))


def _widths_ok(gh: int, dim_head: int, dim: int, ff_inner: int) -> bool:
    return gh > 0 and dim_head in (64, 128) and dim % 128 == 0 and ff_inner % 128 == 0


def _plan_refusal(lib, cfg: FusedDecodeConfig):
    """Why the library's plan (``csrc/fused_plan.h``) refuses ``cfg``'s
    launches, or None where it takes them."""
    smem = int(lib.fused_decode_attn_smem(cfg.dim_head, cfg.nb_features, cfg.local_heads,
                                          cfg.ring_size, cfg.local_window, int(cfg.ring_quant)))
    if smem > SMEM_PER_BLOCK:
        return f"the attention launch needs {smem} B of shared memory, more than {SMEM_PER_BLOCK}"
    if not lib.fused_decode_fits(cfg.dim, cfg.heads, cfg.dim_head, cfg.ff_inner,
                                 int(cfg.weight_quant == "int4")):
        return "the GEMVs do not tile these widths"
    return None


# ---------------------------------------------------------------------------
# parameter packing and state
# ---------------------------------------------------------------------------


def pack_fused_params(
    model, *, weight_quant: str = "int8"
) -> Dict[str, torch.Tensor]:
    """Stack the port ``Performer``'s per-layer weights into the step's
    (L, ...) tensors, on the model's device.

    Weights are taken in the (in, out) orientation of the JAX Dense
    kernels (``Linear.weight.T``).  ReZero gains fold into the weights
    the block outputs flow through — g·(o@Wout) = o@(g·Wout),
    g·(x@W2 + b2) = x@(g·W2) + g·b2 — so the step just skips the
    pre-norms.  ``projT`` is the FAVOR projection transposed, (dh, m)."""
    if weight_quant not in ("int8", "int4"):
        raise ValueError(f"weight_quant must be 'int8' or 'int4', got {weight_quant!r}")
    f32 = torch.float32
    qkv_w, out_w, w1, b1, w2, b2 = [], [], [], [], [], []
    ln1_s, ln1_b, ln2_s, ln2_b, projs = [], [], [], [], []
    with torch.no_grad():
        for blk in model.blocks:
            attn = blk.attn
            qkv_w.append(torch.cat(
                [attn.to_q.weight.T, attn.to_k.weight.T, attn.to_v.weight.T], dim=1
            ).to(f32))
            wo = attn.to_out.weight.T.to(f32)
            ww2 = blk.ff.w2.weight.T.to(f32)
            bb2 = blk.ff.w2.bias.to(f32)
            if model.use_rezero:
                g_a = blk.g_attn.to(f32)[0]
                g_f = blk.g_ff.to(f32)[0]
                wo, ww2, bb2 = wo * g_a, ww2 * g_f, bb2 * g_f
                zeros = torch.zeros(model.dim, dtype=f32, device=wo.device)
                for lst in (ln1_s, ln1_b, ln2_s, ln2_b):
                    lst.append(zeros)
            else:
                ln1_s.append(blk.norm_attn.weight.to(f32))
                ln1_b.append(blk.norm_attn.bias.to(f32))
                ln2_s.append(blk.norm_ff.weight.to(f32))
                ln2_b.append(blk.norm_ff.bias.to(f32))
            out_w.append(wo)
            w1.append(blk.ff.w1.weight.T.to(f32))
            b1.append(blk.ff.w1.bias.to(f32))
            w2.append(ww2)
            b2.append(bb2)
            projs.append(attn.projection.T.to(f32))

        quant_one = quantize_int4_packed if weight_quant == "int4" else quantize_int8

        def quant_stack(ws):
            pairs = [quant_one(w) for w in ws]
            return (torch.stack([q for q, _ in pairs]).contiguous(),
                    torch.stack([s for _, s in pairs]).contiguous())

        def stack(ts):
            return torch.stack(ts).contiguous()

        def rows(ts):  # (L, 1, N)
            return torch.stack(ts)[:, None, :].contiguous()

        wqkv_q, wqkv_s = quant_stack(qkv_w)
        wout_q, wout_s = quant_stack(out_w)
        w1_q, w1_s = quant_stack(w1)
        w2_q, w2_s = quant_stack(w2)
        return {
            "wqkv_q": wqkv_q, "wqkv_s": wqkv_s,
            "wout_q": wout_q, "wout_s": wout_s,
            "w1_q": w1_q, "w1_s": w1_s, "b1": rows(b1),
            "w2_q": w2_q, "w2_s": w2_s, "b2": rows(b2),
            "ln1_s": rows(ln1_s), "ln1_b": rows(ln1_b),
            "ln2_s": rows(ln2_s), "ln2_b": rows(ln2_b),
            "projT": stack(projs),
            # f32 (unquantized) copies for the plain version's exact branch
            "_wqkv_f": stack(qkv_w), "_wout_f": stack(out_w),
            "_w1_f": stack(w1), "_w2_f": stack(w2),
        }


def strip_reference_weights(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop the f32 copies kept for the plain version's exact branch."""
    return {k: v for k, v in params.items() if not k.startswith("_")}


def init_fused_state(cfg: FusedDecodeConfig, device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed decode state (S, z and the rings) on ``device``: the card
    unless the caller asks for the CPU."""
    L, R = cfg.depth, cfg.ring_size
    state = {
        "S": torch.zeros(L, cfg.nb_features, cfg.bg, dtype=torch.bfloat16, device=device),
        "z": torch.zeros(L, cfg.batch * cfg.gh, cfg.nb_features, device=device),
    }
    if cfg.local_heads:
        ring_dtype = torch.int8 if cfg.ring_quant else torch.bfloat16
        state["ck"] = torch.zeros(L, R, cfg.bl, dtype=ring_dtype, device=device)
        state["cv"] = torch.zeros(L, R, cfg.bl, dtype=ring_dtype, device=device)
        if cfg.ring_quant:
            blh = cfg.batch * cfg.local_heads
            state["ck_s"] = torch.zeros(L, R, blh, device=device)
            state["cv_s"] = torch.zeros(L, R, blh, device=device)
    return state


def update_rings(state, k_all, v_all, t, cfg: FusedDecodeConfig):
    """Write the token's rotated keys and values (L, B·lh·dh) into ring
    slot ``t mod R``, in place (int8 rows get per-(layer, batch·head)
    scales with a 1e-8 floor).  ``t`` is an int or a 0-d int64 tensor on
    the rings' device; the tensor's slot is written by ``index_copy_``,
    so a CUDA graph captures the write at any t.  Returns ``state``."""
    if not cfg.local_heads:
        return state
    if isinstance(t, torch.Tensor):
        slot = torch.remainder(t, cfg.ring_size).reshape(1)

        def write(dst, rows):
            dst.index_copy_(1, slot, rows[:, None])
    else:
        slot = int(t) % cfg.ring_size

        def write(dst, rows):
            dst[:, slot] = rows
    if cfg.ring_quant:
        L, blh, dh = cfg.depth, cfg.batch * cfg.local_heads, cfg.dim_head
        for name, x in (("k", k_all), ("v", v_all)):
            xh = x.to(torch.float32).reshape(L, blh, dh)
            s = torch.clamp(xh.abs().amax(dim=-1) / 127.0, min=1e-8)
            q = torch.clamp(torch.round(xh / s[..., None]), -127, 127).to(torch.int8)
            write(state[f"c{name}"], q.reshape(L, cfg.bl))
            write(state[f"c{name}_s"], s)
        return state
    write(state["ck"], k_all.to(torch.bfloat16))
    write(state["cv"], v_all.to(torch.bfloat16))
    return state


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _layernorm(x, scale, bias, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _rotary(t: int, dh: int, device):
    """sin/cos (dh,) at position t, rotate-half layout, in the TPU
    kernel's exp form of the inverse frequencies."""
    dd = torch.arange(dh, device=device) % (dh // 2)
    inv = torch.exp(dd.to(torch.float32) * (-2.0 * math.log(10000.0) / dh))
    ang = float(t) * inv
    return torch.sin(ang), torch.cos(ang)


def _rot_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def fused_decode_step_ref(
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    h: torch.Tensor,  # (B, D) f32 embedded token (+ positional rows)
    t: int,
    cfg: FusedDecodeConfig,
    *,
    use_quantized: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Plain version of the step.  Returns ``(h_out (B, D) f32, state,
    k_all (L, B·lh·dh), v_all)``; ``S`` and ``z`` are updated in place,
    as the kernel does.  ``use_quantized=False`` multiplies by the f32
    weight copies instead (a reference for the quantization error)."""
    B, dh = cfg.batch, cfg.dim_head
    gh, lh, m = cfg.gh, cfg.local_heads, cfg.nb_features
    R, Wn, H = cfg.ring_size, cfg.local_window, cfg.heads
    int4 = cfg.weight_quant == "int4"
    dn = dh ** -0.25
    ratio = m ** -0.5
    scale = dh ** -0.5
    Bg, Bl = B * gh, B * lh

    def matmul(x, name, i):
        xb = _bf16(x)
        if not use_quantized:
            return xb @ _bf16(params[f"_{name}_f"][i])
        wq, ws = params[f"{name}_q"][i], params[f"{name}_s"][i]
        if int4:
            lo, hi = unpack_int4(wq)
            kh = lo.shape[0]
            return (xb[:, :kh] @ lo.to(torch.float32)) * ws[0:1] + (
                xb[:, kh:] @ hi.to(torch.float32)) * ws[1:2]
        return (xb @ wq.to(torch.float32)) * ws

    h = h.to(torch.float32)
    if lh:
        sin, cos = _rotary(t, dh, h.device)
        slots = torch.arange(R, device=h.device)
        k_pos = t - 1 - torch.remainder(t - 1 - slots, R)
        valid = (k_pos >= 0) & (k_pos > t - Wn)
    k_list, v_list = [], []
    for i in range(cfg.depth):
        a = h if cfg.use_rezero else _layernorm(h, params["ln1_s"][i, 0], params["ln1_b"][i, 0])
        y = matmul(a, "wqkv", i)
        q, k, v = y.chunk(3, dim=-1)  # (B, H·dh) each
        # ---- global FAVOR heads (rows in b·gh + h order)
        qg = q[:, : gh * dh].reshape(Bg, dh)
        kg = k[:, : gh * dh].reshape(Bg, dh)
        vg = v[:, : gh * dh].reshape(Bg, dh)
        projT = params["projT"][i]
        dash_q = (qg * dn) @ projT
        dash_k = (kg * dn) @ projT
        diag_q = (qg.square() * (0.5 * dn * dn)).sum(-1, keepdim=True)
        diag_k = (kg.square() * (0.5 * dn * dn)).sum(-1, keepdim=True)
        stab = dash_q.amax(-1, keepdim=True)  # queries only; keys get 0
        q_p = ratio * (torch.exp(dash_q - diag_q - stab) + 1e-4)
        k_p = ratio * (torch.exp(dash_k - diag_k) + 1e-4)
        S = state["S"][i].to(torch.float32).reshape(m, Bg, dh)
        S = S + k_p.T[:, :, None] * vg[None]
        z = state["z"][i] + k_p
        state["S"][i] = S.reshape(m, Bg * dh).to(state["S"].dtype)
        state["z"][i] = z
        num = torch.einsum("cj,jcd->cd", _bf16(q_p), _bf16(S))
        den = torch.clamp((q_p * z).sum(-1), min=1e-12)
        outs = [(num / den[:, None]).reshape(B, gh * dh)]
        # ---- local windowed heads over the ring
        if lh:
            ql = q[:, gh * dh:].reshape(Bl, dh)
            kl = k[:, gh * dh:].reshape(Bl, dh)
            vl = v[:, gh * dh:].reshape(Bl, dh)
            qr = ql * cos + _rot_half(ql) * sin
            kr = kl * cos + _rot_half(kl) * sin
            K = state["ck"][i].to(torch.float32).reshape(R, Bl, dh)
            V = state["cv"][i].to(torch.float32).reshape(R, Bl, dh)
            s_ring = _bf16(K * qr[None]).sum(-1) * scale  # (R, Bl)
            if cfg.ring_quant:
                s_ring = s_ring * state["ck_s"][i]
            s_ring = torch.where(valid[:, None], s_ring, -math.inf)
            s_self = _bf16(qr * kr).sum(-1) * scale  # (Bl,)
            mx = torch.maximum(s_ring.amax(0), s_self)
            p_ring = torch.exp(s_ring - mx[None])
            p_self = torch.exp(s_self - mx)
            den_l = p_ring.sum(0) + p_self
            p_eff = p_ring * state["cv_s"][i] if cfg.ring_quant else p_ring
            o = torch.einsum("rc,rcd->cd", _bf16(p_eff), V)
            o = (o + p_self[:, None] * vl) / den_l[:, None]
            outs.append(o.reshape(B, lh * dh))
            k_list.append(kr.reshape(-1))
            v_list.append(vl.reshape(-1))
        o = torch.cat(outs, dim=-1)
        h = h + matmul(o, "wout", i)
        f = h if cfg.use_rezero else _layernorm(h, params["ln2_s"][i, 0], params["ln2_b"][i, 0])
        f1 = matmul(f, "w1", i)
        f1 = F.gelu(f1 + params["b1"][i, 0], approximate="tanh")
        f2 = matmul(f1, "w2", i)
        h = h + (f2 + params["b2"][i, 0])
    if lh:
        k_all, v_all = torch.stack(k_list), torch.stack(v_list)
    else:
        k_all = v_all = torch.zeros(cfg.depth, 0, device=h.device)
    return h, state, k_all, v_all


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/fused_decode.cu)
# ---------------------------------------------------------------------------

_PARAM_ORDER = (
    "ln1_s", "ln1_b", "ln2_s", "ln2_b",
    "wqkv_q", "wqkv_s", "wout_q", "wout_s",
    "w1_q", "w1_s", "b1", "w2_q", "w2_s", "b2", "projT",
)


def _expected_shapes(cfg: FusedDecodeConfig):
    L, D, F, HD = cfg.depth, cfg.dim, cfg.ff_inner, cfg.heads * cfg.dim_head
    kd = 2 if cfg.weight_quant == "int4" else 1
    ns = kd
    shapes = {
        "ln1_s": ((L, 1, D), torch.float32), "ln1_b": ((L, 1, D), torch.float32),
        "ln2_s": ((L, 1, D), torch.float32), "ln2_b": ((L, 1, D), torch.float32),
        "wqkv_q": ((L, D // kd, 3 * HD), torch.int8), "wqkv_s": ((L, ns, 3 * HD), torch.float32),
        "wout_q": ((L, HD // kd, D), torch.int8), "wout_s": ((L, ns, D), torch.float32),
        "w1_q": ((L, D // kd, F), torch.int8), "w1_s": ((L, ns, F), torch.float32),
        "b1": ((L, 1, F), torch.float32),
        "w2_q": ((L, F // kd, D), torch.int8), "w2_s": ((L, ns, D), torch.float32),
        "b2": ((L, 1, D), torch.float32),
        "projT": ((L, cfg.dim_head, cfg.nb_features), torch.float32),
        "S": ((L, cfg.nb_features, cfg.bg), torch.bfloat16),
        "z": ((L, cfg.batch * cfg.gh, cfg.nb_features), torch.float32),
    }
    if cfg.local_heads:
        R, blh = cfg.ring_size, cfg.batch * cfg.local_heads
        ring = torch.int8 if cfg.ring_quant else torch.bfloat16
        shapes["ck"] = ((L, R, cfg.bl), ring)
        shapes["cv"] = ((L, R, cfg.bl), ring)
        if cfg.ring_quant:
            shapes["ck_s"] = ((L, R, blh), torch.float32)
            shapes["cv_s"] = ((L, R, blh), torch.float32)
    return shapes


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernels copy 16 bytes "
                         f"at a time)")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type the C entry points of a kernel library."""
    lib.fused_decode_step.argtypes = (
        [ctypes.c_int] * 13 + [ctypes.c_void_p] + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 30
    )
    lib.fused_decode_step.restype = ctypes.c_int
    lib.fused_decode_fits.argtypes = [ctypes.c_int] * 5
    lib.fused_decode_fits.restype = ctypes.c_int
    lib.fused_decode_attn_smem.argtypes = [ctypes.c_int] * 6
    lib.fused_decode_attn_smem.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use)."""
    return _bind(load_library("fused_decode"))


def _position(t, device) -> torch.Tensor:
    """t as the int64 on the device that the kernels read: a 0-d int64
    tensor there is taken as it is (a CUDA graph replays the step at the
    position it holds); an int is copied there."""
    if isinstance(t, torch.Tensor):
        if t.device != device or t.dtype != torch.int64 or t.numel() != 1:
            raise ValueError(f"t must be one int64 on {device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        return t
    return torch.full((), int(t), dtype=torch.int64, device=device)


def _launch(lib, params, state, h, t_dev, cfg: FusedDecodeConfig, stream: int):
    """Allocate the outputs and scratch and run the 5·L + 1 launches of
    the library's ``fused_decode_step`` on ``stream``."""
    dev = h.device
    B, D, H, dh, F = cfg.batch, cfg.dim, cfg.heads, cfg.dim_head, cfg.ff_inner
    L, lh, m = cfg.depth, cfg.local_heads, cfg.nb_features
    int4 = cfg.weight_quant == "int4"
    refusal = _plan_refusal(lib, cfg)
    if refusal is not None:
        raise ValueError(f"{refusal}: {cfg}")
    h_out = torch.empty_like(h)
    k_all = torch.empty(L, cfg.bl, dtype=torch.float32, device=dev)
    v_all = torch.empty(L, cfg.bl, dtype=torch.float32, device=dev)
    qkv = torch.empty(B, 3 * H * dh, dtype=torch.float32, device=dev)
    stats = torch.empty(B, D // 32, 2, dtype=torch.float32, device=dev)
    o = torch.empty(B, H * dh, dtype=torch.bfloat16, device=dev)
    f1 = torch.empty(B, F, dtype=torch.bfloat16, device=dev)
    dn = dh ** -0.25
    consts = [dn, 0.5 * dn * dn, m ** -0.5, dh ** -0.5, -2.0 * math.log(10000.0) / dh]

    def ptr(name):
        x_ = state.get(name)
        return x_.data_ptr() if x_ is not None else None

    err = lib.fused_decode_step(
        L, B, D, H, dh, lh, m, cfg.ring_size, cfg.local_window, F,
        int(int4), int(cfg.use_rezero), int(cfg.ring_quant), t_dev.data_ptr(),
        *consts,
        h.data_ptr(), h_out.data_ptr(),
        *[params[k].data_ptr() for k in _PARAM_ORDER],
        ptr("S"), ptr("z"), ptr("ck"), ptr("cv"), ptr("ck_s"), ptr("cv_s"),
        k_all.data_ptr(), v_all.data_ptr(),
        qkv.data_ptr(), stats.data_ptr(), o.data_ptr(), f1.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_decode_step: CUDA error {err}")
    return h_out, state, k_all, v_all


def fused_decode_step(
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    h: torch.Tensor,
    t,
    cfg: FusedDecodeConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """One decode step through all L layers — same contract as
    :func:`fused_decode_step_ref`: returns ``(h_out, state, k_all,
    v_all)``, with ``S`` and ``z`` updated IN PLACE (as the TPU kernel
    aliases them).  ``t`` is an int or a 0-d int64 tensor on ``h``'s
    device (what a CUDA graph of the step captures).

    A CUDA ``h`` launches the hand-written kernels, 5·L + 1 of them (every
    tensor checked for device, dtype, shape and contiguity; anything else
    raises); a CPU ``h`` takes the plain version.
    ``fused_decode_step.launches`` counts the steps launched, one a call;
    a call made while a CUDA graph is being captured launches nothing and
    is not counted (its graph's owner counts the replays)."""
    if h.device.type == "cpu":
        return fused_decode_step_ref(params, state, h, int(t), cfg)
    if h.device.type != "cuda":
        raise ValueError(f"no fused decode step for device {h.device}")
    if not _widths_ok(cfg.gh, cfg.dim_head, cfg.dim, cfg.ff_inner):
        raise ValueError(f"config not tiled by the CUDA step: {cfg}")
    dev = h.device
    _check("h", h, (cfg.batch, cfg.dim), torch.float32, dev)
    shapes = _expected_shapes(cfg)
    for name in _PARAM_ORDER:
        _check(name, params[name], *shapes[name], dev)
    for name in ("S", "z", "ck", "cv", "ck_s", "cv_s"):
        if name in shapes:
            _check(name, state[name], *shapes[name], dev)
    out = _launch(_lib(), params, state, h, _position(t, dev), cfg,
                  torch.cuda.current_stream(dev).cuda_stream)
    if not torch.cuda.is_current_stream_capturing():
        fused_decode_step.launches += 1
    return out


fused_decode_step.launches = 0


def count_graph_replay() -> None:
    """Count one step in ``fused_decode_step.launches`` for a replay of a
    CUDA graph that captured :func:`fused_decode_step` (the capture
    itself launched nothing and was not counted)."""
    fused_decode_step.launches += 1

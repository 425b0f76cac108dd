"""Re-validate the fused decode step's quality on a trained prior.

Port of ``tools/validate_fused_decode.py``, with its flags, model,
latents and printed JSON line.  Trains a small but real Performer
(6L/d256, 4 heads of 64 of which 2 local with window 64, m 128) on
structured synthetic latents of an 8×8×8 grid (vocab 512) through
``train/transformer_steps`` and ``runners/transformer.prepare_batch``,
then measures:

- greedy-decode agreement between the exact path
  (``make_sampler(fused=False)``) and the fused step with ``--weight-quant``
  weights, with bf16 and with int8 rings;
- teacher-forced over 256 tokens: the exact logits from the batch
  forward against the fused step's (int8 rings), stepped here through
  ``ops/fused_decode.fused_decode_step`` (the CUDA kernel on the card,
  its plain version on the host): at the last position the largest
  |Δlogit| over the logit std and the greedy agreement, as the JAX tool
  reports them, and over all positions the mean KL(exact‖fused) and
  total variation of the softmax, as ``chip_smoke.py`` phase 14 does.

On the card the prior trains through the FAVOR+ and local-attention
kernels (rows 5 and 6; the JAX tool's XLA paths compute the same), and
at a few positions of the teacher-forced roll, including the ring's
wrap, the kernel step is held against its plain version layer by layer
on copies of the same state (it raises on a mismatch).  The roll embeds each token
with the model's full position table and steps the model's own block
form (``use_rezero`` from the model): the JAX tool's roll adds only the
learned positional rows and builds a pre-LayerNorm step, which differs
from its model under ``--paper-form``.

    python -m synthanatomy_tpu_torch.tools.validate_fused_decode [--steps 400] \\
        [--weight-quant int8|int4] [--paper-form]
    python -m synthanatomy_tpu_torch.tools.validate_fused_decode --cpu --steps 2

``main`` returns the printed JSON record as a dict.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from synthanatomy_tpu_torch.models.ordering import Ordering
from synthanatomy_tpu_torch.models.performer import Performer
from synthanatomy_tpu_torch.models.sampling import make_sampler
from synthanatomy_tpu_torch.ops.fused_decode import (
    FusedDecodeConfig,
    fused_decode_step,
    fused_decode_step_ref,
    init_fused_state,
    pack_fused_params,
    strip_reference_weights,
    supports_fused_decode,
    update_rings,
)
from synthanatomy_tpu_torch.runners.transformer import prepare_batch
from synthanatomy_tpu_torch.tools._probe_util import device_name, probe_device
from synthanatomy_tpu_torch.train.transformer_steps import (
    create_transformer_train_state,
    make_transformer_train_step,
)

GRID = (8, 8, 8)
VOCAB = 512
N_VOLS = 64
MODEL = dict(dim=256, depth=6, heads=4, dim_head=64, local_attn_heads=2, local_window_size=64,
             nb_features=128)
SAMPLE_BATCH = 4
T_TF = 256  # teacher-forced tokens
CHECK_T = (0, 1, 63, 64, 127, 128, 255)  # kernel vs plain step (the 128-slot ring wraps at 128)


def structured_latents(rng: np.random.Generator) -> np.ndarray:
    """(N_VOLS, *GRID) codes: a smooth position-dependent pattern, a small
    per-volume offset and 2% noise: learnable to a low CE, but not
    degenerate (the JAX tool's :71-84, drawing from ``rng`` in its
    order)."""
    seq = int(np.prod(GRID))
    pos = np.arange(seq)
    base = (7 * pos + (pos // 8) * 3) % VOCAB
    vols = []
    for i in range(N_VOLS):
        v = (base + (i % 4) * 11) % VOCAB
        noise = rng.random(seq) < 0.02
        v = np.where(noise, rng.integers(0, VOCAB, seq), v)
        vols.append(v.reshape(GRID))
    return np.stack(vols)


def build_prior(ordering, paper_form, dev, dtype=torch.bfloat16, seed=0) -> Performer:
    """The JAX tool's prior; ``paper_form``: ReZero blocks and learned
    spatial tables.  Trains through the attention kernels; never redraws
    its projections (the JAX tool's loop does not)."""
    extra = (dict(use_rezero=True, spatial_position_emb="absolute", spatial_shape=GRID,
                  ordering=ordering) if paper_form else {})
    return Performer(
        num_tokens=VOCAB + 1, max_seq_len=int(np.prod(GRID)) + 1, dtype=dtype, scan_chunk=128,
        use_pallas_favor=True, use_pallas_local=True, feature_redraw_interval=0,
        generator=torch.Generator().manual_seed(seed), device="cpu", **MODEL, **extra,
    ).to(dev)


def train(model, ordering, latents, rng, steps, batch, lr):
    """``steps`` Adam steps on random batches of ``latents``; returns the
    per-step CE losses."""
    dev = next(model.parameters()).device
    state = create_transformer_train_state(model, seed=0, learning_rate=lr)
    step = make_transformer_train_step(model)
    t0 = time.time()
    losses = []
    for it in range(steps):
        sel = rng.integers(0, len(latents), batch)
        inputs, targets = (torch.as_tensor(x, device=dev)
                           for x in prepare_batch(latents[sel], ordering, VOCAB))
        state, metrics = step(state, inputs, targets, None, {"lr": lr})
        losses.append(float(metrics["Loss"]))
        if (it + 1) % 100 == 0:
            print(f"step {it + 1}: CE={losses[-1]:.4f} ({time.time() - t0:.0f}s)",
                  file=sys.stderr)
    return losses


def greedy_grids(model, ordering, weight_quant):
    """Greedy grids (B4) of the exact path and of the fused step with
    bf16 and with int8 rings."""
    model.eval()
    return {key: make_sampler(model, ordering, batch=SAMPLE_BATCH, do_sample=False,
                              fused=fused, ring_quant=rq, weight_quant=weight_quant)(None)
            for key, fused, rq in (("exact", False, False), ("fused_bf16_rings", True, False),
                                   ("fused_int8_rings", True, True))}


def _close(name, got, want):
    """Kernel step against its plain version on the same state (as
    chip_smoke.py::_compare): max abs error at most 1e-2 of max |plain|
    and norm-relative error at most 5e-3 — both sum in other orders and
    an activation on a bf16 rounding boundary may round the other way
    before a product (the bf16 state S by one ulp); a wrong index or
    mask gives errors of order 1.  Returns max abs error / max |plain|."""
    got, want = got.float(), want.float()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if not (err <= 1e-2 * scale
            and float(torch.linalg.norm(got - want)) <= 5e-3 * float(torch.linalg.norm(want))):
        raise RuntimeError(f"validate_fused_decode: fused step kernel disagrees with its plain "
                           f"version on {name}: max abs err {err}, max |plain| {scale}")
    return err / max(scale, 1e-30)


def _check_layers(params, state, h, t, cfg):
    """The kernel step against its plain version layer by layer along the
    kernel's own trajectory (as chip_smoke.py::_check_step): layer i's
    kernel and plain version get the same input and a copy of the same
    state slice, and their h, k, v, S and z must agree.  A whole-depth
    comparison would let one rounding flip in an early layer grow through
    the later ones.  Returns the largest relative error."""
    one = dataclasses.replace(cfg, depth=1)
    worst, x = 0.0, h
    for i in range(cfg.depth):
        p = {k: v[i:i + 1].clone() for k, v in params.items()}
        sk = {k: v[i:i + 1].clone() for k, v in state.items()}
        sr = {k: v.clone() for k, v in sk.items()}
        hk, _, kk, vk = fused_decode_step(strip_reference_weights(p), sk, x, t, one)
        hr, _, kr, vr = fused_decode_step_ref(p, sr, x, t, one)
        for name, a, w in (("h", hk, hr), ("k", kk, kr), ("v", vk, vr),
                           ("S", sk["S"], sr["S"]), ("z", sk["z"], sr["z"])):
            worst = max(worst, _close(f"{name} of layer {i} at t={t}", a, w))
        x = hk
    return worst


@torch.no_grad()
def fused_logits(model, toks, weight_quant):
    """Teacher-forced logits (B, T, V) f32 of the fused step (int8 rings)
    over ``toks``: embedding plus position rows in f32, the whole-depth
    step, then the final LayerNorm and the head in f32.  On the card, the
    kernel step at the positions ``CHECK_T`` is held against its plain
    version (``_check_layers``); returns (logits, the largest relative
    error of those checks)."""
    b, n = toks.shape
    dev = toks.device
    cfg = FusedDecodeConfig(
        depth=model.depth, batch=b, dim=model.dim, heads=model.heads, dim_head=model.dim_head,
        local_heads=model.local_attn_heads, local_window=model.local_window_size,
        nb_features=model.nb_features, ff_mult=model.ff_mult, ring_quant=True,
        use_rezero=model.use_rezero, weight_quant=weight_quant)
    params = pack_fused_params(model, weight_quant=weight_quant)
    kernel_params = strip_reference_weights(params)
    state = init_fused_state(cfg, device=dev)
    emb = model.token_emb.weight.float()
    pos = model.position_table(n)
    fn_s, fn_b = model.final_norm.weight.float(), model.final_norm.bias.float()
    head_w, head_b = model.to_out.weight.float().T, model.to_out.bias.float()
    logits, worst = [], 0.0
    for t in range(n):
        h = emb[toks[:, t]] + pos[t]
        if dev.type == "cuda" and t in CHECK_T:
            worst = max(worst, _check_layers(params, state, h, t, cfg))
        h_out, state, k_all, v_all = fused_decode_step(kernel_params, state, h, t, cfg)
        update_rings(state, k_all, v_all, t, cfg)
        mu = h_out.mean(-1, keepdim=True)
        var = (h_out - mu).square().mean(-1, keepdim=True)
        hn = (h_out - mu) * torch.rsqrt(var + 1e-6) * fn_s + fn_b
        logits.append(hn @ head_w + head_b)
    return torch.stack(logits, dim=1), worst


@torch.no_grad()
def teacher_forced(model, latents, weight_quant):
    """The exact batch forward against the fused step over the first
    ``T_TF`` tokens of volume 0 (BOS first), B2."""
    model.eval()
    dev = next(model.parameters()).device
    toks = np.concatenate([[VOCAB], latents[0].reshape(-1)[: T_TF - 1]])
    toks = torch.as_tensor(toks[None].repeat(2, 0), dtype=torch.long, device=dev)
    exact = model(toks).float()
    fused, step_err = fused_logits(model, toks, weight_quant)
    last_e, last_f = exact[:, -1], fused[:, -1]
    std = float(last_e.std(unbiased=False))
    lp, lq = F.log_softmax(exact, dim=-1), F.log_softmax(fused, dim=-1)
    return {
        "max_rel": float((last_e - last_f).abs().max()) / (std + 1e-9),
        "greedy": float((last_e.argmax(-1) == last_f.argmax(-1)).float().mean()),
        "std": std,
        "kl": float((lp.exp() * (lp - lq)).sum(-1).mean()),
        "tv": float(0.5 * (lp.exp() - lq.exp()).abs().sum(-1).mean()),
        "step_err": step_err,
        "exact": exact, "fused": fused,
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-quant", default="int8", choices=["int8", "int4"],
                   help="fused-path weight stream format (int4 = packed nibbles, "
                   "per-half-channel scales)")
    p.add_argument("--paper-form", action="store_true",
                   help="ReZero blocks + learned 'absolute' spatial tables (the bench.py "
                   "headline block/embedding form)")
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the host")
    return p.parse_args(argv)


def train_prior(args: argparse.Namespace, dev) -> dict:
    """The validation prior trained on structured latents: its model,
    ordering, latents and losses."""
    ordering = Ordering("raster_scan", 3, GRID)
    rng = np.random.default_rng(0)
    latents = structured_latents(rng)
    model = build_prior(ordering, args.paper_form, dev)
    if not supports_fused_decode(model):
        raise RuntimeError("the validation prior is not one the fused step covers")
    losses = train(model, ordering, latents, rng, args.steps, args.batch, args.lr)
    return {"model": model, "ordering": ordering, "latents": latents, "losses": losses}


def validate(trained: dict, weight_quant: str, args: argparse.Namespace, dev) -> dict:
    """The fused step against the exact path on the trained prior, with
    ``weight_quant`` weights: the record ``main`` prints."""
    model, ordering, latents = trained["model"], trained["ordering"], trained["latents"]
    grids = greedy_grids(model, ordering, weight_quant)
    agree = {k: float((grids["exact"] == g).float().mean()) for k, g in grids.items()}
    tf = teacher_forced(model, latents, weight_quant)
    return {
        "block_form": "rezero+spatial" if args.paper_form else "preln",
        "weight_quant": weight_quant,
        "trained_ce": round(trained["losses"][-1], 4),
        "greedy_agreement_fused_bf16_rings": round(agree["fused_bf16_rings"], 4),
        "greedy_agreement_fused_int8_rings": round(agree["fused_int8_rings"], 4),
        "teacher_forced_max_rel_logit_perturbation": round(tf["max_rel"], 4),
        "teacher_forced_greedy_agreement": round(tf["greedy"], 4),
        "logit_std": round(tf["std"], 3),
        "teacher_forced_mean_kl": tf["kl"],
        "teacher_forced_mean_tv": tf["tv"],
        "fused_step_kernel_vs_plain_max_rel_err": tf["step_err"],
        "device": device_name(dev),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = probe_device(args.cpu)
    print(f"device: {device_name(dev)}", file=sys.stderr)
    record = validate(train_prior(args, dev), args.weight_quant, args, dev)
    print(json.dumps(record))
    return record

if __name__ == "__main__":
    main()

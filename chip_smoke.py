#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port: synthesis and prior training
at paper width.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero, printing no
result, without them.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build of the kernels from ``synthanatomy_tpu_torch/csrc`` (timed);
3. the fused decode kernel against its plain PyTorch version, at paper
   width and at the small test shape, for int8 weights + bf16 rings and
   int4 weights + int8 rings, pre-LayerNorm and ReZero, at t in
   {0, 1, 447, 448, 1000} (ring wrap and window masking), on seeded
   random states: layer by layer on the same inputs, and the
   whole-depth call against the chain of its layers (``_check_step``);
4. the paper synthesis: ``make_synthesizer`` at B16 with its defaults
   (int8 weights, int8 rings) — 24L/d512/16h Performer (8 local heads,
   window 420, ReZero, learned spatial tables, raster 10x14x10) and the
   4-level 256-channel VQ-VAE in bf16, seeded random weights — checked
   for grid and volume shapes, code range, finite volumes and exactly
   1400 kernel launches per sampler call; then the sampler once more
   with int4 weights; then greedy sampling of a small prior through the
   kernel against the plain step on the CPU;
5. timings on the card: kernel step vs plain step, sampling tok/s,
   decode ms per volume;
6. the training kernels (FAVOR+ forward, dq and dk/dv sweeps; banded
   local attention forward and backward) against their plain versions on
   the same seeded inputs, at the paper shape (B6, 8 + 8 heads, L 1400,
   d 64, m 256, w 420, bf16) and at awkward small shapes (L not a
   multiple of the chunk or block, L < w, w not a multiple of the
   block): output, dq, dk and dv (``_compare_grad``), and two backward
   runs bit-identical;
7. the paper training path: ``create_transformer_train_state`` +
   ``make_transformer_train_step`` on the 24L/d512/16h prior (8 local
   heads, window 420, ReZero with non-zero gains, learned spatial tables,
   raster 10x14x10, vocab 2049), bf16 compute and attention, both
   kernels on, B6 of seeded synthetic latents through ``prepare_batch``:
   one step through the kernels against the same step through the plain
   versions (loss, gradients), then a few steps on a repeated batch with
   a projection redraw: finite losses, a lower loss after than at step 0,
   and exactly 24 layers x 3 launches of each kernel per step;
8. timings on the card: train step kernels vs plain (ms, tokens/s, peak
   memory), forward + backward of each kernel vs its plain version, and a
   torch.profiler breakdown of one kernel step.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
GRID = (10, 14, 10)
SEQ = 1400
BATCH = 16
T_CHECK = (0, 1, 447, 448, 1000)
TRAIN_BATCH = 6  # the paper batch of tools/bench_transformer.py
TRAIN_STEPS = 5
LAUNCHES_PER_STEP = 24 * 3  # per kernel family: forward + two backward launches per layer


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _random_state(cfg, gen, device):
    """Seeded decode state of realistic size and sign."""
    import torch

    L, R, m = cfg.depth, cfg.ring_size, cfg.nb_features

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    st = {
        "S": (randn(L, m, cfg.bg) * 0.5).to(torch.bfloat16),
        "z": torch.rand(L, cfg.batch * cfg.gh, m, generator=gen, device=device) * 2.5 + 0.5,
    }
    if cfg.ring_quant:
        blh = cfg.batch * cfg.local_heads
        for k in ("ck", "cv"):
            st[k] = torch.randint(-127, 128, (L, R, cfg.bl), generator=gen,
                                  device=device).to(torch.int8)
            st[k + "_s"] = torch.rand(L, R, blh, generator=gen, device=device) * 0.015 + 0.005
    else:
        for k in ("ck", "cv"):
            st[k] = randn(L, R, cfg.bl).to(torch.bfloat16)
    return st, randn(cfg.batch, cfg.dim)


def _performer(rezero, *, dim, depth, heads, local_heads, window, seed, device,
               grid=GRID):
    import numpy as np
    import torch

    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer

    ordering = Ordering("raster_scan", 3, grid)
    model = Performer(
        num_tokens=2049, max_seq_len=int(np.prod(grid)) + 1, dim=dim, depth=depth,
        heads=heads, dim_head=64, local_attn_heads=local_heads,
        local_window_size=window, use_rezero=rezero, spatial_position_emb="absolute",
        spatial_shape=grid, ordering=ordering,
        generator=torch.Generator().manual_seed(seed),
    )
    with torch.no_grad():
        for blk in model.blocks:
            if rezero:  # ReZero starts at identity: non-trivial gains
                blk.g_attn.fill_(0.7)
                blk.g_ff.fill_(0.5)
            else:
                blk.norm_attn.weight.normal_(1.0, 0.1, generator=torch.Generator().manual_seed(seed))
    return model.to(device), ordering


def _compare(name, a, b):
    """Kernel vs plain on the same input: max abs error at most 1e-2 of
    the plain output's largest magnitude, and norm-relative error at most
    5e-3.  Both sum in other orders, so an activation on a bf16 rounding
    boundary may round the other way before a GEMV (2^-8 relative), and
    bf16-stored S may differ by an ulp (2^-8 of its magnitude); a wrong
    index or formula gives errors of order 1.  Returns the max abs error."""
    import torch

    a, b = a.float(), b.float()
    err = float((a - b).abs().max())
    ok = err <= 1e-2 * float(b.abs().max()) and float(
        torch.linalg.norm(a - b)) <= 5e-3 * float(torch.linalg.norm(b))
    _require(ok, f"kernel disagrees with plain on {name}: max abs err {err}, "
                 f"max |plain| {float(b.abs().max())}")
    return err


def _check_step(label, params, cfg, gen, dev):
    """The kernel against its plain version for one decode step, at
    every t of T_CHECK on seeded random states.

    Layer by layer along the kernel's own trajectory: layer i's kernel
    and plain version get the same input (the kernel's h after layer
    i-1) and the same state slice, and their h, k, v, S and z must agree
    (``_compare``).  The whole-depth kernel call must then equal that
    chain of one-layer kernel calls bit for bit, which checks its layer
    loop.  A whole-depth comparison with the plain version tests nothing
    at random weights: one bf16 rounding flip in an early layer grows
    through 24 layers, and the plain version on the CPU differs from the
    plain version on the card by as much.  Returns the largest error of
    the outputs (h, k, v) and of the state (S, z)."""
    import torch
    from synthanatomy_tpu_torch.ops import fused_decode as fd

    one = dataclasses.replace(cfg, depth=1)
    layers = [{k: v[i:i + 1].clone() for k, v in params.items()} for i in range(cfg.depth)]
    out_err = state_err = 0.0
    for t in T_CHECK:
        st, h = _random_state(cfg, gen, dev)
        full = {k: v.clone() for k, v in st.items()}
        h_full, _, k_full, v_full = fd.fused_decode_step(params, full, h, t, cfg)
        x = h
        for i, p in enumerate(layers):
            sk = {k: v[i:i + 1].clone() for k, v in st.items()}
            sr = {k: v.clone() for k, v in sk.items()}
            hr, _, kr, vr = fd.fused_decode_step_ref(p, sr, x, t, one)
            hk, _, kk, vk = fd.fused_decode_step(p, sk, x, t, one)
            torch.cuda.synchronize()
            where = f"{label}/layer {i}/t={t}"
            for name, a, b in (("h", hk, hr), ("k", kk, kr), ("v", vk, vr)):
                out_err = max(out_err, _compare(f"{where}/{name}", a, b))
            for name in ("S", "z"):
                state_err = max(state_err, _compare(f"{where}/{name}", sk[name], sr[name]))
            same = (torch.equal(k_full[i], kk[0]) and torch.equal(v_full[i], vk[0])
                    and all(torch.equal(full[k][i], sk[k][0]) for k in ("S", "z")))
            _require(same, f"{where}: whole-depth kernel differs from layer {i} alone")
            x = hk
        _require(torch.equal(h_full, x), f"{label}/t={t}: whole-depth h differs from the chain")
    return out_err, state_err


def _compare_grad(name, a, b):
    """A training kernel against its plain version on the same inputs
    (both at the same rounding points, summing in other orders): max abs
    error at most 2e-2 of the plain result's largest magnitude and
    norm-relative error at most 1e-2.  An operand on a bf16 rounding
    boundary may round the other way (2^-8 of it) and move the results it
    feeds by up to ~1e-2 of the largest; a wrong index, mask or sweep
    order gives errors of order 1.  Returns the max abs error."""
    import torch

    a, b = a.float(), b.float()
    err = float((a - b).abs().max())
    ok = err <= 2e-2 * float(b.abs().max()) and float(
        torch.linalg.norm(a - b)) <= 1e-2 * float(torch.linalg.norm(b))
    _require(ok, f"kernel disagrees with plain on {name}: max abs err {err}, "
                 f"max |plain| {float(b.abs().max())}, norm-rel "
                 f"{float(torch.linalg.norm(a - b) / torch.linalg.norm(b))}")
    return err


def _fwd_bwd(fn, q, k, v, g):
    import torch

    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return [out.detach()] + list(torch.autograd.grad(out, leaves, g.to(out.dtype)))


def _attention_inputs(shape, dtype, seed, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(*shape, generator=gen, device=dev) for _ in range(4))
    return q.to(dtype), k.to(dtype), (v * 0.5).to(dtype), g


def _check_training_kernels(dev):
    """Phase 6; returns {kernel: max abs err at the paper shape}."""
    import torch
    from synthanatomy_tpu_torch.ops import favor_attention as fa
    from synthanatomy_tpu_torch.ops import local_attention_flash as lf
    from synthanatomy_tpu_torch.ops.favor import gaussian_orthogonal_random_matrix

    bf16, f32 = torch.bfloat16, torch.float32
    favor_shapes = [("paper", (6, 8, 1400, 64), 256, 128, bf16),
                    ("L % chunk != 0", (1, 2, 37, 16), 32, 16, f32),
                    ("L % chunk != 0, bf16", (2, 3, 300, 64), 256, 128, bf16)]
    local_shapes = [("paper", (6, 8, 1400, 64), 420, bf16),
                    ("L < w", (1, 2, 20, 16), 40, bf16),
                    ("w % block != 0", (2, 2, 100, 64), 45, bf16),
                    ("L % block != 0, f32", (1, 2, 37, 16), 12, f32)]
    errs = {"favor": 0.0, "local": 0.0}
    for label, shape, m, chunk, dtype in favor_shapes:
        q, k, v, g = _attention_inputs(shape, dtype, shape[2], dev)
        proj = gaussian_orthogonal_random_matrix(
            m, shape[-1], generator=torch.Generator().manual_seed(1)).to(dev)
        got = _fwd_bwd(lambda *x: fa.favor_attention_fused(*x, proj, chunk), q, k, v, g)
        want = _fwd_bwd(lambda *x: fa.favor_attention_fused_plain(*x, proj, chunk), q, k, v, g)
        torch.cuda.synchronize()
        err = max(_compare_grad(f"favor {label} {n}", a, b)
                  for n, a, b in zip(("out", "dq", "dk", "dv"), got, want))
        again = _fwd_bwd(lambda *x: fa.favor_attention_fused(*x, proj, chunk), q, k, v, g)
        _require(all(torch.equal(a, b) for a, b in zip(got, again)),
                 f"favor {label}: two runs differ")
        if label == "paper":
            errs["favor"] = err
        print(f"[check] favor_attention_fused == plain ({label}: {tuple(shape)}, m {m}, "
              f"chunk {chunk}, {str(dtype)[6:]}): out/dq/dk/dv max abs err {err:.3e} (tol "
              f"2e-2 of max |plain|, 1e-2 in norm); two runs bit-identical")
    for label, shape, w, dtype in local_shapes:
        q, k, v, g = _attention_inputs(shape, dtype, shape[2] + w, dev)
        got = _fwd_bwd(lambda *x: lf.local_attention_flash_core(*x, w), q, k, v, g)
        want = _fwd_bwd(lambda *x: lf.local_attention_flash_plain(*x, w), q, k, v, g)
        torch.cuda.synchronize()
        err = max(_compare_grad(f"local {label} {n}", a, b)
                  for n, a, b in zip(("out", "dq", "dk", "dv"), got, want))
        again = _fwd_bwd(lambda *x: lf.local_attention_flash_core(*x, w), q, k, v, g)
        _require(all(torch.equal(a, b) for a, b in zip(got, again)),
                 f"local {label}: two runs differ")
        if label == "paper":
            errs["local"] = err
        print(f"[check] local_attention_flash == plain ({label}: {tuple(shape)}, w {w}, "
              f"{str(dtype)[6:]}): out/dq/dk/dv max abs err {err:.3e} (tol 2e-2 of max "
              f"|plain|, 1e-2 in norm); two runs bit-identical")
    return errs


@contextlib.contextmanager
def _plain_kernels():
    """Route the model's attention through the kernels' plain versions
    (on the card too) for the length of the block."""
    from synthanatomy_tpu_torch.ops import favor_attention as fa
    from synthanatomy_tpu_torch.ops import local_attention_flash as lf

    with mock.patch.object(fa, "favor_attention_fused", fa.favor_attention_fused_plain), \
            mock.patch.object(lf, "local_attention_flash_core", lf.local_attention_flash_plain):
        yield


def _train_prior(dev, dtype):
    """The paper prior for training, both kernels on, compute and
    attention in ``dtype``.  The ReZero gains are set to 0.1: non-zero
    (at zero every block weight has a zero gradient), and small enough
    that the residual stream stays at the embeddings' scale through 24
    layers.  At gains 0.7/0.5 it grows to std ~15 and a bf16 step becomes
    chaotic: two plain implementations that round at other points (the
    kernels' twins and the XLA-path ops) then disagree by ~0.95 in
    gradient norm, so no comparison can tell a kernel fault from noise."""
    import torch

    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer

    ordering = Ordering("raster_scan", 3, GRID)
    model = Performer(
        num_tokens=2049, max_seq_len=SEQ + 1, dim=512, depth=24, heads=16, dim_head=64,
        local_attn_heads=8, local_window_size=420, use_rezero=True,
        spatial_position_emb="absolute", spatial_shape=GRID, ordering=ordering,
        use_pallas_local=True, use_pallas_favor=True, attn_compute_dtype=dtype,
        dtype=dtype, feature_redraw_interval=2,
        generator=torch.Generator().manual_seed(20),
    ).to(dev)
    with torch.no_grad():
        for blk in model.blocks:
            blk.g_attn.fill_(0.1)
            blk.g_ff.fill_(0.1)
    return model, ordering


def _step_vs_plain(model, train_step, inputs, targets, sched):
    """One train step through the kernels and the same step through the
    plain versions, from the same weights (restored after).  Returns the
    two losses, the gradient norm-relative error over all parameters,
    and the worst tensor with its own error."""
    import torch
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_transformer_train_state(model, seed=0)
    _, m_k = train_step(state, inputs, targets, None, sched)
    g_k = _grads(model)
    model.load_state_dict(init)
    with _plain_kernels():
        state = create_transformer_train_state(model, seed=0)
        _, m_p = train_step(state, inputs, targets, None, sched)
    g_p = _grads(model)
    model.load_state_dict(init)

    def rel(names):
        num = sum(float(torch.linalg.norm(g_k[n] - g_p[n])) ** 2 for n in names)
        return (num / max(sum(float(torch.linalg.norm(g_p[n])) ** 2 for n in names),
                          1e-60)) ** 0.5

    worst = max(g_k, key=lambda n: rel([n]))
    return float(m_k["Loss"]), float(m_p["Loss"]), rel(list(g_k)), worst, rel([worst])


def _grads(model):
    return {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}


def _time_ms(fn, reps):
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from synthanatomy_tpu_torch import _build
    from synthanatomy_tpu_torch.models.sampling import make_sampler
    from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE
    from synthanatomy_tpu_torch.ops import fused_decode as fd
    from synthanatomy_tpu_torch.pipeline import make_synthesizer

    dev = torch.device("cuda", 0)
    # f32 products of the plain versions run at full f32 (no TF32); the
    # paper decode runs its convolutions in bf16, where TF32 does not apply
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.sources())} kernel libraries ready in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")
    for line in _build.ptxas_report().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # 3. kernel against plain
    paper = dict(dim=512, depth=24, heads=16, local_heads=8, window=420)
    small = dict(dim=128, depth=2, heads=2, local_heads=1, window=12)
    variants = [("int8", False, False), ("int8", False, True),
                ("int4", True, False), ("int4", True, True)]
    models = {}
    max_err = 0.0
    for shape_name, shape in (("paper", paper), ("small", small)):
        batch = BATCH if shape_name == "paper" else 2
        for wq, rq, rezero in variants:
            key = (shape_name, rezero)
            if key not in models:
                models[key] = _performer(rezero, seed=10 + rezero, device=dev, **shape)[0]
            model = models[key]
            cfg = fd.FusedDecodeConfig(
                depth=model.depth, batch=batch, dim=model.dim, heads=model.heads,
                dim_head=64, local_heads=model.local_attn_heads,
                local_window=model.local_window_size, nb_features=model.nb_features,
                weight_quant=wq, ring_quant=rq, use_rezero=rezero)
            params = fd.strip_reference_weights(fd.pack_fused_params(model, weight_quant=wq))
            label = f"{shape_name} {wq} weights, {'int8' if rq else 'bf16'} rings, " \
                    f"{'ReZero' if rezero else 'pre-LN'}"
            out_err, state_err = _check_step(
                label, params, cfg, torch.Generator(device=dev).manual_seed(1234), dev)
            print(f"[check] kernel == plain, layer by layer ({label}; t in {T_CHECK}): "
                  f"max abs err h/k/v {out_err:.3e}, S/z {state_err:.3e} (tol 1e-2 of "
                  f"max |plain|, 5e-3 in norm); whole depth == chain of layers, bit for bit")
            if shape_name == "paper":
                max_err = max(max_err, out_err)
    del models

    # 4. the paper synthesis through make_synthesizer's defaults
    performer, ordering = _performer(True, seed=0, device=dev, **paper)
    vqvae = BaselineVQVAE(
        n_levels=4, downsample_parameters=((4, 2, 1, 1),) * 4,
        upsample_parameters=((4, 2, 1, 0, 1),) * 4, n_embed=2048, embed_dim=32,
        n_channels=256, n_res_channels=256, n_res_layers=3, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(2), device=dev,
    )
    synth = make_synthesizer(performer, vqvae, ordering, batch=BATCH, decode_batch=8)
    gen = torch.Generator(device=dev).manual_seed(3)
    fd.fused_decode_step.launches = 0
    t0 = time.perf_counter()
    vols, grids = synth(gen)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = fd.fused_decode_step.launches
    _require(launches == SEQ, f"main path launched the kernel {launches} times, want {SEQ}")
    _require(tuple(grids.shape) == (BATCH,) + GRID, f"grid shape {tuple(grids.shape)}")
    _require(int(grids.min()) >= 0 and int(grids.max()) < 2048, "codes outside [0, 2048)")
    _require(tuple(vols.shape) == (BATCH, 1, 160, 224, 160), f"volume shape {tuple(vols.shape)}")
    _require(bool(torch.isfinite(vols).all()), "non-finite volumes")
    print(f"[synth] make_synthesizer B{BATCH} (int8 weights, int8 rings): grids "
          f"{tuple(grids.shape)}, volumes {tuple(vols.shape)} {vols.dtype}, "
          f"{launches} kernel launches, first call {e2e_s:.2f} s")

    samplers = {}
    for wq in ("int8", "int4"):
        samplers[wq] = make_sampler(performer, ordering, batch=BATCH, ring_quant=True,
                                    weight_quant=wq)
    fd.fused_decode_step.launches = 0
    g4 = samplers["int4"](gen)
    torch.cuda.synchronize()
    _require(fd.fused_decode_step.launches == SEQ, "int4 sampler launch count")
    _require(tuple(g4.shape) == (BATCH,) + GRID and int(g4.min()) >= 0
             and int(g4.max()) < 2048, "int4 sampler grid")
    print(f"[synth] int4-weight sampler: grids {tuple(g4.shape)}, "
          f"{fd.fused_decode_step.launches} kernel launches")

    # greedy sampling of a small prior: kernel on the card vs plain on the CPU
    small_model, small_order = _performer(True, seed=5, device=dev, grid=(2, 3, 4), **small)
    small_cpu = _performer(True, seed=5, device="cpu", grid=(2, 3, 4), **small)[0]
    g_card = make_sampler(small_model, small_order, batch=2, do_sample=False,
                          ring_quant=True)(None).cpu()
    g_cpu = make_sampler(small_cpu, small_order, batch=2, do_sample=False,
                         ring_quant=True)(None)
    agree = float((g_card == g_cpu).float().mean())
    _require(agree >= 0.9, f"small greedy grids: kernel vs plain agreement {agree}")
    print(f"[check] small prior greedy grids, kernel (card) vs plain (CPU): "
          f"agreement {agree:.4f} over {g_cpu.numel()} codes")

    # 5. timings
    cfg = fd.FusedDecodeConfig(
        depth=24, batch=BATCH, dim=512, heads=16, dim_head=64, local_heads=8,
        local_window=420, nb_features=performer.nb_features, ring_quant=True,
        use_rezero=True)
    times = {}
    for wq in ("int8", "int4"):
        c = dataclasses.replace(cfg, weight_quant=wq)
        params = fd.strip_reference_weights(fd.pack_fused_params(performer, weight_quant=wq))
        st, h = _random_state(c, torch.Generator(device=dev).manual_seed(9), dev)
        # plain, kernel, kernel, plain (the card may drift within a call)
        p1 = _time_ms(lambda: fd.fused_decode_step_ref(params, st, h, 700, c), 5)
        k1 = _time_ms(lambda: fd.fused_decode_step(params, st, h, 700, c), 20)
        k2 = _time_ms(lambda: fd.fused_decode_step(params, st, h, 700, c), 20)
        p2 = _time_ms(lambda: fd.fused_decode_step_ref(params, st, h, 700, c), 5)
        times[wq] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[time] decode step B{BATCH} paper width, {wq} weights, int8 rings: "
              f"kernel {times[wq][0]:.3f} ms ({k1:.3f}, {k2:.3f}), "
              f"plain {times[wq][1]:.3f} ms ({p1:.3f}, {p2:.3f})  [{smi}]")
    for wq in ("int8", "int4"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samplers[wq](gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"[time] sampling B{BATCH}, {wq} weights, int8 rings: {dt:.3f} s per "
              f"call, {BATCH * SEQ / dt:.1f} latent tok/s  [{smi}]")
    with torch.no_grad():
        dec_ms = _time_ms(lambda: [vqvae.decode_samples([grids[i:i + 8]])
                                   for i in range(0, BATCH, 8)], 2) / BATCH
    print(f"[time] VQ-VAE decode (bf16, sub-batches of 8): {dec_ms:.2f} ms per "
          f"volume  [{smi}]")

    # 6. the training kernels against their plain versions
    del samplers, synth, vqvae, performer, small_model, small_cpu
    torch.cuda.empty_cache()
    kerr = _check_training_kernels(dev)

    # 7. the paper training path
    import numpy as np

    from synthanatomy_tpu_torch.ops import favor_attention as fa
    from synthanatomy_tpu_torch.ops import local_attention_flash as lf
    from synthanatomy_tpu_torch.runners.transformer import prepare_batch
    from synthanatomy_tpu_torch.train.transformer_steps import (
        create_transformer_train_state,
        make_transformer_eval_step,
        make_transformer_train_step,
    )

    # one step through the kernels against the same step through the plain
    # versions, from the same weights: in f32 (the kernels' f32
    # instantiations; only summation order differs) and in bf16 (the
    # training default; a few bf16 rounding flips per layer)
    sched = {"lr": 1e-4}  # the runner's default learning rate
    for dtype, loss_tol, grad_tol in ((torch.float32, 1e-5, 1e-4),
                                      (torch.bfloat16, 1e-3, 2e-2)):
        model, ordering = _train_prior(dev, dtype)
        latents = np.random.default_rng(21).integers(0, 2048, size=(TRAIN_BATCH,) + GRID)
        inputs, targets = (torch.as_tensor(x, device=dev)
                           for x in prepare_batch(latents, ordering, 2048))
        _require(tuple(inputs.shape) == (TRAIN_BATCH, SEQ), f"inputs {tuple(inputs.shape)}")
        train_step = make_transformer_train_step(model)
        loss_k, loss_p, grel, worst, worst_rel = _step_vs_plain(
            model, train_step, inputs, targets, sched)
        name = str(dtype)[6:]
        _require(abs(loss_k - loss_p) <= loss_tol * abs(loss_p),
                 f"{name} train step loss: kernels {loss_k} vs plain {loss_p}")
        _require(grel <= grad_tol, f"{name} train step gradients: norm-relative error {grel}")
        print(f"[check] paper train step ({name}), kernels vs plain versions (same weights, "
              f"same batch): loss {loss_k:.6f} vs {loss_p:.6f} (tol {loss_tol:g} relative), "
              f"gradient norm-relative error {grel:.3e} over all parameters (tol "
              f"{grad_tol:g}; largest per tensor {worst_rel:.3e} at {worst})")
        if dtype == torch.float32:
            del model, train_step
            torch.cuda.empty_cache()

    # the main path: steps on a repeated batch, with a redraw every 2 steps
    state = create_transformer_train_state(model, seed=1)
    losses = []
    proj0 = model.blocks[0].attn.projection.clone()
    fa.favor_attention_fused.launches = 0
    lf.local_attention_flash.launches = 0
    for _ in range(TRAIN_STEPS):
        state, metrics = train_step(state, inputs, targets, None, sched)
        losses.append(float(metrics["Loss"]))
    torch.cuda.synchronize()
    train_launches = {"favor": fa.favor_attention_fused.launches,
                      "local": lf.local_attention_flash.launches}
    want = TRAIN_STEPS * LAUNCHES_PER_STEP
    for name, got in train_launches.items():
        _require(got == want, f"{name} kernel: {got} launches in {TRAIN_STEPS} steps, "
                              f"want {want}")
    _require(not torch.equal(proj0, model.blocks[0].attn.projection), "no redraw")
    _, ev = make_transformer_eval_step(model)(state, inputs, targets)
    final = float(ev["Loss"])
    _require(all(np.isfinite(losses)) and np.isfinite(final), f"losses {losses} {final}")
    _require(final < losses[0], f"loss did not fall: {losses} then {final}")
    print(f"[train] paper prior B{TRAIN_BATCH} x {SEQ} tokens, bf16, {TRAIN_STEPS} steps "
          f"(redraw every 2): losses {[round(x, 4) for x in losses]}, after {final:.4f}; "
          f"launches per step favor {train_launches['favor'] // TRAIN_STEPS}, local "
          f"{train_launches['local'] // TRAIN_STEPS} (24 layers x fwd + 2 bwd)")

    # 8. timings
    tokens = TRAIN_BATCH * SEQ

    def step_s(reps):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = train_step(state, inputs, targets, None, sched)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    with _plain_kernels():
        p1 = step_s(2)
    torch.cuda.reset_peak_memory_stats()
    k1 = step_s(3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k2 = step_s(3)
    with _plain_kernels():
        torch.cuda.reset_peak_memory_stats()
        p2 = step_s(2)
        peak_plain = torch.cuda.max_memory_allocated() / 2 ** 30
    step_k, step_p = (k1 + k2) / 2 * 1e3, (p1 + p2) / 2 * 1e3
    print(f"[time] paper train step B{TRAIN_BATCH}: kernels {step_k:.1f} ms ({k1 * 1e3:.1f}, "
          f"{k2 * 1e3:.1f}), {tokens / (step_k / 1e3):.0f} tok/s, peak {peak:.2f} GiB; plain "
          f"{step_p:.1f} ms ({p1 * 1e3:.1f}, {p2 * 1e3:.1f}), {tokens / (step_p / 1e3):.0f} "
          f"tok/s, peak {peak_plain:.2f} GiB  [{smi}]")

    from synthanatomy_tpu_torch.ops.favor import gaussian_orthogonal_random_matrix

    q, k, v, g = _attention_inputs((TRAIN_BATCH, 8, SEQ, 64), torch.bfloat16, 5, dev)
    proj = gaussian_orthogonal_random_matrix(
        256, 64, generator=torch.Generator().manual_seed(2)).to(dev)
    pairs = {
        "favor": (lambda: _fwd_bwd(lambda *x: fa.favor_attention_fused(*x, proj), q, k, v, g),
                  lambda: _fwd_bwd(lambda *x: fa.favor_attention_fused_plain(*x, proj),
                                   q, k, v, g)),
        "local": (lambda: _fwd_bwd(lambda *x: lf.local_attention_flash_core(*x, 420),
                                   q, k, v, g),
                  lambda: _fwd_bwd(lambda *x: lf.local_attention_flash_plain(*x, 420),
                                   q, k, v, g)),
    }
    ktimes = {}
    for name, (kern, plain) in pairs.items():
        p1, k1, k2, p2 = (_time_ms(plain, 3), _time_ms(kern, 5), _time_ms(kern, 5),
                          _time_ms(plain, 3))
        ktimes[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[time] {name} fwd+bwd, B{TRAIN_BATCH} x 8 heads x L{SEQ} x d64 bf16 (one "
              f"layer): kernel {ktimes[name][0]:.3f} ms ({k1:.3f}, {k2:.3f}), plain "
              f"{ktimes[name][1]:.3f} ms ({p1:.3f}, {p2:.3f})  [{smi}]")

    from torch.profiler import ProfilerActivity, profile

    step_s(1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = step_s(1)
    rows = {}  # device-side events only (a CPU op's "self device time" repeats its kernels')
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dt = getattr(evt, "self_device_time_total", None)
            dt = evt.self_cuda_time_total if dt is None else dt
            rows[evt.key] = rows.get(evt.key, 0.0) + dt / 1e3
    busy = sum(rows.values())
    print(f"[profile] one kernel train step: wall {wall * 1e3:.1f} ms, device time "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% busy)  [{smi}]")
    for key, ms in sorted(rows.items(), key=lambda kv: -kv[1])[:14]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / busy:5.1f}%  {key[:90]}")

    print(json.dumps({"kernels": [{
        "name": "fused_decode_step",
        "route": "cuda",
        "source": "synthanatomy_tpu_torch/csrc/fused_decode.cu",
        "replaces": "synthanatomy_tpu/ops/fused_decode.py:541",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["int8"][0],
        "plain_ms": times["int8"][1],
    }, {
        "name": "favor_attention_fused",
        "route": "cuda",
        "source": "synthanatomy_tpu_torch/csrc/favor_attention.cu",
        "replaces": "synthanatomy_tpu/ops/favor_pallas.py:148",
        "launches": train_launches["favor"],
        "max_abs_err": kerr["favor"],
        "ms": ktimes["favor"][0],
        "plain_ms": ktimes["favor"][1],
    }, {
        "name": "local_attention_flash",
        "route": "cuda",
        "source": "synthanatomy_tpu_torch/csrc/local_attention.cu",
        "replaces": "synthanatomy_tpu/ops/local_attention_pallas.py:128",
        "launches": train_launches["local"],
        "max_abs_err": kerr["local"],
        "ms": ktimes["local"][0],
        "plain_ms": ktimes["local"][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port: synthesis and prior training
at paper width.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero, printing no
result, without them.  Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build of the kernels from ``synthanatomy_tpu_torch/csrc`` (timed),
   then the SASS of rows 2, 3, 5, 6, 7, 8, 9a and 9c (``cuobjdump
   -sass``): HMMA or HGMMA in every bf16 instantiation of their kernels
   (row 5: the chunk-parallel route's state, forward, dq and dk/dv kernels
   and their probe ablations), in every instantiation of the
   weight-streaming GEMVs (``matmul_kernel``, ``stream_kernel``), of row
   3's split-TF32 argmin (``vq_argmin_kernel``, which ptxas must not
   spill) and of row 9c's tile program (``tile_steps_kernel``), with each
   kernel's registers, spills and stack (``ptxas -v``) and the dynamic
   shared memory of their launches (rows 3 and 9c: their clusters, and
   how many fit the card at once);
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
5. timings on the card: row 1's step at t 700 with int8 and int4
   weights, elapsed and device time beside its plain version and its
   bound, with a torch.profiler breakdown of one step by kernel name and
   its launches per token (at most 5 L + 1); one token of the fused
   sampler as a CUDA-graph replay; the B16 sampler call
   (s per call, tok/s) through the graph; decode ms per volume;
6. the training kernels (FAVOR+ forward, dq and dk/dv sweeps; banded
   local attention forward and backward) against their plain versions on
   the same seeded inputs, at the paper shape (B6, 8 + 8 heads, L 1400,
   d 64, m 256, w 420, bf16) and at awkward small shapes (L not a
   multiple of the chunk or block, L < w, w not a multiple of the
   block; for FAVOR also the bench's L 1401, the validation prior's m
   128, L < chunk, exact row-max ties in bf16 and d 128 on the earlier
   kernels; for local attention also L one off a 64-row tile, w 1, 64, 65
   and ≥ L, d 16 to 128 and d 200): output, dq, dk and dv
   (``_compare_grad``), and two backward runs bit-identical;
7. the paper training path: ``create_transformer_train_state`` +
   ``make_transformer_train_step`` on the 24L/d512/16h prior (8 local
   heads, window 420, ReZero with non-zero gains, learned spatial tables,
   raster 10x14x10, vocab 2049), bf16 compute and attention, both
   kernels on, B6 of seeded synthetic latents through ``prepare_batch``:
   one step through the kernels against the same step through the plain
   versions (loss, gradients), then a few steps on a repeated batch with
   a projection redraw: finite losses, a lower loss after than at step 0,
   and exactly 24 layers x 7 launches of row 5 (forward: state, scan,
   consumer; backward: state, scan, dq, dk/dv) and 24 x 3 of row 6 per
   step;
8. timings on the card: train step kernels vs plain (ms, tokens/s, peak
   memory), forward, backward and forward + backward of rows 5 and 6 vs
   their plain versions (row 6 each in turns with SDPA with the banded
   mask), read as elapsed time and as device time, beside each bound
   and useful TFLOP/s (row 5's counted by ``_favor_flops``), and a
   torch.profiler breakdown of one kernel step;
9. the stage-1 kernels against their plain versions on the same seeded
   inputs: the VQ argmin and argmin + EMA statistics at the paper shape
   (N 4200 = B3 x 10x14x10 rows, K 2048, D 32) and at ragged N, K and D
   (indices equal except where the two best distances lie within a
   stated margin, counts exact, sums within tolerance, two runs
   bit-identical, and the device launches of one call by torch.profiler:
   one for the argmin, at most 3 for the statistics); the fused residual layer at the paper shape (1 x 128 x
   80x112x80 bf16, R 128) and at awkward ones (D/H/W not multiples of the
   tile, C != R, f32 and bf16, shapes of the tile route and of the GEMM
   route), each with x in NCDHW and in channels-last memory: y and h,
   then the backward on the same saved x, h, y and gy (dx, dW1, db1, dW2,
   db2), two backward runs bit-identical;
10. the paper stage 1 at full width from seeded random weights (4 levels,
   (4,2,1,1) down, (4,2,1,0,1) up, codebook 2048 x 32, 256 channels, 3
   slim residual layers per level, bf16, remat, fused residual auto):
   extraction (``index_quantize`` of B3 volumes -> (3, 10, 14, 10) codes
   in [0, 2048), one argmin launch) and ``decode_samples`` back to (3, 1,
   160, 224, 160); one train step (jukebox_perceptual + LPIPS alex on
   random features, keep 0.5; BaselineDiscriminator with least-square
   criteria, weight 0.005; Adam 3e-4 / 5e-4; EMA decay 0.5, commitment
   0.25; B3) through the kernels against the same step through the plain
   versions, in f32 (TF32 off) and bf16: losses, every G and D gradient,
   EMA state; then steps on a repeated batch: finite losses, a lower
   reconstruction loss after, and exactly 12 forward (6 fused layers x
   forward + recompute), 6 backward and 1 argmin launch per step; one step
   with ``FUSED_EMA_STATS`` gives the indices and EMA state of the step
   without it;
11. timings on the card: extraction + decode ms per volume; the stage-1
   train step, kernels vs plain (ms, volumes/s, peak memory); a
   torch.profiler breakdown of one kernel step; rows 3 and 4 in turns
   with their plain versions and addmm + argmin, elapsed and device time,
   beside the f32 and the TF32 tensor-core bounds; row 7's forward and backward at the
   paper shape on channels-last x, in turns with its plain version and
   cuDNN's chain (conv3d -> relu -> conv3d -> add -> relu), elapsed and
   device time, with the chain on NCDHW too, its launches by kernel
   (torch.profiler), the conversion to channels-last and cuDNN's
   neighbouring convolutions on either layout;
12. the splash local-attention kernels (forward, dq, dk/dv, fused
   backward) against their plain version on the same seeded, zero-padded
   inputs: at the paper shape (B6 x 8 heads x L 1401 x d 64, w 420) in
   bf16 and f32, blocks 256 and 128, fused and unfused backward, and at
   awkward shapes (L 130 with w 17; L 300 with w 37; L < w; w 1; w a
   multiple of the kernel's 64-row tile; L one off a tile; w 64, 65 and
   ≥ L): o, lse, dq, dk and dv, two
   backward runs bit-identical, and the tiles every kernel visited
   against the tile map;
13. the port's prior-training bench at paper form
   (``tools/bench_transformer.main`` with --splash-local --pallas-favor
   --use-rezero --spatial-emb absolute --attn-dtype bfloat16, B6, depth
   24, remat on): finite losses and exactly 24 x (2 forward + 2 backward)
   splash launches per step; one step through splash against the same
   step through the banded kernel (row 6) from the same weights (ReZero
   gains 0.1); a short run at --attn-dtype float32; then the step with
   splash against the step with row 6 (ms, tok/s), splash fwd+bwd per
   layer against its plain version, row 6 and SDPA with the banded mask
   (elapsed time; then splash, row 6 and SDPA again in device time), and
   a torch.profiler breakdown of one splash bench step;
14. the exact decode path (``Performer.decode_step``, ``make_sampler(fused=
   False)``): (a) on the paper prior in f32 with ReZero gains 0.1,
   ``decode_step`` over seeded tokens against ``Performer.forward`` at
   positions 0-63 and 400-520 (the 420-slot ring wraps), replayed from
   the sampler's CUDA graph, and eagerly over positions 0-63 (graph
   against eager, and both timed per step), then the fused
   step with int8 and with int4 weights (int8 rings) against the exact
   step: per-step max |Δlogit|, mean KL and total variation of the
   softmax; (b) the exact sampler at B16 in bf16 (0 fused launches, grid
   shape, codes in [0, 2048), s per call and tok/s beside the fused
   sampler's); (c) on a small prior, greedy grids of the exact sampler on
   the card against the CPU and against ``sample_naive``, and
   ``make_synthesizer`` with a 'prepending' prior, which "auto" routes to
   the exact path;
15. the decode-side weight-streaming kernels: ``int8_matmul`` (row 2) at
   the paper decode GEMV shapes (R 16; K×N 512×1024, 1024×512, 512×2048,
   2048×512) and at awkward ones against its plain version, two runs
   bit-identical, timed (elapsed and device time) against the plain
   version, a dequantised bf16 copy through ``torch.matmul`` and
   ``torch._weight_int8pack_mm`` (the one PyTorch call of its function,
   held against the plain version; its refusal printed if the build has
   none); then the ``main()`` of the three probe tools (``probe_int4``,
   ``probe_int4_unpack``, ``probe_pallas_overhead``; each checks every
   variant against its plain version and raises on a failure; the
   overhead probe also splits its tile program's own fixed cost from an
   empty launch of its grid, in a CUDA graph), and each probe kernel
   timed against its plain version at the probe's shape (the weight
   stream and the packed product of E and F in elapsed and device time,
   two runs bit-identical; GB/s from device time; the unpack's four
   formulations exact, A in elapsed and device time beside an empty
   launch of its grid; the tile program at G 96 with every cluster
   resident, two runs bit-identical, in elapsed and device time in turns
   with its plain version and ``torch.matmul`` of G copies of the
   operands, the one PyTorch call of its function);
16. row 9d, the kernel-body probe (``tools/probe_kernel_body.main`` with
   every row): the ablated bodies of the FAVOR+ and banded local-attention
   kernels (``ops/kernel_body.py``) at the paper shape (B6 x 8 heads x L
   1401 x d 64, w 420, m 256, chunk 128, bf16), each held against its
   plain twin at a small shape in bf16 and f32 and at the paper shape,
   the production-equal bodies (local forward ``foldscale``, local
   backward ``full``, FAVOR ``full``) against the production kernels bit
   for bit; then the full bodies timed against their plain versions and,
   for the local forward, SDPA with the banded mask;
17. ``tools/validate_fused_decode`` at its defaults with int8 and with
   int4 weights: a 6L/d256 prior (window 64, m 128) trained 400 steps
   through rows 5 and 6 on structured latents, then greedy agreement of
   the fused step with the exact path (bf16 and int8 rings), the
   teacher-forced logit perturbation, KL and total variation, with the
   fused kernel step held against its plain version at these widths;
18. (run right after phase 2, in a process of its own: a user's fresh
   process, so the engines cuDNN autotunes under the CLI's flags never
   reach the later phases, nor theirs it) the port's stage-1 CLI
   (``synthanatomy_tpu_torch.run_vqvae``) at paper width from NIfTI
   files: 6 training and 3 validation smooth int16 phantoms of
   160x224x160 written by ``save_nifti``; the loader alone (volumes/s,
   which NIfTI reader ran); training with the README's
   stage-1 flags (4 levels, 256 channels, codebook 2048 x 32, decay 0.5,
   jukebox_perceptual, adversarial), B3, 2 epochs of 2 steps, eval at
   epoch 2, traced by the runner's ``StepProfiler``: finite losses
   (D's too), argmin and residual launches, rows 3 and 7 in the trace,
   ms per step through the CLI and the device's busy share over steps 3-4
   (compared with phase 11's bare step once phase 11 has run), the device
   time by kernel; a second call with 3 epochs resumes from
   checkpoint_epoch=2 and writes checkpoint_epoch=3 and
   model_state_dict_epoch=3.pt (codebook (2048, 32)); extraction (six
   uint16 (10, 14, 10) grids below 2048, reconstructions of 160x224x160,
   D's maps; row 3 in its trace) and decoding of two grids, each in s per
   volume split into model build, checkpoint load, forward and NIfTI
   writes; then ``tools/bench`` at the paper form, whose JSON line comes
   on a line of its own; then the device augmentation at paper width:
   ``augment_batch`` on the card against the CPU (B3 x 160x224x160 f32,
   the exact gather and the 3-pass form, every transform fired, noise
   off; max abs error away from the voxels whose sample position lies
   within 1e-5 of an integer, where the floor may flip, and their count),
   the noise term's mean and std against ``noise_std``, each resampler's
   ms per batch (elapsed and device time); the loader with device
   parameters only (volumes/s); ``run_vqvae --device_augmentation=True``
   at the flags above, 2 epochs of 2 steps (the 3-pass route in every
   step, argmin and residual launches, ms per step and busy share over
   steps 3-4 beside the host-augmented step); ``tools/bench_vqvae --device_augment`` at B3
   with D and jukebox_perceptual; ``tools/bench_dataloader`` at --n=4;
19. (right after phase 18, in a process of its own, on phase 18's
   experiment directory) the port's stage-2 CLI
   (``synthanatomy_tpu_torch.run_transformer``) and one-command synthesis
   (``tools/synthesize``), each through ``cli.dispatch`` with a user's
   argv: phase 18's six extracted grids copied to 12 training and 32
   sampling files; prior training with the README's stage-2 flags at the
   paper form (vocab 2048, 24L/d512/16h, 8 local heads of window 420,
   raster, ReZero, learned spatial tables), bf16, B6, 2 epochs of 2
   steps, eval at epoch 2, traced by the runner's ``StepProfiler``:
   finite losses, exactly 24 x 7 row 5 and 24 x 3 row 6 launches in every
   step, both rows in the trace, ms per step through the CLI and the
   device's busy share over steps 3-4 (beside phase 8's bare step), peak
   memory; a second call with 3 epochs resumes from checkpoint_epoch=2
   and writes checkpoint_epoch=3 and model_state_dict_epoch=3.pt with
   ``export_performer_state_dict``'s keys; sampling of the 32 files at
   B16 with top-k 50 (32 uint16 grids below 2048, exactly 1400 row 1 step
   launches in each of the two sampler calls, s per call and tok/s beside
   phase 5's call, model build and checkpoint load); ``run_vqvae``
   decoding of 4 samples with phase 18's stage-1 checkpoint (finite
   160x224x160 volumes, s per volume); ``tools/synthesize`` of 16
   volumes at B16 from both experiments (16 finite volumes, 1400 row 1
   launches, volumes/min split into sampling, decoding and NIfTI
   writes); then the checkpoint round trip: phase 18's VQ-VAE and this
   phase's prior through ``tools/export_checkpoint`` (reference ``.pt``),
   ``tools/convert_checkpoint`` / ``convert_performer_checkpoint``
   (``.npz``) and ``tools/import_checkpoint`` (``checkpoint_epoch=0`` of
   a new experiment): every network tensor equal to the original's bit
   for bit, then ``run_vqvae`` decodes 4 samples and ``run_transformer``
   samples 16 grids (1400 row 1 launches) through the imported models;
20. (in a process of its own) ``tools/quality_loop`` at its defaults: 32
   synthetic 48^3 volumes, a 2-level/48-channel VQ-VAE trained to val
   MS-SSIM >= 0.90, a 4L/d256 prior to val CE <= 1.0, 8 samples decoded,
   all inside the reconstructions' statistics envelope and diverse (JAX's
   bars, unchanged): the epochs each bar needed, and the launches of rows
   1, 3, 5 and 6 (each > 0) and 7 (0 at these sizes, the reason printed).

The line before the last is the kernels' JSON record (time, plain time,
bound and library time of every kernel); the last line is
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
PAPER = dict(dim=512, depth=24, heads=16, local_heads=8, window=420)
SMALL = dict(dim=128, depth=2, heads=2, local_heads=1, window=12)
SMALL_GRID = (2, 3, 4)
TF_TOKENS = 521  # teacher-forced positions: the 420-slot ring wraps at 420
TF_CHECK = list(range(64)) + list(range(400, TF_TOKENS))
TF_EAGER = 64  # positions also stepped eagerly, against the graph replay
INT8_GEMV = [(16, 512, 1024), (16, 1024, 512), (16, 512, 2048), (16, 2048, 512)]
INT8_AWKWARD = [(1, 512, 1024), (5, 200, 96), (33, 512, 1000), (16, 200, 1000)]
TRAIN_BATCH = 6  # the paper batch of tools/bench_transformer.py
TRAIN_STEPS = 5
LAUNCHES_PER_STEP = 24 * 3  # row 6: forward + two backward launches per layer
VQ_BATCH = 3  # the stage-1 batch (synthanatomy_tpu/config.py batch_size)
VQ_STEPS = 4
VOLUME = (160, 224, 160)
# per stage-1 train step: 6 fused layers (3 encoder at level 0, 3 decoder
# at the last level) x (forward + remat recompute), 6 backward, 1 argmin
RES_FWD_PER_STEP, RES_BWD_PER_STEP, ARGMIN_PER_STEP = 12, 6, 1
# H100 SXM dense peaks (FLOP/s, B/s)
PEAK_BF16, PEAK_TF32, PEAK_F32, HBM = 989e12, 495e12, 67e12, 3.35e12
# the bench's paper form through splash, and the same through row 6
BENCH_SPLASH = ["--splash-local", "--pallas-favor", "--use-rezero", "--spatial-emb", "absolute",
                "--attn-dtype", "bfloat16"]
BENCH_BANDED = ["--pallas-local"] + BENCH_SPLASH[1:]
BENCH_STEPS = ["--steps", "4", "--warmup", "1"]  # + the first step: 6 steps a run
PROBE_REPS = 20  # launches per measurement of the kernel-body probe (min of 5)
SPLASH_PER_STEP = 24 * (2 + 2)  # per layer: forward + remat recompute, two backward launches
# the row 2, 5, 6, 7, 8 and 9a kernels whose bf16 instantiations must hold
# tensor-core instructions (phase 2b); row 7's tile-route kernels
# (res_tile_*) are bf16 only; row 5's scan has no product; the GEMVs of
# rows 2 and 9a (GEMV_LIBS) run every instantiation, int8 or int4 weights,
# on bf16 products
GEMV_LIBS = ("int8_matmul", "weight_stream")
# libraries whose every instantiation of the listed kernels must hold
# tensor-core instructions: the GEMVs (int8 or int4 weights, bf16
# products), row 3's argmin (f32 rows, split-TF32 products) and row 9c's
# tile program (bf16, one instantiation per k16 products a split)
ALL_INSTANTIATIONS = GEMV_LIBS + ("vq_argmin", "launch_overhead")
FAVOR_ROUTE_KERNELS = ("favor_state_kernel", "favor_fwd_kernel", "favor_dq_kernel",
                       "favor_dkv_kernel")
TENSOR_CORE_KERNELS = {
    "int8_matmul": ("matmul_kernel",),
    "weight_stream": ("stream_kernel",),
    "favor_attention": FAVOR_ROUTE_KERNELS,
    "favor_probe_idfeat": FAVOR_ROUTE_KERNELS,
    "favor_probe_nomask": FAVOR_ROUTE_KERNELS,
    "local_attention": ("local_fwd_kernel", "local_bwd_dq_kernel", "local_bwd_dkv_kernel"),
    "local_attention_splash": ("splash_fwd_kernel", "splash_dq_kernel", "splash_dkv_kernel"),
    "res_stack": ("res_fwd_kernel", "res_bwd_dx_kernel", "res_bwd_dw1_kernel",
                  "res_tile_fwd_kernel", "res_tile_da_kernel", "res_tile_dx_kernel",
                  "res_tile_dw1_kernel"),
    "vq_argmin": ("vq_argmin_kernel",),
    "launch_overhead": ("tile_steps_kernel",),
}


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _check_sass():
    """Phase 2b: every bf16 instantiation of the row 5 (chunk-parallel
    route), row 6 (tile form), row 7 and row 8 kernels, and every
    instantiation of the row 2 and 9a GEMVs (``matmul_kernel``,
    ``stream_kernel``: int8 or int4 weights, bf16 products), of row 3's
    argmin and of row 9c's tile program, runs its products on the tensor
    cores: HMMA or HGMMA in its SASS (``cuobjdump
    -sass``).  Prints each kernel's tensor-core instructions, registers,
    spills and stack from ``ptxas -v``, and the dynamic shared memory the
    launches ask for.  Row 5's one-block-per-head kernels (d above 64, m
    above 256) and its scan, row 6's band form (d > 128, the earlier FMA
    kernels), row 7's f32 instantiations and partial sums, splash's dq
    reduction and the stream's layer sum (no product) are listed without
    the requirement."""
    from synthanatomy_tpu_torch import _build
    from synthanatomy_tpu_torch.ops import favor_attention as fa
    from synthanatomy_tpu_torch.ops import local_attention_flash as lf
    from synthanatomy_tpu_torch.ops import local_attention_splash as ls
    from synthanatomy_tpu_torch.ops import probes, quant
    from synthanatomy_tpu_torch.ops import res_stack as rs
    from synthanatomy_tpu_torch.ops import vq

    for lib, kernels in TENSOR_CORE_KERNELS.items():
        regs = _build.ptxas_kernels(lib)
        held = 0
        for mangled, (label, body) in sorted(_build.sass(lib).items(), key=lambda kv: kv[1][0]):
            hmma, hgmma = body.count("HMMA"), body.count("HGMMA")
            base = label.split("<")[0].split("::")[-1]
            must = base in kernels and (lib in ALL_INSTANTIATIONS or "__nv_bfloat16" in label
                                        or base.startswith("res_tile_"))
            if must:
                _require(hmma + hgmma > 0, f"{lib}: {label} has no tensor-core instruction")
                held += 1
            r = regs.get(mangled, {})
            print(f"[sass] {label}: HMMA {hmma}, HGMMA {hgmma}{' (required)' if must else ''}; "
                  f"{r.get('registers')} registers, spills {r.get('spill_stores')}/"
                  f"{r.get('spill_loads')} bytes, stack {r.get('stack')} bytes")
        _require(held > 0, f"{lib}: no bf16 kernel found in the SASS")
        if lib == "vq_argmin":
            spills = [(lbl, r) for m, (lbl, _) in _build.sass(lib).items()
                      for r in [regs.get(m, {})] if lbl.startswith("vq_argmin_kernel")]
            _require(all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                         for _, r in spills), f"vq_argmin: ptxas spills {spills}")
        print(f"[sass] {lib}: tensor-core instructions in all {held} "
              f"{'' if lib in ALL_INSTANTIATIONS else 'bf16 '}instantiations")
    for r, k, n in INT8_GEMV:
        print(f"[smem] row 2 int8_matmul R{r} K{k} N{n}: {quant._lib().gemv_matmul_blocks(r, k, n, 0)} "
              f"one-warp blocks, {quant._lib().gemv_matmul_smem(r, k, n, 0)} B of dynamic shared "
              f"memory each; packed int4 {quant._lib().gemv_matmul_smem(r, k, n, 1)} B")
    ws = probes._lib("weight_stream")
    for b in (16, 64):
        print(f"[smem] row 9a weight_stream B{b} K512 N2048 L96: {ws.gemv_stream_blocks(96, b, 512)} "
              f"blocks, int8 {ws.gemv_stream_smem(b, 512, 2048, 0)} B, packed int4 "
              f"{ws.gemv_stream_smem(b, 512, 2048, 1)} B of dynamic shared memory each")
    for dtype, code in (("bfloat16", 1), ("float32", 0)):
        print(f"[smem] {dtype} at d 64, w 420: row 6's largest kernel "
              f"{lf._lib().local_smem_bytes(64, 420, code)} B of dynamic shared memory, splash's "
              f"{ls._lib().splash_smem_bytes(code)} B")
    for dtype, code in (("bfloat16", 1), ("float32", 0)):
        launches = {name: fa._lib().favor_launch_smem(kind, 256, code)
                    for name, kind in (("state", 0), ("forward", 2), ("dq", 3), ("dk/dv", 4))}
        print(f"[smem] row 5 {dtype} at m 256: " + ", ".join(
            f"{name} {b} B ({233472 // (b + 1024)} blocks an SM)" for name, b in launches.items()))
    vql = vq._lib()
    for n, k, d in ((VQ_BATCH * SEQ, 2048, 32), (1000, 300, 64), (300, 100, 200)):
        print(f"[smem] rows 3-4 N {n} K {k} D {d}: {vql.vq_blocks(n, k)} blocks of 256 threads in "
              f"clusters of {vql.vq_cluster(n, k)}, {vql.vq_smem_bytes(d)} B of dynamic shared "
              f"memory each; {vql.vq_active_clusters(n, k, d)} clusters fit the card at once")
    for m, k, n in ((256, 512, 512), (128, 1024, 256), (64, 48, 128)):
        pl = probes.tile_steps_plan(m, k, n)
        print(f"[smem] row 9c M {m} K {k} N {n}: {pl['blocks']} blocks of {pl['threads']} threads "
              f"in clusters of {pl['cluster']} ({pl['products']} k16 products a split each "
              f"step), {pl['smem']} B of dynamic shared memory each; {pl['active_clusters']} "
              f"clusters fit the card at once")
    print(f"[smem] row 7 at C = R = 128: bf16 (tile route: {bool(rs._lib().res_route(128, 128, 1))}) "
          f"{rs._lib().res_smem_bytes(128, 128, 1)} B, f32 (GEMM route) "
          f"{rs._lib().res_smem_bytes(128, 128, 0)} B of dynamic shared memory, largest launch")


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
               grid=GRID, dtype=None, gains=(0.7, 0.5)):
    import numpy as np
    import torch

    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer

    ordering = Ordering("raster_scan", 3, grid)
    model = Performer(
        num_tokens=2049, max_seq_len=int(np.prod(grid)) + 1, dim=dim, depth=depth,
        heads=heads, dim_head=64, local_attn_heads=local_heads,
        local_window_size=window, use_rezero=rezero, spatial_position_emb="absolute",
        spatial_shape=grid, ordering=ordering, dtype=dtype or torch.bfloat16,
        generator=torch.Generator().manual_seed(seed), device="cpu",
    )
    with torch.no_grad():
        for blk in model.blocks:
            if rezero:  # ReZero starts at identity: non-trivial gains
                blk.g_attn.fill_(gains[0])
                blk.g_ff.fill_(gains[1])
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


def _favor_tie_inputs(shape, m, dev):
    """Row 5 inputs whose every product is exact (d 16, so dn = 1/2;
    small integers times powers of two), with projection rows 0 and 1
    equal and the longest and every query along them: each row's max over
    features is an exact tie, which the kernel and the plain version both
    see and split its cotangent over."""
    import numpy as np
    import torch

    b, h, n, d = shape
    rng = np.random.default_rng(n + m)
    p = rng.integers(-2, 3, size=(m, d)).astype(np.float32) * 0.25
    p[0] = p[1] = 1.0
    q = (0.25 * (4.0 + rng.integers(0, 3, size=(b, h, n, 1)))
         + 0.125 * rng.integers(-1, 2, size=(b, h, n, d)))
    k, v, g = (s * rng.integers(-3, 4, size=(b, h, n, d)) for s in (0.125, 0.25, 0.25))
    t = [torch.tensor(x, dtype=torch.float32, device=dev).to(torch.bfloat16) for x in (q, k, v)]
    proj = torch.tensor(p, device=dev)
    u = (t[0].float() * 0.5).to(torch.bfloat16).float() @ proj.to(torch.bfloat16).float().T
    _require(bool((u[..., 0] == u[..., 1]).all() and (u.argmax(-1) <= 1).all()),
             "the tie inputs hold no tie")
    return (*t, torch.tensor(g, dtype=torch.float32, device=dev), proj)


def _favor_flops(b, h, n, d, m, chunk):
    """(forward, backward) FLOP of row 5's chunked algorithm at this
    shape: the products it needs (2 FLOP a multiply-add), each chunk of c
    rows (the last one ragged) with p = c(c+1)/2 causal pairs, the
    features recomputed in the backward as the TPU kernel does.
    Forward: U = rnd(x·dn)·rnd(P)ᵀ for q and k (2 · 2cdm), qc·kcᵀ over
    the pairs (2pm), rnd(scores)·v (2pd), qc·rnd(S) (2cmd), qc·rnd(z)
    (2cm), the chunk's own kcᵀ·v (2cmd).  Backward: U for q and k (2 ·
    2cdm), the scores again for dv (2pm), ds = rnd(dnum)·vᵀ (2pd), dq_p =
    rnd(ds)·kc (2pm) + rnd(dnum)·rnd(S)ᵀ (2cdm), dk_p = rnd(ds)ᵀ·qc (2pm) +
    v·rnd(dS)ᵀ (2cdm), dv = rnd(scores)ᵀ·rnd(dnum) (2pd) + kc·rnd(dS)
    (2cdm), dq = rnd(du)·rnd(P) and dk = rnd(dE)·rnd(P) (2 · 2cmd), the
    chunk's own kcᵀ·v and qcᵀ·rnd(dnum) (2 · 2cmd)."""
    fwd = bwd = 0
    for c0 in range(0, n, chunk):
        c = min(chunk, n - c0)
        p = c * (c + 1) // 2
        fwd += 2 * (4 * c * d * m + p * (m + d) + c * m)
        bwd += 2 * (9 * c * d * m + p * (3 * m + 2 * d))
    return b * h * fwd, b * h * bwd


def _check_training_kernels(dev):
    """Phase 6; returns {kernel: max abs err at the paper shape}."""
    import torch
    from synthanatomy_tpu_torch.ops import favor_attention as fa
    from synthanatomy_tpu_torch.ops import local_attention_flash as lf
    from synthanatomy_tpu_torch.ops.favor import gaussian_orthogonal_random_matrix

    bf16, f32 = torch.bfloat16, torch.float32
    favor_shapes = [("paper", (6, 8, 1400, 64), 256, 128, bf16),
                    ("L % chunk != 0", (1, 2, 37, 16), 32, 16, f32),
                    ("L % chunk != 0, bf16", (2, 3, 300, 64), 256, 128, bf16),
                    ("the bench's L 1401", (6, 8, 1401, 64), 256, 128, bf16),
                    ("the validation prior's m 128", (8, 2, 1400, 64), 128, 128, bf16),
                    ("L < chunk", (1, 2, 100, 64), 256, 128, bf16),
                    ("m 128, chunk 64, f32", (1, 2, 100, 64), 128, 64, f32),
                    ("row-max ties, bf16", (2, 2, 300, 16), 256, 128, "ties"),
                    ("d 128 (the earlier kernels)", (1, 2, 70, 128), 64, 32, f32)]
    local_shapes = [("paper", (6, 8, 1400, 64), 420, bf16),
                    ("L < w", (1, 2, 20, 16), 40, bf16),
                    ("w % block != 0", (2, 2, 100, 64), 45, bf16),
                    ("L % block != 0, f32", (1, 2, 37, 16), 12, f32),
                    # the tile walk's edges: L one off a 64-row tile, w 1, 64,
                    # 65 and ≥ L, d 16, 32, 48, 100 and 128 (zero-padded in the
                    # staged tiles), and d 200 (the band form)
                    ("L 2 tiles - 1, w 64, d 16", (1, 2, 127, 16), 64, bf16),
                    ("L 2 tiles + 1, w 65, d 32", (1, 2, 129, 32), 65, bf16),
                    ("w 1, d 128", (2, 2, 191, 128), 1, bf16),
                    ("w >= L, d 128, f32", (1, 2, 193, 128), 300, f32),
                    ("w 64, f32", (1, 3, 65, 64), 64, f32),
                    ("w 1000 >= L", (1, 2, 129, 32), 1000, bf16),
                    ("L 1 tile - 1, w 65, f32", (1, 2, 63, 16), 65, f32),
                    ("d 100", (1, 2, 255, 100), 65, bf16),
                    ("d 48, f32", (1, 2, 200, 48), 77, f32),
                    ("d 200 (band form)", (1, 1, 100, 200), 37, bf16)]
    errs = {"favor": 0.0, "local": 0.0}
    for label, shape, m, chunk, dtype in favor_shapes:
        if dtype == "ties":
            q, k, v, g, proj = _favor_tie_inputs(shape, m, dev)
            dtype = bf16
        else:
            q, k, v, g = _attention_inputs(shape, dtype, shape[2], dev)
            proj = gaussian_orthogonal_random_matrix(
                m, shape[-1], generator=torch.Generator().manual_seed(1)).to(dev)
        before = fa.favor_attention_fused.launches
        got = _fwd_bwd(lambda *x: fa.favor_attention_fused(*x, proj, chunk), q, k, v, g)
        torch.cuda.synchronize()
        _require(fa.favor_attention_fused.launches - before == fa.launches_per_call(q, proj, chunk),
                 f"favor {label}: {fa.favor_attention_fused.launches - before} launches")
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
              f"chunk {chunk}, {str(dtype)[6:]}, "
              f"{'chunk-parallel route' if fa.launches_per_call(q, proj, chunk) == 7 else 'one block per head'}, "
              f"{fa.launches_per_call(q, proj, chunk)} launches): out/dq/dk/dv max abs err "
              f"{err:.3e} (tol 2e-2 of max |plain|, 1e-2 in norm); two runs bit-identical")
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
        generator=torch.Generator().manual_seed(20), device="cpu",
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
    """ms per call: CUDA events around back-to-back calls (the host's gaps
    included), ``tools/_probe_util.event_ms``."""
    from synthanatomy_tpu_torch.tools._probe_util import event_ms

    return event_ms(fn, reps)


def _device_ms(fn, reps):
    """Device ms per call: the calls queued behind a GPU spin as long as
    1.5x their host time (``tools/_probe_util.device_ms``).  Used beside
    ``_time_ms`` for rows 1, 6 and 8."""
    from synthanatomy_tpu_torch.tools._probe_util import device_ms

    return device_ms(fn, reps)


def _turns(kernel, plain, library, reps):
    """plain, kernel, library, library, kernel, plain (the card may drift
    within a call), read by ``_time_ms`` (the host's gaps included, as
    every other row) and then by ``_device_ms``: {"ms", "plain_ms",
    "library_ms", "each"} and the same keys prefixed "dev_", the means of
    each pair and the six single times."""
    out = {}
    for pre, timer in (("", _time_ms), ("dev_", _device_ms)):
        p1, k1, y1 = timer(plain, max(1, reps // 3)), timer(kernel, reps), timer(library, reps)
        y2, k2, p2 = timer(library, reps), timer(kernel, reps), timer(plain, max(1, reps // 3))
        out.update({pre + "ms": (k1 + k2) / 2, pre + "plain_ms": (p1 + p2) / 2,
                    pre + "library_ms": (y1 + y2) / 2, pre + "each": (p1, k1, y1, y2, k2, p2)})
    return out


def _time_favor(smi, q, k, v, g, proj, fwd_bwd_pair):
    """Phase 8's row 5 at the paper shape (chunk 128): forward, backward
    and both, each in turns with its plain version (plain, kernel, kernel,
    plain), read as elapsed time (``_time_ms``) and as device time
    (``_device_ms``), beside its bound (``_favor_flops``; bytes: q, k, v
    and g read once, out, den, dq, dk and dv written) and the useful
    TFLOP/s.  No single PyTorch call computes it."""
    from synthanatomy_tpu_torch.ops import favor_attention as fa

    chunk = 128
    gb = g.to(q.dtype)
    out, den = fa._kernel_fwd(q, k, v, proj, chunk)
    fwd_flops, bwd_flops = _favor_flops(*q.shape, proj.shape[0], chunk)
    io, o32 = _nbytes(q), _nbytes(q) * 2  # a (B, H, L, d) bf16 tensor, and one in f32
    fb_kernel, fb_plain = fwd_bwd_pair
    cases = {
        "fwd": (lambda: fa._kernel_fwd(q, k, v, proj, chunk),
                lambda: fa._Plain.fwd(q, k, v, proj, chunk), fwd_flops,
                3 * io + _nbytes(proj) + o32 + _nbytes(den)),
        "bwd": (lambda: fa._kernel_bwd(q, k, v, proj, gb, out, den, chunk),
                lambda: fa._Plain.bwd(q, k, v, proj, gb, out, den, chunk), bwd_flops,
                4 * io + _nbytes(proj) + o32 + _nbytes(den) + 3 * o32),
        "fwd+bwd": (fb_kernel, fb_plain, fwd_flops + bwd_flops,
                    4 * io + _nbytes(proj) + 4 * o32),
    }
    res = {}
    for name, (kern, plain, flops, nbytes) in cases.items():
        r = res[name] = {"flops": flops, "bound": _bound(flops, nbytes, PEAK_BF16)}
        for pre, timer in (("", _time_ms), ("dev_", _device_ms)):
            p1, k1, k2, p2 = timer(plain, 2), timer(kern, 10), timer(kern, 10), timer(plain, 2)
            r.update({pre + "ms": (k1 + k2) / 2, pre + "plain_ms": (p1 + p2) / 2,
                      pre + "each": (p1, k1, k2, p2)})
        for pre, how in (("", "elapsed"), ("dev_", "device time")):
            p1, k1, k2, p2 = r[pre + "each"]
            print(f"[time] row 5 {name} ({how}), B{q.shape[0]} x {q.shape[1]} heads x L{q.shape[2]}"
                  f" x d{q.shape[3]}, m {proj.shape[0]}, chunk {chunk}, bf16: kernel "
                  f"{r[pre + 'ms']:.4f} ms ({k1:.4f}, {k2:.4f}), "
                  f"{flops / r[pre + 'ms'] / 1e9:.1f} useful TFLOP/s ({flops / 1e9:.2f} GFLOP); "
                  f"plain {r[pre + 'plain_ms']:.3f} ms ({p1:.3f}, {p2:.3f}); bound "
                  f"{r['bound'][0]:.4f} ms ({r['bound'][1]})  [{smi}]")
    return res


def _time_local(dev, smi, q, k, v, g, fwd_bwd_pair):
    """Phase 8's row 6 at the paper shape: forward, backward and both, each
    in turns with its plain version and SDPA with the banded mask, read as
    elapsed time (``_time_ms``) and as device time (``_device_ms``), beside
    its bound and the useful TFLOP/s (the band's products as the bounds
    count them: 4, 10 and 14 FLOP per visible pair and feature).  SDPA's
    backward alone is its forward+backward less its forward."""
    import torch
    import torch.nn.functional as F
    from synthanatomy_tpu_torch.ops import local_attention_flash as lf

    w, d = 420, q.shape[-1]
    gb = g.to(q.dtype)
    i_, j_ = torch.arange(SEQ, device=dev)[:, None], torch.arange(SEQ, device=dev)[None, :]
    band = (j_ <= i_) & (j_ > i_ - w)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band)

    def sdpa():
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=band)
        return torch.autograd.grad(o, leaves, gb)

    fb_kernel, fb_plain = fwd_bwd_pair
    bh, pairs = q.shape[0] * q.shape[1], sum(min(i + 1, w) for i in range(SEQ))
    io1 = _nbytes(q)
    # 30 calls a reading: the elapsed readings are host-paced, and a host
    # stall in 10 calls moved one of them by 2x
    res = {
        "fwd": _turns(lambda: lf._kernel_fwd(q, k, v, w), lambda: lf.local_fwd_plain(q, k, v, w),
                      sdpa_fwd, 30),
        "bwd": _turns(lambda: lf._kernel_bwd(q, k, v, gb, w),
                      lambda: lf.local_bwd_plain(q, k, v, gb, w), sdpa, 30),
        "fwd+bwd": _turns(fb_kernel, fb_plain, sdpa, 30),
    }
    for pre in ("", "dev_"):
        res["bwd"][pre + "library_ms"] -= res["fwd"][pre + "library_ms"]
    for name, flop, nbytes in (("fwd", 4, 4 * io1), ("bwd", 10, 7 * io1), ("fwd+bwd", 14, 8 * io1)):
        r = res[name]
        r["flops"] = flop * bh * pairs * d
        r["bound"] = _bound(r["flops"], nbytes, PEAK_BF16)
        for pre, how in (("", "elapsed"), ("dev_", "device time")):
            p1, k1, y1, y2, k2, p2 = r[pre + "each"]
            lib_note = "SDPA fwd+bwd less SDPA fwd" if name == "bwd" else \
                f"SDPA banded mask ({y1:.4f}, {y2:.4f})"
            print(f"[time] row 6 {name} ({how}), B{q.shape[0]} x {q.shape[1]} heads x L{SEQ} x "
                  f"d{d}, w {w}, bf16: kernel {r[pre + 'ms']:.4f} ms ({k1:.4f}, {k2:.4f}), "
                  f"{r['flops'] / r[pre + 'ms'] / 1e9:.1f} useful TFLOP/s "
                  f"({r['flops'] / 1e9:.2f} GFLOP); plain {r[pre + 'plain_ms']:.3f} ms "
                  f"({p1:.3f}, {p2:.3f}); library {r[pre + 'library_ms']:.4f} ms ({lib_note}); "
                  f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  [{smi}]")
    return res


def _bound(flops, nbytes, peak):
    """(bound ms, what bounds it): the larger of operations over the
    peak rate and bytes (each input read once, each output written once)
    over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _decode_step_bytes(params, st, h, cfg, t):
    """Bytes one fused decode step at position t must move: the weights
    and parameters the configuration reads (no LayerNorm parameters under
    ReZero), S and z read and written, the ring slots of the window (K, V
    and their scales: positions max(0, t − W + 1, t − R) .. t − 1 of R),
    h read and written, and the token's k and v written."""
    from synthanatomy_tpu_torch.ops import fused_decode as fd

    used = [k for k in fd._PARAM_ORDER if not (cfg.use_rezero and k.startswith("ln"))]
    slots = t - max(0, t - cfg.local_window + 1, t - cfg.ring_size)
    ring = _nbytes(*(st.get(k) for k in ("ck", "cv", "ck_s", "cv_s"))) * slots // cfg.ring_size
    kv_out = 2 * cfg.depth * cfg.bl * 4
    return (_nbytes(*(params[k] for k in used)) + 2 * _nbytes(st["S"], st["z"]) + ring
            + 2 * _nbytes(h) + kv_out)


def _argmin_mismatch(x, w, got, want):
    """Rows where two argmins disagree must be near-ties: their distances
    (f64) within 1e-5 of the distances' scale.  Returns (rows that
    differ, largest distance gap)."""
    import torch

    rows = torch.nonzero(got != want).flatten()
    if rows.numel() == 0:
        return 0, 0.0
    xd, wd = x[rows].double(), w.double()
    dist = (wd * wd).sum(1)[None, :] - 2.0 * xd @ wd.t()
    dk = dist.gather(1, got[rows].long()[:, None])
    dp = dist.gather(1, want[rows].long()[:, None])
    gap = float((dk - dp).abs().max())
    scale = float(dist.abs().max())
    _require(gap <= 1e-5 * scale, f"argmin differs on {rows.numel()} rows, gap {gap} > "
                                  f"1e-5 x {scale}")
    return int(rows.numel()), gap


def _check_vq_kernels(dev):
    """Phase 9, rows 3 and 4; returns max errors at the paper shape."""
    import torch
    from synthanatomy_tpu_torch.ops import vq

    errs = {}
    for label, (n, k, d) in (("paper", (VQ_BATCH * SEQ, 2048, 32)), ("ragged", (37, 130, 5)),
                             ("K % tile, D 64", (1000, 300, 64)), ("N, K odd", (4099, 2047, 32))):
        gen = torch.Generator(device=dev).manual_seed(n + k)
        x = torch.randn(n, d, generator=gen, device=dev)
        w = torch.randn(k, d, generator=gen, device=dev)
        idx = vq.nearest_codeword(x, w)
        ref = vq.nearest_codeword_plain(x, w)
        sidx, counts, dw = vq.nearest_codeword_stats(x, w)
        sidx2, counts2, dw2 = vq.nearest_codeword_stats(x, w)
        torch.cuda.synchronize()
        n_diff, gap = _argmin_mismatch(x, w, idx, ref)
        _require(torch.equal(sidx, idx), f"{label}: stats kernel indices differ from the argmin")
        _require(torch.equal(counts, torch.bincount(idx.long(), minlength=k).float()),
                 f"{label}: counts are not exact")
        onehot = torch.nn.functional.one_hot(idx.long(), k).float()
        sx_err = _compare_grad(f"vq stats {label} sum x", dw, onehot.t() @ x)
        _require(torch.equal(dw, dw2) and torch.equal(counts, counts2) and torch.equal(
            sidx, sidx2), f"{label}: two stats runs differ")
        if label == "paper":
            errs = {"argmin": gap, "stats": sx_err}
        print(f"[check] nearest_codeword == plain ({label}: N {n}, K {k}, D {d}, f32): "
              f"{n_diff} rows differ (allowed only within 1e-5 of the distance scale; gap "
              f"{gap:.3e}); stats: counts exact, sum x max abs err {sx_err:.3e} (tol 2e-2 of "
              f"max |plain|, 1e-2 in norm), two runs bit-identical")
        # the device launches of one call of each: the argmin one (cluster)
        # launch, the statistics at most 3 (here 2), as torch.profiler sees them
        for name, fn, most in (("nearest_codeword", lambda: vq.nearest_codeword(x, w), 1),
                               ("nearest_codeword_stats",
                                lambda: vq.nearest_codeword_stats(x, w), 3)):
            got = _kernel_launches(fn, "vq_")
            _require(1 <= sum(got.values()) <= most and "vq_argmin_kernel" in got,
                     f"{label}: {name} launched {got}, want the argmin and at most {most} "
                     f"vq_ kernels")
            print(f"[check] {name} ({label}) one call: {sum(got.values())} launches {got}")
    return errs


def _kernel_launches(fn, prefix, reps=20, sessions=3):
    """{kernel name: launches a call} of the kernels named ``prefix``... on
    the card, by torch.profiler over ``reps`` calls of ``fn`` queued behind
    a GPU spin of ~0.5 ms, rounded up (a short session may miss the first
    launches it sees; a session that saw none of them is run again, up to
    ``sessions`` times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1_000_000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                name = evt.key.replace("(anonymous namespace)::", "").replace("void ", "", 1)
                name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
                if name.startswith(prefix):
                    out[name] = out.get(name, 0) + evt.count
        if out:
            break
    return {name: -(-count // reps) for name, count in out.items()}


def _res_inputs(shape, r, dtype, seed, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    b, c = shape[:2]
    x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
    w1 = torch.randn(r, c, 3, 3, 3, generator=gen, device=dev) * (27 * c) ** -0.5
    b1 = torch.randn(r, generator=gen, device=dev) * 0.1
    w2 = torch.randn(c, r, 1, 1, 1, generator=gen, device=dev) * r ** -0.5
    b2 = torch.randn(c, generator=gen, device=dev) * 0.1
    gy = torch.randn(*shape, generator=gen, device=dev).to(dtype)
    return x, w1, b1, w2, b2, gy


def _check_res_kernels(dev):
    """Phase 9, row 7: the forward on the same inputs, then the backward
    on the same saved x, h, y and gy (the plain forward's), with x in
    NCDHW and in channels-last memory; returns max errors at the paper
    shape (at B1 and at the main path's B3, over both formats)."""
    import torch
    from synthanatomy_tpu_torch.ops import res_stack as rs

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [("paper", (1, 128, 80, 112, 80), 128, bf16),
              ("paper, B3 as stage 1 calls it", (3, 128, 80, 112, 80), 128, bf16),
              ("tiny, C != R", (1, 3, 5, 6, 7), 4, f32),
              ("D/H/W % tile, C != R", (2, 8, 9, 10, 11), 12, bf16),
              ("W 70, C 24, R 40", (1, 24, 7, 9, 70), 40, bf16),
              ("f32, C 16, R 32", (1, 16, 6, 7, 33), 32, f32),
              ("C 64, R 128", (1, 64, 5, 6, 11), 128, bf16),
              ("C 136, R 64", (1, 136, 4, 5, 6), 64, bf16),
              ("B2, C 128 > R 64", (2, 128, 9, 10, 11), 64, bf16),
              ("B3, dW1 chunks of 2 tiles across volumes", (3, 128, 9, 10, 17), 128, bf16)]
    formats = (("NCDHW", torch.contiguous_format), ("NDHWC", torch.channels_last_3d))
    errs = {"fwd": 0.0, "bwd": 0.0}
    for label, shape, r, dtype in shapes:
        x0, w1, b1, w2, b2, gy0 = _res_inputs(shape, r, dtype, sum(shape) + r, dev)
        w1c, b1c, w2c, b2c = (t.to(dtype) for t in (w1, b1, w2, b2))
        route = "tile" if rs._tile_route(shape[1], r, dtype) else "GEMM"
        for fname, fmt in formats:
            x, gy = x0.contiguous(memory_format=fmt), gy0.contiguous(memory_format=fmt)
            _, yk, hk = rs._kernel_fwd(x, w1c, b1c, w2c, b2c, True)
            yp, hp = rs.residual_layer_plain(x, w1c, b1c, w2c, b2c)
            torch.cuda.synchronize()
            fwd_err = max(_compare_grad(f"res {label} {fname} y", yk, yp),
                          _compare_grad(f"res {label} {fname} h", hk, hp))
            got = rs._kernel_bwd(x, hp, yp, gy, w1c, w2c)
            want = rs.residual_layer_bwd_plain(x, hp, yp, gy, w1c, w2c)
            again = rs._kernel_bwd(x, hp, yp, gy, w1c, w2c)
            torch.cuda.synchronize()
            bwd_err = max(_compare_grad(f"res {label} {fname} {n}", a, b)
                          for n, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want))
            _require(all(torch.equal(a, b) for a, b in zip(got, again)),
                     f"res {label} {fname}: two backward runs differ")
            if label.startswith("paper"):
                errs = {"fwd": max(errs["fwd"], fwd_err), "bwd": max(errs["bwd"], bwd_err)}
            print(f"[check] fused_residual_layer == plain ({label}: {shape}, R {r}, "
                  f"{str(dtype)[6:]}, x {fname}, {route} route): y/h max abs err {fwd_err:.3e}; "
                  f"on the same saved x, h, y, gy: dx/dW1/db1/dW2/db2 max abs err "
                  f"{bwd_err:.3e} (tol 2e-2 of max |plain|, 1e-2 in norm); two backward runs "
                  f"bit-identical")
    return errs


@contextlib.contextmanager
def _plain_stage1():
    """Route stage 1 through the kernels' plain versions (on the card too)."""
    from synthanatomy_tpu_torch.models import vqvae as vqm
    from synthanatomy_tpu_torch.ops import res_stack as rs
    from synthanatomy_tpu_torch.ops import vq

    with mock.patch.object(vqm, "fused_residual_layer", rs.fused_residual_layer_plain), \
            mock.patch.object(vq, "nearest_codeword", vq.nearest_codeword_plain), \
            mock.patch.object(vq, "nearest_codeword_stats", vq.nearest_codeword_stats_plain):
        yield


def _paper_vqvae(dev, dtype, **kw):
    import torch

    from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE

    return BaselineVQVAE(
        n_levels=4, downsample_parameters=((4, 2, 1, 1),) * 4,
        upsample_parameters=((4, 2, 1, 0, 1),) * 4, n_embed=2048, embed_dim=32,
        n_channels=256, n_res_channels=256, n_res_layers=3, dtype=dtype,
        generator=torch.Generator().manual_seed(30), device=dev, **kw)


def _stage1(dev, dtype):
    """The paper stage-1 trainer: VQ-VAE (remat, fused auto), D, LPIPS,
    the CLI's loss and adversarial defaults."""
    import torch

    from synthanatomy_tpu_torch.losses.lpips import init_lpips_params
    from synthanatomy_tpu_torch.models.discriminator import BaselineDiscriminator
    from synthanatomy_tpu_torch.train.vqvae_steps import make_vqvae_train_step

    model = _paper_vqvae(dev, dtype, use_remat=True)
    d_model = BaselineDiscriminator(dtype=dtype, generator=torch.Generator().manual_seed(31),
                                    device=dev)
    lpips = init_lpips_params("alex", generator=torch.Generator().manual_seed(32), device=dev)
    step = make_vqvae_train_step(model, loss_name="jukebox_perceptual", d_model=d_model,
                                 generator_criterion="least_square",
                                 discriminator_criterion="least_square",
                                 adversarial_weight=0.005)
    return model, d_model, lpips, step


VQ_SCHED = {"lr": 3e-4, "d_lr": 5e-4, "decay": 0.5, "commitment_cost": 0.25,
            "gdl_factor": 0.0, "epoch": 0}


def _snapshot(*modules):
    return [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in modules]


def _one_step(model, d_model, lpips, step, batch, snap):
    """One step from the snapshot; returns metrics, G and D gradients, the
    EMA state and the step's code indices, and restores the snapshot."""
    from synthanatomy_tpu_torch.ops import vq
    from synthanatomy_tpu_torch.train.vqvae_steps import create_vqvae_train_state

    seen = []
    quantize = vq.quantize_ema

    def keep_indices(*a, **k):
        out = quantize(*a, **k)
        seen.append(out[2].flatten().clone())
        return out

    state = create_vqvae_train_state(model, 0, d_model=d_model, device=batch.device)
    with mock.patch.object(vq, "quantize_ema", keep_indices):
        _, metrics = step(state, batch, VQ_SCHED, lpips)
    out = ({k: float(v) for k, v in metrics.items()},
           {n: p.grad.detach().float().clone() for n, p in model.named_parameters()},
           {n: p.grad.detach().float().clone() for n, p in d_model.named_parameters()},
           {k: v.detach().clone() for k, v in model.vq.state_dict().items()}, seen[0])
    model.load_state_dict(snap[0])
    d_model.load_state_dict(snap[1])
    return out


def _ema_rel(vk, vp, ik, ip):
    """EMA state error over the codewords that no flipped row touched
    (a latent whose nearest code differs between two runs moves both
    codes' averages by design).  Returns (rows flipped, error)."""
    import torch

    flips = ik != ip
    touched = torch.zeros(vk["codebook"].shape[0], dtype=torch.bool, device=ik.device)
    touched[ik[flips].long()] = True
    touched[ip[flips].long()] = True
    keep = ~touched
    return int(flips.sum()), _rel({k: v[keep] for k, v in vk.items()},
                                  {k: v[keep] for k, v in vp.items()})


def _rel(a, b, names=None):
    import torch

    names = list(a) if names is None else names
    num = sum(float(torch.linalg.norm(a[n] - b[n])) ** 2 for n in names)
    den = sum(float(torch.linalg.norm(b[n])) ** 2 for n in names)
    return (num / max(den, 1e-60)) ** 0.5


def _worst(a, b):
    name = max(a, key=lambda n: _rel(a, b, [n]))
    return name, _rel(a, b, [name])


def _seed_codebook(model, vols, seed):
    """Codewords drawn from the model's own latents (plus 1% noise), so
    that at random weights many codes are in use and the argmin, the
    statistics and the EMA update see real work."""
    import torch

    with torch.no_grad():
        z = model.encode(vols)[0].float().permute(0, 2, 3, 4, 1).reshape(-1, model.embed_dim)
        gen = torch.Generator(device=z.device).manual_seed(seed)
        pick = torch.randint(0, z.shape[0], (model.n_embed,), generator=gen, device=z.device)
        noise = torch.randn(model.n_embed, model.embed_dim, generator=gen, device=z.device)
        cb = z[pick] + 0.01 * z.std() * noise
        model.vq.codebook.copy_(cb)
        model.vq.embed_avg.copy_(cb)
    return z


def _stage1_volumes(dev, seed):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(VQ_BATCH, 1, *VOLUME, generator=gen, device=dev)


def _check_stage1(dev, smi):
    """Phases 10 and 11.  Returns the records the kernels' JSON line needs."""
    import numpy as np
    import torch

    from synthanatomy_tpu_torch.ops import res_stack as rs
    from synthanatomy_tpu_torch.ops import vq
    from synthanatomy_tpu_torch.train.vqvae_steps import (
        create_vqvae_train_state,
        make_vqvae_eval_step,
    )

    rec = {}
    # 10a. extraction -> decode (the extract path builds the model with the
    # fused residual off, as JAX's runner does)
    extract = _paper_vqvae(dev, torch.bfloat16, use_fused_residual=False)
    vols = _stage1_volumes(dev, 40)
    z = _seed_codebook(extract, vols, 42)
    with torch.no_grad():
        vq.nearest_codeword.launches = 0
        idx = extract.index_quantize(vols)[0]
        torch.cuda.synchronize()
        n_argmin = vq.nearest_codeword.launches
        rec_vols = extract.decode_samples([idx])
        with _plain_stage1():
            ref = extract.index_quantize(vols)[0]
        torch.cuda.synchronize()
    _require(n_argmin == 1, f"extraction launched the argmin {n_argmin} times, want 1")
    n_diff, _ = _argmin_mismatch(z, extract.vq.codebook, idx.flatten(), ref.flatten())
    _require(tuple(idx.shape) == (VQ_BATCH,) + GRID and int(idx.min()) >= 0
             and int(idx.max()) < 2048, f"codes {tuple(idx.shape)} in [{int(idx.min())}, "
                                        f"{int(idx.max())}]")
    _require(tuple(rec_vols.shape) == (VQ_BATCH, 1) + VOLUME
             and bool(torch.isfinite(rec_vols).all()), "decoded volumes")
    print(f"[stage1] index_quantize B{VQ_BATCH} {VOLUME} -> codes {tuple(idx.shape)} in "
          f"[0, 2048) ({int(torch.unique(idx).numel())} distinct; {n_diff} differ from the "
          f"plain argmin, near-ties only), 1 argmin launch; "
          f"decode_samples -> {tuple(rec_vols.shape)} {rec_vols.dtype}, finite")

    def extract_ms():
        with torch.no_grad():
            extract.decode_samples(extract.index_quantize(vols))

    rec["extract_ms"] = _time_ms(extract_ms, 2) / VQ_BATCH
    print(f"[time] extraction + decode, bf16, B{VQ_BATCH}: {rec['extract_ms']:.2f} ms per "
          f"volume  [{smi}]")
    del extract, rec_vols
    torch.cuda.empty_cache()

    # 10b. one step through the kernels against the plain versions.  The
    # two encoders sum in other orders, so a latent near the midpoint of
    # two codewords may pick the other one; with the codebook seeded from
    # the latents themselves such pairs are common.  At most 1% of the
    # rows may flip at f32 and 10% at bf16 (where the fused encoder layers
    # round each latent to 8 bits), and the EMA state is compared on the
    # codewords no flip touched.  G gradients: tight at f32 (summation
    # order only).  D sees the decoded voxels of a flipped latent
    # directly, hence its wider bound.
    for dtype, loss_tol, g_tol, d_tol, flip_tol in (
            (torch.float32, 1e-4, 1e-4, 1e-2, 0.01), (torch.bfloat16, 2e-2, 5e-2, 1e-1, 0.1)):
        model, d_model, lpips, step = _stage1(dev, dtype)
        batch = _stage1_volumes(dev, 41)
        _seed_codebook(model, batch, 43)
        snap = _snapshot(model, d_model)
        mk, gk, dk, vk, ik = _one_step(model, d_model, lpips, step, batch, snap)
        with _plain_stage1():
            mp, gp, dp, vp, ip = _one_step(model, d_model, lpips, step, batch, snap)
        name = str(dtype)[6:]
        for key in ("Loss-Reconstruction-Total", "Loss-Discriminator-Total",
                    "Loss-Generator-Total"):
            _require(abs(mk[key] - mp[key]) <= loss_tol * abs(mp[key]),
                     f"{name} stage-1 step {key}: kernels {mk[key]} vs plain {mp[key]}")
        n_flip, v_rel = _ema_rel(vk, vp, ik, ip)
        g_rel, d_rel = _rel(gk, gp), _rel(dk, dp)
        _require(n_flip <= flip_tol * ik.numel(),
                 f"{name}: {n_flip} of {ik.numel()} codes differ")
        _require(g_rel <= g_tol and d_rel <= d_tol and v_rel <= g_tol,
                 f"{name} stage-1 step: G grad {g_rel}, D grad {d_rel}, EMA {v_rel}")
        gw, gwr = _worst(gk, gp)
        print(f"[check] paper stage-1 step ({name}, B{VQ_BATCH}), kernels vs plain versions: "
              f"recon loss {mk['Loss-Reconstruction-Total']:.6f} vs "
              f"{mp['Loss-Reconstruction-Total']:.6f}, D loss {mk['Loss-Discriminator-Total']:.6f}"
              f" vs {mp['Loss-Discriminator-Total']:.6f} (tol {loss_tol:g} relative); "
              f"{n_flip} of {ik.numel()} codes differ (tol {flip_tol:.0%}); norm-relative error "
              f"G gradients "
              f"{g_rel:.3e} (tol {g_tol:g}; largest per tensor {gwr:.3e} at {gw}), D gradients "
              f"{d_rel:.3e} (tol {d_tol:g}), EMA state on unflipped codes {v_rel:.3e} (tol "
              f"{g_tol:g}); perplexity {mk['VQ0-Perplexity']:.2f} vs {mp['VQ0-Perplexity']:.2f}")
        if dtype == torch.float32:
            del model, d_model, lpips, step, snap
            torch.cuda.empty_cache()

    # 10c. FUSED_EMA_STATS on and off give the same indices and EMA state
    _, _, _, v_off, i_off = _one_step(model, d_model, lpips, step, batch, snap)
    vq.nearest_codeword.launches = vq.nearest_codeword_stats.launches = 0
    with mock.patch.object(vq, "FUSED_EMA_STATS", True):
        _, _, _, v_on, i_on = _one_step(model, d_model, lpips, step, batch, snap)
    torch.cuda.synchronize()
    rec["stats_launches"] = vq.nearest_codeword_stats.launches
    _require(rec["stats_launches"] == 1 and vq.nearest_codeword.launches == 0,
             f"FUSED_EMA_STATS step: {rec['stats_launches']} stats and "
             f"{vq.nearest_codeword.launches} argmin launches, want 1 and 0")
    _require(torch.equal(i_on, i_off), "FUSED_EMA_STATS changes the indices")
    ema_err = max(_compare_grad(f"EMA {k}", v_on[k], v_off[k]) for k in v_off)
    print(f"[check] FUSED_EMA_STATS step == default step: indices equal, EMA state max abs "
          f"err {ema_err:.3e} (tol 2e-2 of max |plain|, 1e-2 in norm); 1 stats launch")

    # 10d. the main path: steps on a repeated batch through the kernels
    state = create_vqvae_train_state(model, 1, d_model=d_model, device=dev)
    losses = []
    vq.nearest_codeword.launches = 0
    rs.fused_residual_layer.launches = rs.fused_residual_layer.bwd_launches = 0
    for _ in range(VQ_STEPS):
        state, metrics = step(state, batch, VQ_SCHED, lpips)
        losses.append(float(metrics["Loss-Reconstruction-Total"]))
    torch.cuda.synchronize()
    rec["launches"] = {"argmin": vq.nearest_codeword.launches,
                       "fwd": rs.fused_residual_layer.launches,
                       "bwd": rs.fused_residual_layer.bwd_launches}
    want = {"argmin": ARGMIN_PER_STEP, "fwd": RES_FWD_PER_STEP, "bwd": RES_BWD_PER_STEP}
    for k, per in want.items():
        _require(rec["launches"][k] == per * VQ_STEPS,
                 f"stage-1 {k}: {rec['launches'][k]} launches in {VQ_STEPS} steps, want "
                 f"{per * VQ_STEPS}")
    _, ev = make_vqvae_eval_step(model, loss_name="jukebox_perceptual")(
        state, batch, VQ_SCHED, lpips)
    final = float(ev["Loss-Reconstruction-Total"] if "Loss-Reconstruction-Total" in ev
                  else ev["Loss"])
    _require(all(np.isfinite(losses)) and np.isfinite(final), f"losses {losses} {final}")
    _require(final < losses[0], f"reconstruction loss did not fall: {losses} then {final}")
    print(f"[train] paper stage 1 B{VQ_BATCH} x {VOLUME}, bf16, {VQ_STEPS} steps: "
          f"reconstruction losses {[round(x, 5) for x in losses]}, after {final:.5f}; "
          f"launches per step: residual forward {rec['launches']['fwd'] // VQ_STEPS}, "
          f"backward {rec['launches']['bwd'] // VQ_STEPS}, argmin "
          f"{rec['launches']['argmin'] // VQ_STEPS}")

    # 11. timings
    def step_s(reps):
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = step(state, batch, VQ_SCHED, lpips)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    with _plain_stage1():
        p1 = step_s(1)
    torch.cuda.reset_peak_memory_stats()
    k1 = step_s(2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k2 = step_s(2)
    with _plain_stage1():
        torch.cuda.reset_peak_memory_stats()
        p2 = step_s(1)
        peak_plain = torch.cuda.max_memory_allocated() / 2 ** 30
    step_k, step_p = (k1 + k2) / 2 * 1e3, (p1 + p2) / 2 * 1e3
    rec["step"] = (step_k, step_p, peak, peak_plain)
    print(f"[time] paper stage-1 train step B{VQ_BATCH} (cuDNN heuristics, benchmark off): "
          f"kernels {step_k:.1f} ms ({k1 * 1e3:.1f}"
          f", {k2 * 1e3:.1f}), {VQ_BATCH / (step_k / 1e3):.3f} volumes/s, peak {peak:.2f} GiB; "
          f"plain {step_p:.1f} ms ({p1 * 1e3:.1f}, {p2 * 1e3:.1f}), "
          f"{VQ_BATCH / (step_p / 1e3):.3f} volumes/s, peak {peak_plain:.2f} GiB  [{smi}]")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = step_s(1)
    rows = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dt = getattr(evt, "self_device_time_total", None)
            dt = evt.self_cuda_time_total if dt is None else dt
            rows[evt.key] = rows.get(evt.key, 0.0) + dt / 1e3
    busy = sum(rows.values())
    print(f"[profile] one stage-1 kernel train step: wall {wall * 1e3:.1f} ms, device time "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% busy)  [{smi}]")
    for key, ms in sorted(rows.items(), key=lambda kv: -kv[1])[:16]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / busy:5.1f}%  {key[:90]}")
    del state, model, d_model, lpips, step, snap, batch
    torch.cuda.empty_cache()
    return rec


def _time_stage1_kernels(dev, smi):
    """Phase 11: each new kernel at the shape the main path gives it, vs
    its plain version and its yardstick; returns {kernel: record}."""
    import torch
    import torch.nn.functional as F

    from synthanatomy_tpu_torch.ops import res_stack as rs
    from synthanatomy_tpu_torch.ops import vq

    out = {}
    n, k, d = VQ_BATCH * SEQ, 2048, 32
    gen = torch.Generator(device=dev).manual_seed(50)
    x = torch.randn(n, d, generator=gen, device=dev)
    w = torch.randn(k, d, generator=gen, device=dev)
    wsq = (w * w).sum(1)

    def yard_argmin():
        return torch.addmm(wsq[None, :], x, w.t(), alpha=-2.0).argmin(1)

    io = _nbytes(x, w) + n * 4
    # rows 3 and 4: the search is 2NKD operations, bound at the f32 peak,
    # or 3 x 2NKD on the tensor cores (split TF32) at the TF32 peak; the
    # lesser is the bound, so that no kernel reads faster than it
    pairs = {
        "argmin": (lambda: vq.nearest_codeword(x, w), lambda: vq.nearest_codeword_plain(x, w),
                   yard_argmin, 2 * n * k * d, io),
        "stats": (lambda: vq.nearest_codeword_stats(x, w),
                  lambda: vq.nearest_codeword_stats_plain(x, w), yard_argmin,
                  2 * n * k * d + n * d, io + k * (d + 1) * 4),
    }
    for name, (kern, plain, yard, flops, nbytes) in pairs.items():
        f32_bound = _bound(flops, nbytes, PEAK_F32)
        tc_bound = _bound(3 * flops, nbytes, PEAK_TF32)
        bound = min(f32_bound, tc_bound)
        t = _turns(kern, plain, yard, 60)
        out[name] = {"ms": t["ms"], "dev_ms": t["dev_ms"], "plain_ms": t["plain_ms"],
                     "yard_ms": t["library_ms"], "dev_yard_ms": t["dev_library_ms"],
                     "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"[time] row {3 if name == 'argmin' else 4} {name}, N {n}, K {k}, D {d} f32: kernel "
              f"{t['ms']:.4f} ms elapsed, {t['dev_ms']:.4f} device; plain {t['plain_ms']:.4f} / "
              f"{t['dev_plain_ms']:.4f}; yardstick (addmm + argmin) {t['library_ms']:.4f} / "
              f"{t['dev_library_ms']:.4f}; bound {f32_bound[0]:.4f} ms at the f32 peak "
              f"({f32_bound[1]}), {tc_bound[0]:.4f} for 3 x 2NKD at the TF32 tensor-core peak "
              f"({tc_bound[1]}); turns elapsed {[round(v, 4) for v in t['each']]}, device "
              f"{[round(v, 4) for v in t['dev_each']]}  [{smi}]")

    # row 7 at the paper shape, x channels-last as the VQ-VAE hands a fused
    # stack; kernel, plain version and cuDNN's chain in turns (_turns),
    # elapsed and device time
    cl = torch.channels_last_3d
    x0, w1, b1, w2, b2, g0 = _res_inputs((1, 128, 80, 112, 80), 128, torch.bfloat16, 51, dev)
    xs, gy = x0.contiguous(memory_format=cl), g0.contiguous(memory_format=cl)
    bf = torch.bfloat16
    w1c, b1c, w2c, b2c = (t.to(bf) for t in (w1, b1, w2, b2))
    yp, hp = rs.residual_layer_plain(xs, w1c, b1c, w2c, b2c)
    yp, hp = yp.contiguous(memory_format=cl), hp.contiguous(memory_format=cl)
    m = xs.shape[2] * xs.shape[3] * xs.shape[4]
    c = r = 128
    act = xs.numel() * 2  # one bf16 activation tensor

    def chain(t, w1_, b1_, w2_, b2_):  # cuDNN: conv3d -> relu -> conv3d -> add -> relu
        return torch.relu(F.conv3d(torch.relu(F.conv3d(t, w1_, b1_, padding=1)), w2_, b2_) + t)

    def yard_bwd(x_, g_):
        leaves = [t.detach().requires_grad_() for t in (x_, w1c, b1c, w2c, b2c)]
        return torch.autograd.grad(chain(*leaves), leaves, g_)

    rows = {
        "res_fwd": (lambda: rs._kernel_fwd(xs, w1c, b1c, w2c, b2c, True),
                    lambda: rs.residual_layer_plain(xs, w1c, b1c, w2c, b2c),
                    lambda: chain(xs, w1c, b1c, w2c, b2c), lambda: chain(x0, w1c, b1c, w2c, b2c),
                    _bound(2 * m * c * r * 28, 3 * act + _nbytes(w1c, w2c), PEAK_BF16)),
        "res_bwd": (lambda: rs._kernel_bwd(xs, hp, yp, gy, w1c, w2c),
                    lambda: rs.residual_layer_bwd_plain(xs, hp, yp, gy, w1c, w2c),
                    lambda: yard_bwd(xs, gy), lambda: yard_bwd(x0, g0),
                    _bound(2 * m * c * r * 56, 5 * act + _nbytes(w1c, w2c) * 3, PEAK_BF16)),
    }
    what = {"res_fwd": "forward", "res_bwd": "backward (cuDNN: forward + backward)"}
    for name, (kern, plain, yard, yard_ncdhw, bound) in rows.items():
        t = _turns(kern, plain, yard, 3)
        nc, nc_dev = _time_ms(yard_ncdhw, 3), _device_ms(yard_ncdhw, 3)
        out[name] = {"ms": t["ms"], "plain_ms": t["plain_ms"], "yard_ms": t["library_ms"],
                     "dev_ms": t["dev_ms"], "dev_yard_ms": t["dev_library_ms"],
                     "bound_ms": bound[0], "bound_by": bound[1]}
        print(f"[time] row 7 {what[name]}, 1 x 128 x 80x112x80 bf16, x NDHWC: kernel "
              f"{t['ms']:.4f} ms elapsed, {t['dev_ms']:.4f} device; plain {t['plain_ms']:.4f} / "
              f"{t['dev_plain_ms']:.4f}; cuDNN chain (NDHWC) {t['library_ms']:.4f} / "
              f"{t['dev_library_ms']:.4f}, (NCDHW) {nc:.4f} / {nc_dev:.4f}; bound {bound[0]:.4f} "
              f"ms ({bound[1]}); turns elapsed {[round(v, 4) for v in t['each']]}, device "
              f"{[round(v, 4) for v in t['dev_each']]}  [{smi}]")
    # like for like: the kernels' forward + backward against cuDNN's, and
    # both under remat, the one setting that fuses (a layer runs its
    # forward twice and its backward once: 12 forward and 6 backward calls
    # at B3 a stage-1 step, 18 volumes of each pair)
    fw, bw = out["res_fwd"], out["res_bwd"]
    for label, key, yard in (("elapsed", "ms", "yard_ms"), ("device", "dev_ms", "dev_yard_ms")):
        pair, remat = fw[key] + bw[key], 2 * fw[key] + bw[key]
        c_pair, c_remat = bw[yard], fw[yard] + bw[yard]
        print(f"[time] row 7 {label} time, 1 x 128 x 80x112x80 bf16, x NDHWC: kernels fwd+bwd "
              f"{pair:.4f} ms vs cuDNN chain fwd+bwd {c_pair:.4f} ({c_pair / pair:.3f}x); under "
              f"remat (2 fwd + 1 bwd) {remat:.4f} vs {c_remat:.4f} ({c_remat / remat:.3f}x), "
              f"{18 * remat:.2f} vs {18 * c_remat:.2f} ms a stage-1 step (18 volumes)  [{smi}]")

    # row 7's kernels: two forward and two backward calls (the profiler may
    # miss the first launch it sees)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            rows["res_fwd"][0]()
            rows["res_bwd"][0]()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        name = evt.key.split("(")[0]
        if evt.device_type == torch.autograd.DeviceType.CUDA and name.startswith("rt::"):
            dt = getattr(evt, "self_device_time_total", None)
            dt = evt.self_cuda_time_total if dt is None else dt
            print(f"[profile] row 7 at the paper shape, two forward and two backward calls: "
                  f"{name} {dt / 1e3 / evt.count:.4f} ms a launch, {evt.count} launches  [{smi}]")

    # what the channels-last layout costs and buys around a fused stack: the
    # one conversion of its input, and cuDNN's neighbouring convolutions
    # (the encoder's next 4³ stride-2 conv, the decoder's last 4³ transposed
    # conv to one channel) on either layout
    gen = torch.Generator(device=dev).manual_seed(52)
    w_enc = (torch.randn(128, 128, 4, 4, 4, generator=gen, device=dev) * 0.01).to(bf)
    w_dec = (torch.randn(128, 1, 4, 4, 4, generator=gen, device=dev) * 0.01).to(bf)
    for label, fn in (
            ("conversion NCDHW -> NDHWC", lambda: x0.contiguous(memory_format=cl)),
            ("encoder 4³ s2 conv 128->128, NCDHW", lambda: F.conv3d(x0, w_enc, stride=2, padding=1)),
            ("encoder 4³ s2 conv 128->128, NDHWC", lambda: F.conv3d(xs, w_enc, stride=2, padding=1)),
            ("decoder 4³ s2 transposed conv 128->1, NCDHW",
             lambda: F.conv_transpose3d(x0, w_dec, stride=2, padding=1)),
            ("decoder 4³ s2 transposed conv 128->1, NDHWC",
             lambda: F.conv_transpose3d(xs, w_dec, stride=2, padding=1))):
        print(f"[time] {label}, 1 x 128 x 80x112x80 bf16: {_time_ms(fn, 10):.4f} ms elapsed, "
              f"{_device_ms(fn, 10):.4f} device  [{smi}]")
    return out


def _check_splash(dev):
    """Phase 12; returns the max abs error at the main path's form (bf16,
    block 256, unfused)."""
    import torch
    import torch.nn.functional as F
    from synthanatomy_tpu_torch.ops import local_attention_splash as ls

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [("paper", (6, 8, 1401, 64), 420, block, dtype, fused)
              for dtype in (bf16, f32) for block in (256, 128) for fused in (False, True)]
    shapes += [(label, shape, w, 128, dtype, fused) for fused in (False, True)
               for label, shape, w, dtype in (
                   ("L 130, w 17", (1, 2, 130, 64), 17, f32),
                   ("L 300, w 37", (2, 2, 300, 64), 37, bf16),
                   ("L < w", (1, 2, 50, 64), 100, bf16),
                   ("w 1", (1, 3, 200, 64), 1, f32),
                   ("w = 2 tiles", (1, 2, 300, 64), 128, bf16),
                   ("L 2 tiles - 1, w 64", (1, 2, 127, 64), 64, bf16),
                   ("L 2 tiles + 1, w 65, f32", (1, 2, 129, 64), 65, f32),
                   ("w 2, L 3 tiles - 1", (1, 2, 191, 64), 2, bf16),
                   ("w >= L", (1, 2, 193, 64), 400, bf16),
                   ("w 64, f32", (1, 3, 65, 64), 64, f32))]
    err_main = None
    for label, shape, w, block, dtype, fused in shapes:
        b, h, n, d = shape
        n_pad = -(-n // block) * block
        q, k, v, g = _attention_inputs((b, h, n, d), dtype, n + w, dev)
        q = (q.float() * d ** -0.5).to(dtype)
        q, k, v = (F.pad(x, (0, 0, 0, n_pad - n)) for x in (q, k, v))
        g = F.pad(g, (0, 0, 0, n_pad - n))
        got = _fwd_bwd(lambda *x: ls.splash_attention_core(*x, w, block, block, fused), q, k, v, g)
        want = _fwd_bwd(lambda *x: ls.splash_attention_plain(*x, w, block, block, fused),
                        q, k, v, g)
        torch.cuda.synchronize()
        if dtype == f32:  # same rounding points, f32 sums in other orders
            err = max(_compare_f32(f"splash {label} {nm}", a, b_)
                      for nm, a, b_ in zip(("out", "dq", "dk", "dv"), got, want))
        else:
            err = max(_compare_grad(f"splash {label} {nm}", a, b_)
                      for nm, a, b_ in zip(("out", "dq", "dk", "dv"), got, want))
        again = _fwd_bwd(lambda *x: ls.splash_attention_core(*x, w, block, block, fused),
                         q, k, v, g)
        _require(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                 f"splash {label}: two runs differ")
        nt = n_pad // ls.KERNEL_TILE
        nnz = ls._device_map(n_pad, w, q.device)[2]
        fv = torch.zeros(b * h, nt, dtype=torch.int32, device=dev)
        bv = torch.zeros(2, b * h, nt, dtype=torch.int32, device=dev)
        o, lse = ls._kernel_fwd(q, k, v, w, visits=fv)
        ls._kernel_bwd(q, k, v, o, lse, g.to(dtype), w, fused, visits=bv)
        _, lse_plain = ls.splash_fwd_plain(q, k, v, w, block, block)
        torch.cuda.synchronize()
        lse_err = float((lse - lse_plain).abs().max())
        _require(lse_err <= 1e-4 * max(1.0, float(lse_plain.abs().max())),
                 f"splash {label} lse: max abs err {lse_err}")
        visits = [int(fv.sum()), int(bv[0].sum()), int(bv[1].sum())]
        want_visits = [nnz * b * h, nnz * b * h, 0 if fused else nnz * b * h]
        _require(visits == want_visits, f"splash {label}: tiles visited {visits}, tile map "
                                        f"{want_visits}")
        if label == "paper" and dtype == bf16 and block == 256 and not fused:
            err_main = err
        print(f"[check] splash == plain ({label}: {shape} padded to {n_pad}, w {w}, block "
              f"{block}, {str(dtype)[6:]}, {'fused' if fused else 'unfused'} bwd): o/dq/dk/dv "
              f"max abs err {err:.3e} ({'1e-4 of max |plain| and in norm' if dtype == f32 else '2e-2 of max |plain|, 1e-2 in norm'}), "
              f"lse {lse_err:.2e}; two runs bit-identical; tiles visited fwd/dkv/dq "
              f"{visits[0]}/{visits[1]}/{visits[2]} = map {nnz} of {nt * nt} pairs x {b * h} "
              f"heads")
    return err_main


def _compare_f32(name, a, b):
    """f32 kernel vs plain: the same operations summed in other orders,
    ~1e-6 relative; bound 1e-4 of the largest magnitude and in norm."""
    import torch

    a, b = a.float(), b.float()
    err = float((a - b).abs().max())
    _require(err <= 1e-4 * float(b.abs().max()) and float(torch.linalg.norm(a - b))
             <= 1e-4 * float(torch.linalg.norm(b)),
             f"kernel disagrees with plain on {name}: max abs err {err}")
    return err


def _check_bench(dev, smi):
    """Phase 13.  Returns the records the kernels' JSON line needs."""
    import numpy as np
    import torch
    from synthanatomy_tpu_torch.ops import local_attention_flash as lf
    from synthanatomy_tpu_torch.ops import local_attention_splash as ls
    from synthanatomy_tpu_torch.tools import bench_transformer as bench
    from synthanatomy_tpu_torch.train.transformer_steps import (
        create_transformer_train_state,
        make_transformer_train_step,
    )

    rec = {}
    # 13a. the main path: the bench entry point at paper form
    ls.local_attention_splash.launches = 0
    run_s1 = bench.main(BENCH_SPLASH + BENCH_STEPS)
    torch.cuda.synchronize()
    rec["launches"] = ls.local_attention_splash.launches
    n_steps = len(run_s1["losses"])
    _require(rec["launches"] == n_steps * SPLASH_PER_STEP,
             f"bench: {rec['launches']} splash launches in {n_steps} steps, want "
             f"{n_steps * SPLASH_PER_STEP}")
    _require(all(np.isfinite(run_s1["losses"])), f"bench losses {run_s1['losses']}")
    print(f"[bench] paper form through splash (bf16, remat, B{TRAIN_BATCH}): {n_steps} steps, "
          f"losses {[round(x, 4) for x in run_s1['losses']]}, "
          f"{rec['launches'] // n_steps} splash launches per step (24 layers x (2 fwd + 2 bwd))")

    # 13b. one step through splash against the same step through row 6
    args = bench.parse_args(BENCH_SPLASH)
    model = bench.build_model(args, dev)
    with torch.no_grad():
        for blk in model.blocks:  # non-zero gains, so attention reaches the loss
            blk.g_attn.fill_(0.1)
            blk.g_ff.fill_(0.1)
    inputs, targets = bench.batch(args, dev)
    step = make_transformer_train_step(model)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def one_step():
        model.load_state_dict(init)
        state = create_transformer_train_state(model, seed=0)
        _, m = step(state, inputs, targets, None, {"lr": 1e-4})
        return float(m["Loss"]), _grads(model)

    with bench.local_route(args):
        loss_s, g_s = one_step()
    loss_b, g_b = one_step()
    model.load_state_dict(init)
    g_rel = _rel(g_s, g_b)
    gw, gwr = _worst(g_s, g_b)
    _require(abs(loss_s - loss_b) <= 2e-3 * abs(loss_b),
             f"splash step loss {loss_s} vs banded {loss_b}")
    _require(g_rel <= 5e-2, f"splash step gradients vs banded: norm-relative {g_rel}")
    print(f"[check] bench step (bf16, gains 0.1), splash vs row 6 from the same weights: loss "
          f"{loss_s:.6f} vs {loss_b:.6f} (tol 2e-3 relative: p is rounded before P·V in row 6 "
          f"and not in splash), gradient norm-relative {g_rel:.3e} (tol 5e-2; largest per "
          f"tensor {gwr:.3e} at {gw})")

    from torch.profiler import ProfilerActivity, profile

    with bench.local_route(args):
        state = create_transformer_train_state(model, seed=0)
        step(state, inputs, targets, None, {"lr": 1e-4})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, inputs, targets, None, {"lr": 1e-4})
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dt = getattr(evt, "self_device_time_total", None)
            dt = evt.self_cuda_time_total if dt is None else dt
            rows[evt.key] = rows.get(evt.key, 0.0) + dt / 1e3
    busy = sum(rows.values())
    print(f"[profile] one splash bench step (bf16, remat): wall {wall * 1e3:.1f} ms, device time "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% busy)  [{smi}]")
    for key, ms in sorted(rows.items(), key=lambda kv: -kv[1])[:14]:
        print(f"[profile]   {ms:9.2f} ms {100 * ms / busy:5.1f}%  {key[:90]}")
    del model, state, step, init, g_s, g_b, prof
    torch.cuda.empty_cache()

    # 13c. a short run with f32 attention
    ls.local_attention_splash.launches = 0
    run32 = bench.main(BENCH_SPLASH[:-1] + ["float32", "--steps", "1", "--warmup", "0"])
    torch.cuda.synchronize()
    _require(all(np.isfinite(run32["losses"])) and ls.local_attention_splash.launches
             == len(run32["losses"]) * SPLASH_PER_STEP,
             f"f32 bench: losses {run32['losses']}, {ls.local_attention_splash.launches} launches")
    print(f"[bench] paper form through splash, f32 attention: losses {run32['losses']}, "
          f"{ls.local_attention_splash.launches} splash launches in {len(run32['losses'])} steps")

    # 13d. timings: the bench step, splash and row 6 in turns
    lf.local_attention_flash.launches = 0
    run_b1 = bench.main(BENCH_BANDED + BENCH_STEPS)
    run_b2 = bench.main(BENCH_BANDED + BENCH_STEPS)
    _require(lf.local_attention_flash.launches > 0, "the row-6 bench did not reach row 6")
    run_s2 = bench.main(BENCH_SPLASH + BENCH_STEPS)
    step_s = (run_s1["ms_per_step"] + run_s2["ms_per_step"]) / 2
    step_b = (run_b1["ms_per_step"] + run_b2["ms_per_step"]) / 2
    tokens = TRAIN_BATCH * (SEQ + 1)
    rec["step"] = (step_s, step_b)
    print(f"[time] bench step B{TRAIN_BATCH} x {SEQ + 1} (bf16, remat, FAVOR through row 5): "
          f"splash {step_s:.1f} ms ({run_s1['ms_per_step']:.1f}, {run_s2['ms_per_step']:.1f}), "
          f"{tokens / (step_s / 1e3):.0f} tok/s; row 6 {step_b:.1f} ms "
          f"({run_b1['ms_per_step']:.1f}, {run_b2['ms_per_step']:.1f}), "
          f"{tokens / (step_b / 1e3):.0f} tok/s  [{smi}]")

    # 13e. one layer's local attention, fwd+bwd, at the paper shape
    import torch.nn.functional as F

    n, n_pad, w = SEQ + 1, 1536, 420
    q, k, v, g = _attention_inputs((TRAIN_BATCH, 8, n, 64), torch.bfloat16, 6, dev)
    g = g.to(torch.bfloat16)
    qs = (q.float() * 0.125).to(torch.bfloat16)
    qp, kp, vp, gp = (F.pad(x, (0, 0, 0, n_pad - n)) for x in (qs, k, v, g))
    i_, j_ = torch.arange(n, device=dev)[:, None], torch.arange(n, device=dev)[None, :]
    band = (j_ <= i_) & (j_ > i_ - w)

    def splash():
        return _fwd_bwd(lambda *x: ls.splash_attention_core(*x, w), qp, kp, vp, gp)

    def plain():
        return _fwd_bwd(lambda *x: ls.splash_attention_plain(*x, w), qp, kp, vp, gp)

    def banded():
        return _fwd_bwd(lambda *x: lf.local_attention_flash_core(*x, w), q, k, v, g)

    def sdpa():
        leaves = [t.detach().clone().requires_grad_() for t in (qs, k, v)]
        o = torch.nn.functional.scaled_dot_product_attention(*leaves, attn_mask=band, scale=1.0)
        return torch.autograd.grad(o, leaves, g)

    p1, k1, b1, y1 = _time_ms(plain, 3), _time_ms(splash, 10), _time_ms(banded, 5), _time_ms(sdpa, 10)
    y2, b2, k2, p2 = _time_ms(sdpa, 10), _time_ms(banded, 5), _time_ms(splash, 10), _time_ms(plain, 3)
    # the same in device time (_device_ms), in the same turns
    dk1, db1, dy1 = _device_ms(splash, 10), _device_ms(banded, 10), _device_ms(sdpa, 10)
    dy2, db2, dk2 = _device_ms(sdpa, 10), _device_ms(banded, 10), _device_ms(splash, 10)
    pairs = sum(min(i + 1, w) for i in range(n))
    io = _nbytes(qs, k, v, g) * 2 + TRAIN_BATCH * 8 * n * 4  # + lse
    rec["bound"] = _bound(14 * TRAIN_BATCH * 8 * pairs * 64, io, PEAK_BF16)
    rec["ms"], rec["plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
    rec["banded_ms"], rec["sdpa_ms"] = (b1 + b2) / 2, (y1 + y2) / 2
    print(f"[time] local attention fwd+bwd, one layer (B{TRAIN_BATCH} x 8 heads x L{n} x d64, "
          f"w {w}, bf16): splash {rec['ms']:.3f} ms ({k1:.3f}, {k2:.3f}), plain "
          f"{rec['plain_ms']:.3f} ({p1:.3f}, {p2:.3f}), row 6 {rec['banded_ms']:.3f} ({b1:.3f}, "
          f"{b2:.3f}), SDPA banded mask {rec['sdpa_ms']:.3f} ({y1:.3f}, {y2:.3f}); bound "
          f"{rec['bound'][0]:.4f} ms ({rec['bound'][1]})  [{smi}]")
    dev = {"splash": (dk1 + dk2) / 2, "row 6": (db1 + db2) / 2, "SDPA banded mask": (dy1 + dy2) / 2}
    rec["dev_ms"], rec["dev_banded_ms"], rec["dev_sdpa_ms"] = dev.values()
    print(f"[time] the same in device time (queued behind a GPU spin): splash "
          f"{dev['splash']:.4f} ms ({dk1:.4f}, {dk2:.4f}), row 6 {dev['row 6']:.4f} ({db1:.4f}, "
          f"{db2:.4f}), SDPA banded mask {dev['SDPA banded mask']:.4f} ({dy1:.4f}, {dy2:.4f})  "
          f"[{smi}]")
    flops = 14 * TRAIN_BATCH * 8 * pairs * 64
    elapsed = {"splash": rec["ms"], "row 6": rec["banded_ms"], "SDPA banded mask": rec["sdpa_ms"]}
    print(f"[time] useful TFLOP/s of local attention fwd+bwd ({flops / 1e9:.2f} GFLOP of band "
          f"products), elapsed / device time: "
          + ", ".join(f"{k} {flops / elapsed[k] / 1e9:.1f} / {flops / dev[k] / 1e9:.1f}"
                      for k in dev) + f"  [{smi}]")
    return rec


def _greedy_agree(a, b):
    return float((a.cpu() == b.cpu()).float().mean())


def _check_exact_decode(dev, smi, fused_s):
    """Phase 14: the exact decode path."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer
    from synthanatomy_tpu_torch.models.sampling import (
        exact_logits_stepper,
        fused_logits_stepper,
        make_sampler,
        sample_naive,
    )
    from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE
    from synthanatomy_tpu_torch.ops import fused_decode as fd
    from synthanatomy_tpu_torch.pipeline import make_synthesizer

    # 14a. teacher-forced: decode_step against the batch forward, in f32 at
    # gains 0.1 (ROADMAP §3: larger gains make a 24-layer random prior
    # chaotic), B2; then the fused step against the exact step
    model, _ = _performer(True, seed=60, device=dev, dtype=torch.float32, gains=(0.1, 0.1),
                          **PAPER)
    b = 2
    tokens = torch.as_tensor(np.random.default_rng(61).integers(0, 2048, (b, TF_TOKENS)),
                             device=dev)
    tokens[:, 0] = 2048  # BOS
    with torch.no_grad():
        batch = model(tokens).float()
        cache = model.init_cache(b)
        t0 = time.perf_counter()
        eager = []
        for t in range(TF_EAGER):
            logits, cache = model.decode_step(tokens[:, t], cache, t)
            eager.append(logits.float())
        eager = torch.stack(eager, dim=1)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step = exact_logits_stepper(model, batch=b)  # replays a CUDA graph from t = 2
        exact = torch.stack([step(tokens[:, t], t).float() for t in range(TF_TOKENS)], dim=1)
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
    # f32 on both sides with the zero key stabilizer: the same math in
    # other summation orders (~1e-6 relative per layer); a wrong ring slot,
    # position or mask moves logits by O(1) of their scale
    scale = batch.abs().amax(dim=(0, 2))
    per_pos = ((exact - batch).abs().amax(dim=(0, 2)) / scale)[TF_CHECK]
    tf_err = float(per_pos.max())
    eager_err = float(((eager - batch[:, :TF_EAGER]).abs().amax(dim=(0, 2))
                       / scale[:TF_EAGER]).max())
    graph_vs_eager = float((exact[:, :TF_EAGER] - eager).abs().max() / eager.abs().max())
    _require(tf_err <= 1e-3, f"decode_step vs forward: max per-position relative error "
                             f"{tf_err} at position {TF_CHECK[int(per_pos.argmax())]}")
    _require(eager_err <= 1e-3, f"eager decode_step vs forward: {eager_err}")
    # the graph replays the eager step's kernels on the same inputs; a stale
    # position or cache in the replay would move logits by O(1)
    _require(graph_vs_eager <= 1e-5, f"graph-replayed vs eager decode_step: {graph_vs_eager}")
    print(f"[check] paper prior f32 (gains 0.1), decode_step vs Performer.forward, "
          f"teacher-forced: replayed from a CUDA graph over {TF_TOKENS} tokens (ring of 420 "
          f"slots wraps at 420), positions 0-63 and 400-520: max |Δlogit| / max |logit| per "
          f"position {tf_err:.3e}; eager over positions 0-{TF_EAGER - 1}: {eager_err:.3e} (tol "
          f"1e-3); graph vs eager {graph_vs_eager:.3e} (tol 1e-5); logit std "
          f"{float(batch.std()):.4f}")
    print(f"[time] exact decode_step B{b} f32 paper width: eager {1e3 * eager_s / TF_EAGER:.2f} "
          f"ms per step, graph-replayed {1e3 * graph_s / TF_TOKENS:.2f} ms per step (capture "
          f"included)  [{smi}]")
    lp = F.log_softmax(exact, dim=-1)
    for wq in ("int8", "int4"):
        step = fused_logits_stepper(model, batch=b, ring_quant=True, weight_quant=wq)
        with torch.no_grad():
            fused = torch.stack([step(tokens[:, t], t) for t in range(TF_TOKENS)], dim=1)
        lq = F.log_softmax(fused, dim=-1)
        dmax = (fused - exact).abs().amax(dim=(0, 2))  # per step
        kl = float((lp.exp() * (lp - lq)).sum(-1).mean())
        tv = float(0.5 * (lp.exp() - lq.exp()).abs().sum(-1).mean())
        agree = _greedy_agree(fused.argmax(-1), exact.argmax(-1))
        _require(bool(torch.isfinite(fused).all()), f"fused {wq}: non-finite logits")
        print(f"[quality] fused step, {wq} weights + int8 rings, vs the exact step (f32 "
              f"exact, {TF_TOKENS} steps x B{b}, random weights, flat logits): per-step max "
              f"|Δlogit| mean {float(dmax.mean()):.4f}, max {float(dmax.max()):.4f}; mean "
              f"KL(exact||fused) {kl:.3e}; mean total variation {tv:.3e}; greedy agreement "
              f"{agree:.4f}")
    del model, batch, exact, eager, cache, step, lp
    torch.cuda.empty_cache()

    # 14b. the exact sampler at the paper form, B16, bf16, on its own path
    performer, ordering = _performer(True, seed=0, device=dev, **PAPER)
    sampler = make_sampler(performer, ordering, batch=BATCH, fused=False)
    _require(not sampler.fused, "fused=False built a fused sampler")
    fd.fused_decode_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grids = sampler(torch.Generator(device=dev).manual_seed(62))
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    _require(fd.fused_decode_step.launches == 0,
             f"the exact sampler made {fd.fused_decode_step.launches} fused launches")
    _require(tuple(grids.shape) == (BATCH,) + GRID and int(grids.min()) >= 0
             and int(grids.max()) < 2048, f"exact sampler grid {tuple(grids.shape)}")
    print(f"[synth] exact sampler (make_sampler fused=False) B{BATCH}, bf16: grids "
          f"{tuple(grids.shape)} in [0, 2048), 0 fused launches")
    print(f"[time] exact sampling B{BATCH}, bf16: {exact_s:.3f} s per call, "
          f"{BATCH * SEQ / exact_s:.1f} latent tok/s; fused (int8 weights, int8 rings, phase 5) "
          f"{fused_s['int8']:.3f} s, {BATCH * SEQ / fused_s['int8']:.1f} tok/s: "
          f"{exact_s / fused_s['int8']:.2f}x  [{smi}]")

    # where an exact token's time goes: one eager decode_step and one graph
    # replay, timed by CUDA events, then counted under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    tok = torch.full((BATCH,), 5, dtype=torch.long, device=dev)
    step = exact_logits_stepper(performer, batch=BATCH)
    for t in range(3):  # t 0 and 1 eagerly, the capture at t 1, t 2 the first replay
        step(tok, t)
    cache = performer.init_cache(BATCH)
    with torch.no_grad():
        for label, fn in (("eager decode_step", lambda: performer.decode_step(tok, cache, 3)),
                          ("CUDA-graph replay", lambda: step(tok, 3))):
            ms = _time_ms(fn, 5)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_cuda_time_total if getattr(e, "self_device_time_total", None)
                       is None else e.self_device_time_total for e in rows) / 1e3
            print(f"[profile] exact step B{BATCH} bf16 paper width, {label}: {ms:.2f} ms per "
                  f"token (CUDA events), {sum(e.count for e in rows)} kernels, device time "
                  f"{busy:.2f} ms ({100 * busy / ms:.1f}% busy)  [{smi}]")
    del performer, sampler, step, cache
    torch.cuda.empty_cache()

    # 14c. greedy agreement on a small prior (f32: the comparisons test the
    # path, not bf16 rounding)
    small, order = _performer(True, seed=5, device=dev, grid=SMALL_GRID, dtype=torch.float32,
                              **SMALL)
    small_cpu = _performer(True, seed=5, device="cpu", grid=SMALL_GRID, dtype=torch.float32,
                           **SMALL)[0]
    g_card = make_sampler(small, order, batch=2, do_sample=False, fused=False)(None)
    g_cpu = make_sampler(small_cpu, order, batch=2, do_sample=False, fused=False)(None)
    g_naive = sample_naive(small, order, batch=2, do_sample=False)
    a_cpu, a_naive = _greedy_agree(g_card, g_cpu), _greedy_agree(g_card, g_naive)
    _require(a_cpu >= 0.9 and a_naive >= 0.9,
             f"small prior greedy agreement: card vs CPU {a_cpu}, sample vs naive {a_naive}")
    print(f"[check] small prior f32 greedy grids, exact sampler: card vs CPU agreement "
          f"{a_cpu:.4f}, sample vs sample_naive on the card {a_naive:.4f} (tol 0.9) over "
          f"{g_cpu.numel()} codes")

    pre = Performer(
        num_tokens=2049, max_seq_len=int(np.prod(SMALL_GRID)) + 1, dim=128, depth=2, heads=2,
        dim_head=64, local_attn_heads=1, local_window_size=12, use_rezero=True,
        spatial_position_emb="absolute", spatial_shape=SMALL_GRID, ordering=order,
        conditioning_num_tokens=(3, 5), conditioning_type="prepending",
        generator=torch.Generator().manual_seed(63), device="cpu").to(dev)
    with torch.no_grad():
        for blk in pre.blocks:
            blk.g_attn.fill_(0.7)
            blk.g_ff.fill_(0.5)
    vq = BaselineVQVAE(
        n_levels=2, downsample_parameters=((4, 2, 1, 1),) * 2,
        upsample_parameters=((4, 2, 1, 0, 1),) * 2, n_embed=2048, embed_dim=8, n_channels=16,
        n_res_channels=16, n_res_layers=1, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(64), device=dev)
    synth = make_synthesizer(pre, vq, order, batch=2, with_conditionings=True, decode_batch=2)
    fd.fused_decode_step.launches = 0
    conds = [torch.tensor([0, 2], device=dev), torch.tensor([1, 4], device=dev)]
    vols, grids = synth(torch.Generator(device=dev).manual_seed(65), conds)
    torch.cuda.synchronize()
    _require(fd.fused_decode_step.launches == 0, "the prepending synthesizer took the fused step")
    _require(tuple(grids.shape) == (2,) + SMALL_GRID and int(grids.max()) < 2048
             and tuple(vols.shape) == (2, 1, 8, 12, 16) and bool(torch.isfinite(vols).all()),
             f"prepending synthesis: grids {tuple(grids.shape)}, volumes {tuple(vols.shape)}")
    print(f"[synth] make_synthesizer, 'prepending' small prior (auto -> exact path): grids "
          f"{tuple(grids.shape)}, volumes {tuple(vols.shape)} {vols.dtype}, finite, 0 fused "
          f"launches")


def _check_decode_side(dev, smi):
    """Phase 15: row 2 and the probes.  Returns {kernel: (launches, max
    abs err, ms, plain ms, bound, library ms[, device ms])} for the
    kernels' line."""
    import torch

    from synthanatomy_tpu_torch.ops import probes, quant
    from synthanatomy_tpu_torch.tools import probe_int4, probe_int4_unpack, probe_pallas_overhead

    out = {}
    gen = torch.Generator(device=dev).manual_seed(70)

    def case(r, k, n):
        x = torch.randn(r, k, generator=gen, device=dev)
        return (x, *quant.quantize_int8(torch.randn(k, n, generator=gen, device=dev)))

    # 15a. int8_matmul's entry point at the paper decode GEMV shapes (q/k/v,
    # out, FF in, FF out; R 16), then awkward shapes
    paper = [case(*sh) for sh in INT8_GEMV]
    quant.int8_matmul.launches = 0
    got = [quant.int8_matmul(*c) for c in paper]
    torch.cuda.synchronize()
    launches = quant.int8_matmul.launches
    _require(launches == len(INT8_GEMV), f"int8_matmul: {launches} launches")
    errs = {}
    for label, shapes, cases, outs in (
            ("paper", INT8_GEMV, paper, got),
            ("awkward", INT8_AWKWARD, [case(*sh) for sh in INT8_AWKWARD], None)):
        errs[label] = 0.0
        for i, c in enumerate(cases):
            a = outs[i] if outs else quant.int8_matmul(*c)
            again = quant.int8_matmul(*c)
            e = _compare_f32(f"int8_matmul {label} {tuple(c[0].shape)}x{tuple(c[1].shape)}",
                             a, quant.int8_matmul_plain(*c))
            _require(torch.equal(a, again), f"int8_matmul {label}: two runs differ")
            errs[label] = max(errs[label], e)
        print(f"[check] int8_matmul == plain ({label}: R x K x N {shapes}): max abs err "
              f"{errs[label]:.3e} (tol 1e-4 of max |plain| and in norm: exact bf16 products "
              f"in f32, other orders); two runs bit-identical")
    err = errs["paper"]
    x, w_q, sc = paper[2]  # FF in: R 16, K 512, N 2048
    w_deq = w_q.to(torch.bfloat16) * sc.to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    r, k = x.shape
    n = w_q.shape[1]
    bound = _bound(2 * r * k * n, k * n + 4 * (r * k + r * n + n), PEAK_BF16)
    kern = lambda: quant.int8_matmul(x, w_q, sc)  # noqa: E731
    plain = lambda: quant.int8_matmul_plain(x, w_q, sc)  # noqa: E731
    p1, k1, k2, p2 = _time_ms(plain, 50), _time_ms(kern, 200), _time_ms(kern, 200), \
        _time_ms(plain, 50)
    d1, d2 = _device_ms(kern, 200), _device_ms(kern, 200)
    y_ms = _time_ms(lambda: torch.matmul(xb, w_deq), 200)
    # the single PyTorch call of row 2's function: x·(w·s)ᵀ with w (N, K)
    # int8, transposed once here; bf16(x) and the scales in f32 give the
    # function itself, bf16 inputs a bf16 output (held at its precision)
    lib_ms, lib_dev = None, None
    w_t = w_q.t().contiguous()
    want = quant.int8_matmul_plain(x, w_q, sc)
    lib = {dt: (lambda xl=xb.to(dt), sl=sc.reshape(-1).to(dt):
                torch._weight_int8pack_mm(xl, w_t, sl)) for dt in (torch.float32, torch.bfloat16)}
    try:  # only the call itself: a build without the CUDA op has no yardstick
        y = lib[torch.float32]().float()
        torch.cuda.synchronize()
    except NotImplementedError as e:
        y = None
        print(f"[time] torch._weight_int8pack_mm raises on {dev} (torch {torch.__version__}): "
              f"{str(e).splitlines()[0][:200]}; row 2's single-call yardstick: none")
    if y is not None:
        _compare_f32("torch._weight_int8pack_mm (f32) vs int8_matmul_plain", y, want)
        one = lib[torch.float32]
        lib_ms, lib_dev = _time_ms(one, 200), _device_ms(one, 200)
        print(f"[time] torch._weight_int8pack_mm R{r} K{k} N{n}, bf16(x) and scales in f32 "
              f"(row 2's function, one call): {lib_ms:.4f} ms elapsed, {lib_dev:.4f} ms device "
              f"time  [{smi}]")
        one = lib[torch.bfloat16]
        e16 = float((one().float() - want).abs().max())
        _require(e16 <= 2.0 ** -7 * float(want.abs().max()),
                 f"torch._weight_int8pack_mm (bf16): max abs err {e16}")
        print(f"[time] torch._weight_int8pack_mm in bf16 (bf16 scales and output; max abs err "
              f"{e16:.3e}, tol 2^-7 of max |plain|): {_time_ms(one, 200):.4f} ms elapsed, "
              f"{_device_ms(one, 200):.4f} ms device time")
    out["int8_matmul"] = (launches, err, (k1 + k2) / 2, (p1 + p2) / 2, bound, lib_ms)
    print(f"[time] int8_matmul R{r} K{k} N{n}: kernel {(k1 + k2) / 2:.4f} ms elapsed ({k1:.4f}, "
          f"{k2:.4f}), {(d1 + d2) / 2:.4f} ms device time ({d1:.4f}, {d2:.4f}); plain "
          f"{(p1 + p2) / 2:.4f} ms ({p1:.4f}, {p2:.4f}); a dequantised bf16 copy through "
          f"torch.matmul {y_ms:.4f} ms; bound {bound[0]:.5f} ms ({bound[1]})  [{smi}]")
    for (r_, k_, n_), c in zip(INT8_GEMV, paper):
        fn = lambda c=c: quant.int8_matmul(*c)  # noqa: E731
        print(f"[time] int8_matmul R{r_} K{k_} N{n_} (the four paper GEMVs): "
              f"{_time_ms(fn, 200):.4f} ms elapsed, {_device_ms(fn, 200):.4f} ms device time")

    # 15b. the probes' own entry points; each raises on a failed check
    probes.weight_stream.launches = probes.weight_stream.packed_launches = 0
    probe_int4.main([])
    torch.cuda.synchronize()
    ws_int4 = probes.weight_stream.packed_launches
    ws_int8 = probes.weight_stream.launches - ws_int4
    probes.int4_unpack.launches = quant.int4_matmul.launches = 0
    probe_int4_unpack.main([])
    torch.cuda.synchronize()
    unpack_launches, i4mm_launches = probes.int4_unpack.launches, quant.int4_matmul.launches
    probes.tile_steps.launches = 0
    probe_pallas_overhead.main([])
    torch.cuda.synchronize()
    tile_launches = probes.tile_steps.launches
    _require(min(ws_int8, ws_int4, unpack_launches, i4mm_launches, tile_launches) > 0,
             f"probe launches: weight stream {ws_int8}/{ws_int4}, unpack {unpack_launches}, "
             f"int4 product {i4mm_launches}, tile steps {tile_launches}")
    print(f"[probes] launches: weight_stream int8 {ws_int8}, packed int4 {ws_int4}; int4_unpack "
          f"{unpack_launches}; int4_matmul (E, F) {i4mm_launches}; tile_steps {tile_launches}")

    # 15c. each probe kernel at its probe's shape against its plain version
    g = torch.Generator(device=dev).manual_seed(71)
    B, K, N, L = probe_int4.B, probe_int4.K, probe_int4.N, probe_int4.L
    xw = torch.randn(B, K, generator=g, device=dev).to(torch.bfloat16)
    w8 = torch.randint(-7, 8, (L, K, N), generator=g, device=dev).to(torch.int8)
    s = torch.rand(L, 1, N, generator=g, device=dev) * 0.01 + 0.01
    w4 = torch.from_numpy(probe_int4.pack(w8.cpu().numpy())).to(dev)
    for name, w, packed, n_launch in (("weight_stream_int8", w8, False, ws_int8),
                                      ("weight_stream_int4", w4, True, ws_int4)):
        e = _compare_f32(name, probes.weight_stream(xw, w, s, packed),
                         probes.weight_stream_plain(xw, w, s, packed))
        _require(torch.equal(probes.weight_stream(xw, w, s, packed),
                             probes.weight_stream(xw, w, s, packed)), f"{name}: two runs differ")
        kern = lambda w=w, packed=packed: probes.weight_stream(xw, w, s, packed)  # noqa: E731
        plain = lambda w=w, packed=packed: probes.weight_stream_plain(xw, w, s, packed)  # noqa: E731
        p1, k1, k2, p2 = _time_ms(plain, 3), _time_ms(kern, 50), _time_ms(kern, 50), \
            _time_ms(plain, 3)
        d1, d2 = _device_ms(kern, 50), _device_ms(kern, 50)
        bound = _bound(2 * B * K * N * L, _nbytes(xw, w, s) + B * K * 4, PEAK_BF16)
        ms, dms = (k1 + k2) / 2, (d1 + d2) / 2
        out[name] = (n_launch, e, ms, (p1 + p2) / 2, bound, None)
        print(f"[time] {name} (B{B} K{K} N{N} L{L}, {_nbytes(w) / 1e6:.1f} MB of weights): kernel "
              f"{ms:.4f} ms elapsed ({k1:.4f}, {k2:.4f}), {dms:.4f} ms device time ({d1:.4f}, "
              f"{d2:.4f}) = {_nbytes(w) / dms / 1e6:.0f} GB/s of weights; plain "
              f"{(p1 + p2) / 2:.4f} ms; bound {bound[0]:.4f} ms ({bound[1]}); max abs err "
              f"{e:.3e}; two runs bit-identical  [{smi}]")
    # the packed product of row 9b's E and F at the unpack probe's shape
    xe = torch.randn(probe_int4_unpack.B, probe_int4_unpack.K, generator=g, device=dev)
    pe, se = quant.quantize_int4_packed(torch.randn(probe_int4_unpack.K, probe_int4_unpack.NN,
                                                    generator=g, device=dev))
    layers = probe_int4_unpack.L
    for label, pw, sw in (("E", pe, se), ("F", pe[None].expand(layers, -1, -1).contiguous(),
                                           se[None].expand(layers, -1, -1).contiguous())):
        fn = lambda pw=pw, sw=sw: quant.int4_matmul(xe, pw, sw)  # noqa: E731
        got = fn()
        _require(torch.equal(got, fn()), f"int4_matmul {label}: two runs differ")
        e4 = _compare_f32(f"int4_matmul {label}", got, quant.int4_matmul_plain(xe, pe, se))
        # every layer block read once (the launch walks them all), x read
        # and the output written once; the products of every layer
        nl = pw.shape[0] if pw.dim() == 3 else 1
        b4 = _bound(2 * xe.shape[0] * xe.shape[1] * pe.shape[1] * nl,
                    _nbytes(xe, pw, sw, got), PEAK_BF16)
        print(f"[time] int4_matmul {label} (R{xe.shape[0]} K{xe.shape[1]} N{pe.shape[1]}"
              f"{', L ' + str(pw.shape[0]) if pw.dim() == 3 else ''}): {_time_ms(fn, 200):.4f} ms "
              f"elapsed, {_device_ms(fn, 200):.4f} ms device time; bound {b4[0]:.7f} ms "
              f"({b4[1]}); max abs err {e4:.3e}; two runs bit-identical  [{smi}]")
    pk = torch.randint(-128, 128, (probe_int4_unpack.K2, probe_int4_unpack.N), generator=g,
                       device=dev).to(torch.int8)
    e = float((probes.int4_unpack(pk, 0) - probes.unpack_int4_plain(pk, 0)).abs().max())
    _require(e == 0.0, f"int4_unpack: error {e}")
    unpack = lambda: probes.int4_unpack(pk, 0)  # noqa: E731
    p1, k1, k2, p2 = (_time_ms(lambda: probes.unpack_int4_plain(pk, 0), 50),
                      _time_ms(unpack, 200), _time_ms(unpack, 200),
                      _time_ms(lambda: probes.unpack_int4_plain(pk, 0), 50))
    # device time beside an empty launch of the same grid, in turns: no
    # launch of that grid can take less
    geo = probes.int4_unpack_grid(pk)
    empty = lambda: probes.empty_launch(dev, geo["blocks"], geo["threads"])  # noqa: E731
    f1, d1, d2, f2 = (_device_ms(empty, 200), _device_ms(unpack, 200), _device_ms(unpack, 200),
                      _device_ms(empty, 200))
    bound = _bound(0, pk.numel() * 9, PEAK_F32)
    out["int4_unpack"] = (unpack_launches, e, (k1 + k2) / 2, (p1 + p2) / 2, bound, None,
                          (d1 + d2) / 2)
    print(f"[time] int4_unpack A (K2 {pk.shape[0]}, N {pk.shape[1]}): kernel {(k1 + k2) / 2:.4f} "
          f"ms elapsed ({k1:.4f}, {k2:.4f}), {(d1 + d2) / 2:.4f} ms device time ({d1:.4f}, "
          f"{d2:.4f}); an empty launch of its grid ({geo['blocks']} blocks of {geo['threads']}) "
          f"{(f1 + f2) / 2:.4f} ms device time ({f1:.4f}, {f2:.4f}); plain {(p1 + p2) / 2:.4f} "
          f"ms; bound {bound[0]:.6f} ms ({bound[1]}: the packed bytes read, two f32 values "
          f"written a byte; the same for B, C and D, which compute the same unpack)  [{smi}]")
    for v in range(1, 4):
        ev = float((probes.int4_unpack(pk, v) - probes.unpack_int4_plain(pk, v)).abs().max())
        _require(ev == 0.0, f"int4_unpack {probes.UNPACK_VARIANTS[v]}: error {ev}")
        print(f"[time] int4_unpack {probes.UNPACK_VARIANTS[v]}: exact, "
              f"{_device_ms(lambda v=v: probes.int4_unpack(pk, v), 200):.4f} ms device time")

    M, KD, ND, G = (probe_pallas_overhead.M, probe_pallas_overhead.K_DIM, probe_pallas_overhead.N,
                    probe_pallas_overhead.G)
    xt = torch.randn(M, KD, generator=g, device=dev).to(torch.bfloat16)
    wt = torch.randn(KD, ND, generator=g, device=dev).to(torch.bfloat16)
    plan = probes.tile_steps_plan(M, KD, ND)
    _require(plan["active_clusters"] * plan["cluster"] >= plan["blocks"],
             f"tile_steps: not every cluster resident at once ({plan})")
    a, b_ = probes.tile_steps(xt, wt, G).float(), probes.tile_steps_plain(xt, wt, G).float()
    e = float((a - b_).abs().max())
    _require(e <= 1e-2 * float(b_.abs().max()), f"tile_steps: max abs err {e}")
    _require(torch.equal(probes.tile_steps(xt, wt, G), probes.tile_steps(xt, wt, G)),
             "tile_steps: two runs differ")
    # the one PyTorch call of the same function: bf16 of the sum of G·K
    # products with f32 sums, on G copies of the operands (built here, out
    # of the timed call); the kernel reads each operand once
    xr, wr = xt.repeat(1, G), wt.repeat(G, 1)
    library = lambda: torch.matmul(xr, wr)  # noqa: E731
    e_lib = float((library().float() - b_).abs().max())
    _require(e_lib <= 1e-2 * float(b_.abs().max()), f"torch.matmul yardstick: max abs err {e_lib}")
    t = _turns(lambda: probes.tile_steps(xt, wt, G), lambda: probes.tile_steps_plain(xt, wt, G),
               library, 20)
    bound = _bound(2 * M * KD * ND * G, _nbytes(xt, wt) + M * ND * 2, PEAK_BF16)
    out["launch_overhead"] = (tile_launches, e, t["ms"], t["plain_ms"], bound, t["library_ms"],
                              t["dev_ms"])
    print(f"[time] launch_overhead tile program, G {G} steps of {M}x{KD}x{ND} bf16 "
          f"({plan['blocks']} blocks in clusters of {plan['cluster']}, all resident: the card "
          f"holds {plan['active_clusters']}): kernel {t['ms']:.4f} ms elapsed "
          f"({t['each'][1]:.4f}, {t['each'][4]:.4f}), {t['dev_ms']:.4f} ms device time "
          f"({t['dev_each'][1]:.4f}, {t['dev_each'][4]:.4f}; {t['dev_ms'] / G * 1e3:.3f} us a "
          f"step); plain {t['plain_ms']:.4f} ms; torch.matmul of G copies ({M}x{KD * G} by "
          f"{KD * G}x{ND}: reads the operands G times, the kernel once) {t['library_ms']:.4f} "
          f"ms elapsed, {t['dev_library_ms']:.4f} device, max abs err {e_lib:.3e}; bound "
          f"{bound[0]:.4f} ms ({bound[1]}); max abs err {e:.3e} (bf16 output, tol 1e-2 of max "
          f"|plain|); two runs bit-identical  [{smi}]")
    return out


def _check_kernel_body(dev, smi):
    """Phase 16: row 9d, the kernel-body probe's own entry point, then its
    production-equal bodies timed against their plain versions.  Returns
    {kernel: (launches, max abs err, ms, plain ms, bound, library ms)}."""
    import torch

    from synthanatomy_tpu_torch.ops import kernel_body as kb
    from synthanatomy_tpu_torch.tools import probe_kernel_body as pkb

    counters = (kb.local_fwd_body, kb.local_bwd_body, kb.favor_fwd_body, kb.favor_bwd_body)
    for c in counters:
        c.launches = 0
    # every row (not --quick): each is held against its plain twin, the
    # production-equal bodies against the production kernels; raises
    res = pkb.main(["--reps", str(PROBE_REPS)])
    torch.cuda.synchronize()
    lf_n, lb_n, ff_n, fb_n = (c.launches for c in counters)
    _require(min(lf_n, lb_n, ff_n, fb_n) > 0,
             f"kernel-body launches: local fwd {lf_n}, local bwd {lb_n}, favor fwd {ff_n}, "
             f"favor bwd {fb_n}")
    print(f"[probe] kernel-body launches: local fwd {lf_n}, local bwd {lb_n}, favor fwd {ff_n}, "
          f"favor bwd sweeps {fb_n}")

    B, H, L, D, W, M, CH = pkb.B, pkb.H, pkb.L, pkb.D, pkb.W, pkb.M_FEAT, pkb.CHUNK
    g = torch.Generator(device=dev).manual_seed(80)
    q, k, v, gy = (torch.randn(B, H, L, D, generator=g, device=dev).mul(0.5).to(torch.bfloat16)
                   for _ in range(4))
    proj = torch.full((M, D), 0.05, device=dev)
    pairs = sum(min(i + 1, W) for i in range(L))
    i_, j_ = torch.arange(L, device=dev)[:, None], torch.arange(L, device=dev)[None, :]
    band = (j_ <= i_) & (j_ > i_ - W)
    rows = {
        "local_fwd": res["local_fwd"]["full body"],
        "local_bwd": res["local_bwd"]["full, bf16 outputs, bt=1"],
    }
    favor_full = [res["favor"][label] for label, _, body in pkb.FAVOR_ROWS if body == "full"]
    favor_s = sum(r["s"] for r in favor_full)  # forward, dq sweep, dk/dv sweep
    favor_err = max(r["err"] for r in favor_full)

    def favor_plain():
        out, den = kb.favor_fwd_body_plain(q, k, v, proj, CH)
        return (kb.favor_bwd_body_plain(q, k, v, proj, gy, out, den, CH, sweep="dq"),
                kb.favor_bwd_body_plain(q, k, v, proj, gy, out, den, CH, sweep="dkv"))

    plain = {
        "local_fwd": lambda: kb.local_fwd_body_plain(q, k, v, W, "full"),
        "local_bwd": lambda: kb.local_bwd_body_plain(q, k, v, gy, W, "full"),
        "favor": favor_plain,
    }
    plain_ms = {name: (_time_ms(fn, 2) + _time_ms(fn, 2)) / 2 for name, fn in plain.items()}
    sdpa_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=band), 10)
    io = _nbytes(q)  # one (B, H, L, d) bf16 tensor
    bounds = {
        # the two products of the band (4 FLOP per pair and feature) over
        # q, k, v read and out written
        "local_fwd": _bound(4 * B * H * pairs * D, 4 * io, PEAK_BF16),
        # five products (scores, dP, dq, dk, dv) over q, k, v, g read and
        # dq, dk, dv written
        "local_bwd": _bound(10 * B * H * pairs * D, 7 * io, PEAK_BF16),
        # row 5's products at this shape (_favor_flops, phase 8's count): q,
        # k, v, g read, out, den, dq, dk, dv written in f32
        "favor": _bound(sum(_favor_flops(B, H, L, D, M, CH)),
                        4 * io + _nbytes(proj) + 8 * io + B * H * L * 4, PEAK_BF16),
    }
    out = {
        "kernel_body_local_fwd": (lf_n, rows["local_fwd"]["err"], rows["local_fwd"]["s"] * 1e3,
                                  plain_ms["local_fwd"], bounds["local_fwd"], sdpa_ms),
        "kernel_body_local_bwd": (lb_n, rows["local_bwd"]["err"], rows["local_bwd"]["s"] * 1e3,
                                  plain_ms["local_bwd"], bounds["local_bwd"], None),
        "kernel_body_favor": (ff_n + fb_n, favor_err, favor_s * 1e3, plain_ms["favor"],
                              bounds["favor"], None),
    }
    for name, (n, err, ms, pms, bound, lib) in out.items():
        print(f"[time] {name} (full body, B{B} x {H} heads x L{L} x d{D}, bf16): kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms; bound {bound[0]:.5f} ms ({bound[1]}); "
              f"library {'none' if lib is None else f'{lib:.4f} ms (SDPA, banded mask, fwd)'}; "
              f"max abs err vs plain at this shape {err:.3e}  [{smi}]")
    return out


def _check_validation(dev, smi):
    """Phase 17: ``tools/validate_fused_decode`` at its defaults with int8
    and with int4 weights: a 6L/d256 prior trained through rows 5 and 6,
    then the fused step (row 1, at widths no other phase gives it)
    against the exact path."""
    import torch

    from synthanatomy_tpu_torch.ops import favor_attention as fa
    from synthanatomy_tpu_torch.ops import fused_decode as fd
    from synthanatomy_tpu_torch.ops import local_attention_flash as lf
    from synthanatomy_tpu_torch.tools import validate_fused_decode

    for wq in ("int8", "int4"):
        fd.fused_decode_step.launches = 0
        fa.favor_attention_fused.launches = lf.local_attention_flash.launches = 0
        t0 = time.perf_counter()
        rec = validate_fused_decode.main(["--weight-quant", wq])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = (fd.fused_decode_step.launches, fa.favor_attention_fused.launches,
             lf.local_attention_flash.launches)
        _require(min(n) > 0, f"validate_fused_decode ({wq}) launches: fused step {n[0]}, "
                             f"favor {n[1]}, local {n[2]}")
        _require(rec["trained_ce"] < 2.0, f"validation prior did not train: CE "
                                          f"{rec['trained_ce']}")
        print(f"[validate] {wq} weights: {json.dumps(rec)}; launches: fused step {n[0]}, favor "
              f"{n[1]}, local {n[2]}; {dt:.1f} s  [{smi}]")


# phase 18: the stage-1 CLI at paper width (README's stage-1 flags)
CLI_FLAGS = dict(
    no_levels=4, no_channels=256, num_embeddings=(2048,), embedding_dim=(32,), decay=(0.5,),
    loss="jukebox_perceptual", adversarial_component=True,
    downsample_parameters=((4, 2, 1, 1),) * 4, upsample_parameters=((4, 2, 1, 0, 1),) * 4,
    batch_size=3, eval_batch_size=3, training_epoch_length=2, checkpoint_every=1, eval_every=2,
    experiment_name="smoke", num_workers=8, prefetch_factor=4,
)
CLI_TRAIN, CLI_VAL = 6, 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _phantoms(root, n, seed):
    """n smooth int16 phantoms of VOLUME (a coarse seeded grid, trilinear
    zoom: gzip takes seconds), written by the port's ``save_nifti``."""
    import numpy as np
    from scipy import ndimage

    from synthanatomy_tpu_torch.data.nifti import save_nifti

    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i in range(n):
        coarse = rng.uniform(0.0, 1000.0, size=tuple(s // 16 + 1 for s in VOLUME))
        vol = ndimage.zoom(coarse, 16, order=1)[tuple(slice(0, s) for s in VOLUME)]
        save_nifti(os.path.join(root, f"sub{i}.nii.gz"), vol.astype(np.int16))


def _trace_window(trace, first, last):
    """Host start of step ``first`` to the end of the device work that
    steps first..last launched, from the runner's Chrome trace: {"ms",
    "host_ms" (to the host end of step ``last``), "busy_ms" (the union of
    device intervals in the window), "by_kernel" ({name: device ms})}."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    steps = {e["name"]: e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("train#")}
    t0 = float(steps[f"train#{first}"]["ts"])
    host_end = float(steps[f"train#{last}"]["ts"]) + float(steps[f"train#{last}"]["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and t0 <= float(e["ts"]) <= host_end and "correlation" in e.get("args", {})}
    mine = [e for e in device if e.get("args", {}).get("correlation") in launched]
    _require(mine, "no device work correlated with the traced steps")
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in mine)
    spans = sorted((max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1))
                   for e in device if float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:  # the union of the device intervals
        if cur_e is None or a > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    by_kernel = {}
    for e in mine:
        if e.get("cat") == "kernel":
            by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + float(e["dur"]) / 1e3
    return {"ms": (t1 - t0) / 1e3, "host_ms": (host_end - t0) / 1e3, "busy_ms": busy / 1e3,
            "by_kernel": by_kernel}


@contextlib.contextmanager
def _stopwatch(spent, targets):
    """Wraps each (owner, attribute) in ``targets`` so that its calls add
    their wall seconds (the card synchronised after each) to
    ``spent[attribute]``."""
    import torch

    patches = []
    for owner, attr in targets:
        real = getattr(owner, attr)

        def timed(*a, _real=real, _attr=attr, **k):
            t0 = time.perf_counter()
            out = _real(*a, **k)
            torch.cuda.synchronize()
            spent[_attr] = spent.get(_attr, 0.0) + time.perf_counter() - t0
            return out

        patches.append(mock.patch.object(owner, attr, timed))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield spent


def _free_gib():
    import torch

    free, total = torch.cuda.mem_get_info()
    return (f"{free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB free, "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB held by the caching allocator")


def _check_cli(dev, smi, tmp):
    """Phase 18: ``synthanatomy_tpu_torch.run_vqvae`` trains (then resumes),
    extracts and decodes at paper width from NIfTI files, in the directory
    ``tmp`` (its experiments stay there for phase 19); then ``tools/bench``
    at the paper form.  Runs in a process of its own (``_run_phase``).
    Returns the CLI's ms per step."""
    import re

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from synthanatomy_tpu_torch import inferers, native
    from synthanatomy_tpu_torch.config import VQVAEConfig
    from synthanatomy_tpu_torch.data import nifti
    from synthanatomy_tpu_torch.data.nifti import load_nifti
    from synthanatomy_tpu_torch.ops import fused_decode as fd
    from synthanatomy_tpu_torch.ops import res_stack as rs
    from synthanatomy_tpu_torch.ops import vq
    from synthanatomy_tpu_torch.run_vqvae import run
    from synthanatomy_tpu_torch.runners import vqvae as runner
    from synthanatomy_tpu_torch.tools import bench
    from synthanatomy_tpu_torch.train import checkpoints as ckpt

    def _spent(spent):
        names = {"build_vqvae": "model build", "load_checkpoint": "checkpoint load",
                 "save_nifti": "NIfTI writes", "__call__": "the inferer's forward"}
        return ", ".join(f"{names[k]} {v:.1f} s" for k, v in spent.items())

    print(f"[cli] before the CLI: {_free_gib()}")
    t0 = time.perf_counter()
    train_dir, val_dir = os.path.join(tmp, "train"), os.path.join(tmp, "val")
    _phantoms(train_dir, CLI_TRAIN, 60)
    _phantoms(val_dir, CLI_VAL, 61)
    proj = os.path.join(tmp, "experiments")
    flags = dict(CLI_FLAGS, training_subjects=train_dir, project_directory=proj)
    print(f"[cli] {CLI_TRAIN} training and {CLI_VAL} validation phantoms {VOLUME} int16 "
          f"written in {time.perf_counter() - t0:.1f} s")

    # the loader alone: one epoch of the training set
    reader = "native (C++)" if native.native_available() else "Python (no g++/zlib)"
    loader = runner._make_loaders(VQVAEConfig(**flags), "training")["train"]
    t0 = time.perf_counter()
    n_loaded = sum(len(b["paths"]) for b in loader.epoch(0))
    load_s = time.perf_counter() - t0
    print(f"[cli] loader: {n_loaded / load_s:.3f} volumes/s over one epoch "
          f"({n_loaded} volumes, {CLI_FLAGS['num_workers']} threads, host augmentation "
          f"p 0.2), NIfTI reader: {reader}")

    # training, traced by the runner's own StepProfiler
    trace_dir = os.path.join(tmp, "trace")
    vq.nearest_codeword.launches = 0
    rs.fused_residual_layer.launches = rs.fused_residual_layer.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats()
    os.environ["SYNTHANATOMY_PROFILE_DIR"] = trace_dir
    try:
        t0 = time.perf_counter()
        out = run(mode="training", validation_subjects=val_dir, epochs=2, **flags)
        train_s = time.perf_counter() - t0
    finally:
        del os.environ["SYNTHANATOMY_PROFILE_DIR"]
    n = (vq.nearest_codeword.launches, rs.fused_residual_layer.launches,
         rs.fused_residual_layer.bwd_launches)
    _require(min(n) > 0, f"CLI training launches: argmin {n[0]}, residual fwd {n[1]}, "
                         f"bwd {n[2]}")
    hist = out["history"]
    _require(len(hist) == 2 and "Loss-Discriminator-Total" in hist[0]
             and all(np.isfinite(v) for h in hist for v in h.values()),
             f"CLI training history {hist}")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        trace = json.load(f)
    win = _trace_window(trace, 2, 3)
    all_names = _trace_window(trace, 0, 3)["by_kernel"]
    rows = {"3": r"vq_argmin_kernel", "7 forward": r"res_tile_fwd_kernel",
            "7 backward": r"res_tile_(dx|da|dw1)_kernel"}
    missing = [r for r, pat in rows.items() if not any(re.search(pat, k) for k in all_names)]
    _require(not missing, f"row(s) {missing} missing from the training trace; its kernels: "
                          f"{sorted(k[:60] for k in all_names)[:40]}")
    print(f"[cli] training: 2 epochs x 2 steps + eval ({train_s:.1f} s); history "
          f"{[{k: round(v, 5) for k, v in h.items() if k.startswith('Loss')} for h in hist]}"
          f"; launches argmin {n[0]}, residual fwd {n[1]}, bwd {n[2]}; trace holds "
          f"vq_argmin_kernel and res_tile_* kernels")
    print(f"[cli] training through the CLI, steps 3-4 (epoch 2): {win['ms'] / 2:.1f} ms per "
          f"step (host start of step 3 to the end of step 4's device work, loader and "
          f"host included; to step 4's host end {win['host_ms'] / 2:.1f}), device busy "
          f"{100 * win['busy_ms'] / win['ms']:.1f}% ({win['busy_ms'] / 2:.1f} ms a step); "
          f"the first call "
          f"(4 steps, eval, 2 checkpoints; cuDNN autotunes each new shape under "
          f"--cuda_benchmark, the CLI's default) took {train_s:.1f} s  [{smi}]")
    top = sorted(win["by_kernel"].items(), key=lambda kv: -kv[1])
    for name, ms in top[:10]:
        print(f"[cli]   {ms / 2:9.2f} ms a step  {name[:90]}")

    # the second call resumes from checkpoint_epoch=2
    out = run(mode="training", epochs=3, **flags)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ckdir = out["dirs"]["checkpoint_directory"]
    _require(len(out["history"]) == 1 and out["state"].step == 6,
             f"resume: {len(out['history'])} epochs, step {out['state'].step}")
    _require({"checkpoint_epoch=3", "model_state_dict_epoch=3.pt"} <= set(os.listdir(ckdir)),
             f"checkpoints {os.listdir(ckdir)}")
    sd = torch.load(os.path.join(ckdir, "model_state_dict_epoch=3.pt"), weights_only=True)
    _require(tuple(sd["quantizer.0.impl.embedding.weight"].shape) == (2048, 32),
             "codebook key")
    print(f"[cli] resume: epoch 3 from checkpoint_epoch=2 (step {out['state'].step}), "
          f"checkpoint_epoch=3 and model_state_dict_epoch=3.pt ({len(sd)} keys); peak "
          f"{peak:.2f} GiB over the training calls  [{smi}]")
    del out, sd
    torch.cuda.empty_cache()

    # extraction, under torch.profiler
    vq.nearest_codeword.launches = 0
    stages = [(runner, "build_vqvae"), (ckpt, "load_checkpoint"), (nifti, "save_nifti"),
              (inferers.VQVAEExtractionInferer, "__call__"),
              (inferers.VQVAEDecodingInferer, "__call__")]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            _stopwatch({}, stages) as spent:
        out = run(mode="extracting", **flags)
        torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    _require(vq.nearest_codeword.launches > 0, "extraction launched no argmin")
    _require(any("vq_argmin_kernel" in e.key for e in prof.key_averages()),
             "row 3 missing from the extraction trace")
    written = out["written"]
    grids = sorted(p for p in written if p.endswith("_quantization_0.npy"))
    recons = [p for p in written if p.endswith("_reconstruction.nii.gz")]
    maps = [p for p in written if p.endswith("_adversarial_loss.npy")]
    _require(len(grids) == len(recons) == len(maps) == CLI_TRAIN,
             f"extraction wrote {len(grids)} grids, {len(recons)} volumes, {len(maps)} maps")
    for g in grids:
        a = np.load(g)
        _require(a.dtype == np.uint16 and a.shape == GRID and int(a.max()) < 2048,
                 f"{g}: {a.dtype} {a.shape}")
    for r in recons:
        v = load_nifti(r, as_closest_canonical=False).data
        _require(v.shape == VOLUME and np.isfinite(v).all(), f"{r}: {v.shape}")
    print(f"[cli] extraction: {extract_s / CLI_TRAIN:.2f} s per volume ({CLI_TRAIN} volumes "
          f"in {extract_s:.1f} s; of which {_spent(spent)}), "
          f"{vq.nearest_codeword.launches} argmin launches  [{smi}]")

    # decoding two of the grids
    lat = os.path.join(tmp, "latents")
    os.makedirs(lat)
    for g in grids[:2]:
        os.link(g, os.path.join(lat, os.path.basename(g)))
    t0 = time.perf_counter()
    with _stopwatch({}, stages) as spent:
        out = run(mode="decoding", **dict(flags, training_subjects=lat))
    decode_s = time.perf_counter() - t0
    samples = [p for p in out["written"] if p.endswith("_sample.nii.gz")]
    _require(len(samples) == 2, f"decoding wrote {samples}")
    for p in samples:
        v = load_nifti(p, as_closest_canonical=False).data
        _require(v.shape == VOLUME and np.isfinite(v).all(), f"{p}: {v.shape}")
    print(f"[cli] decoding: {decode_s / 2:.2f} s per volume (2 volumes in {decode_s:.1f} s; "
          f"of which {_spent(spent)})  [{smi}]")
    del out
    torch.cuda.empty_cache()

    # tools/bench at the paper form: its JSON line, never the last line
    fd.fused_decode_step.launches = 0
    line = bench.main([])
    _require(fd.fused_decode_step.launches > 0, "tools/bench launched no fused step")
    _require(line["value"] > 0 and line["vs_baseline"] > 0, f"tools/bench {line}")
    print(f"[cli] tools/bench: {fd.fused_decode_step.launches} fused decode steps  [{smi}]")

    _check_device_augment(dev, smi, tmp, flags, win["ms"] / 2, win["busy_ms"] / win["ms"])
    return win["ms"] / 2


AUG_TOL = 1e-5  # card against CPU, away from the floor-flip voxels
NEAR_INT = 1e-5  # a sample position this close to an integer may floor either way


def _augment_params(seed, *, noise):
    """The host's drawn parameters for a B3 paper batch with every
    transform fired (p 1, strength 0: the production ranges)."""
    import numpy as np

    from synthanatomy_tpu_torch.data.transforms import VQVAETransform

    tf = VQVAETransform(augment=True, augmentation_probability=1.0)
    drawn = [tf.draw_device_params(VOLUME, np.random.default_rng(seed + i))[0]
             for i in range(VQ_BATCH)]
    params = {k: np.stack([d[k] for d in drawn]) for k in drawn[0]}
    if not noise:
        params["noise_fired"][:] = False
    return params, tf


def _near_integer(params, shifts, b, device):
    """Voxels of sample ``b`` whose sample position (the gather's three
    coordinates, or each pass's position) lies within ``NEAR_INT`` of an
    integer: there the floor, and the inside test, may flip."""
    import numpy as np
    import torch

    from synthanatomy_tpu_torch.ops import augment as A

    ii, jj, kk = A._grid(VOLUME, device)
    m = np.asarray(params["matrix"][b], np.float32)
    off = np.asarray(params["offset"][b], np.float32)
    rows = ([(m[r, 0], m[r, 1], m[r, 2], off[r]) for r in range(3)] if shifts is None
            else A._pass_coeffs(m, off))
    near = torch.zeros(VOLUME, dtype=torch.bool, device=device)
    for a_i, a_j, a_k, c in rows:
        p = float(a_i) * ii + float(a_j) * jj + float(a_k) * kk + float(c)
        near |= (p - torch.round(p)).abs() <= NEAR_INT
    return near


def _check_device_augment(dev, smi, tmp, flags, host_step_ms, host_busy):
    """Phase 18, device augmentation at paper width: ``augment_batch`` on
    the card against the CPU (both resamplers, noise off), the noise term,
    each resampler's ms per batch; then ``run_vqvae --device_augmentation``
    beside the host-augmented step, ``tools/bench_vqvae --device_augment``
    and ``tools/bench_dataloader``."""
    import numpy as np
    import torch

    from synthanatomy_tpu_torch.config import VQVAEConfig
    from synthanatomy_tpu_torch.ops import augment as A
    from synthanatomy_tpu_torch.ops import res_stack as rs
    from synthanatomy_tpu_torch.ops import vq
    from synthanatomy_tpu_torch.run_vqvae import run
    from synthanatomy_tpu_torch.runners import vqvae as runner
    from synthanatomy_tpu_torch.tools import bench_dataloader, bench_vqvae

    params, tf = _augment_params(70, noise=False)
    shifts = A.shear_shift_bounds(VOLUME, **tf.affine_ranges())
    x_cpu = torch.from_numpy(np.random.default_rng(71).uniform(size=(VQ_BATCH,) + VOLUME)
                             .astype(np.float32))
    x_dev = x_cpu.to(dev)
    for mode, sh in (("exact gather", None), ("3-pass", shifts)):
        t0 = time.perf_counter()
        want = A.augment_batch(x_cpu, params, sh)
        cpu_s = time.perf_counter() - t0
        got = A.augment_batch(x_dev, params, sh).cpu()
        diff = (got - want).abs()
        near = torch.stack([_near_integer(params, sh, b, "cpu") for b in range(VQ_BATCH)])
        far_err = float(diff[~near].max())
        _require(far_err <= AUG_TOL and bool(torch.isfinite(got).all()),
                 f"augment_batch ({mode}) card against CPU: max abs err {far_err:.3e} away from "
                 f"the floor-flip voxels, tol {AUG_TOL}")
        print(f"[augment] augment_batch ({mode}{'' if sh is None else f', shifts {sh}'}) B"
              f"{VQ_BATCH} x {VOLUME} f32, every transform fired, noise off: card against CPU "
              f"max abs err {far_err:.3e} (tol {AUG_TOL}) over the voxels whose sample position "
              f"is not within {NEAR_INT} of an integer; {int(near.sum())} such voxels (where the "
              f"floor may flip), max abs err there {float(diff[near].max()) if near.any() else 0:.3e}"
              f"; all voxels {float(diff.max()):.3e}; the CPU took {cpu_s:.1f} s")
    del want, got, diff, near

    # the noise term alone on a constant 0.5 volume: N(0, noise_std²)
    noise_p, _ = _augment_params(72, noise=True)
    for k in ("affine_fired", "contrast_fired", "shift_fired"):
        noise_p[k][:] = False
    term = A.augment_batch(torch.full((VQ_BATCH,) + VOLUME, 0.5, device=dev), noise_p) - 0.5
    std = float(noise_p["noise_std"][0])
    n = term[0].numel()
    for b in range(VQ_BATCH):
        mean, sd = float(term[b].double().mean()), float(term[b].double().std())
        _require(abs(mean) <= 5 * std / n ** 0.5 and abs(sd / std - 1) <= 0.01,
                 f"noise term of sample {b}: mean {mean:.3e}, std {sd:.5f}, want 0 and {std}")
    print(f"[augment] noise term on the card (seeded per sample): mean "
          f"{float(term.double().mean()):.2e}, std {float(term.double().std()):.5f} against "
          f"noise_std {std} over {VQ_BATCH} x {n} voxels")
    del term

    # ms per batch of each resampler, every transform fired (noise on)
    full, _ = _augment_params(73, noise=True)
    aug_ms = {}
    for mode, sh in (("exact gather", None), ("3-pass", shifts)):
        def call(sh=sh):
            return A.augment_batch(x_dev, full, sh)

        call()
        aug_ms[mode] = (_time_ms(call, 5), _device_ms(call, 5))
        print(f"[augment] {mode}: {aug_ms[mode][0]:.2f} ms per B{VQ_BATCH} batch elapsed, "
              f"{aug_ms[mode][1]:.2f} ms device time  [{smi}]")
    del x_dev, x_cpu
    torch.cuda.empty_cache()

    # the CLI with --device_augmentation: the loader alone, then 2 steps
    aug_flags = dict(flags, device_augmentation=True, experiment_name="smoke_devaug")
    loader = runner._make_loaders(VQVAEConfig(**aug_flags), "training")["train"]
    _require(loader.dataset.device_augment, "the training set ships no device parameters")
    t0 = time.perf_counter()
    n_loaded = sum(len(b["paths"]) for b in loader.epoch(0))
    load_s = time.perf_counter() - t0
    print(f"[augment] loader with device parameters only: {n_loaded / load_s:.3f} volumes/s "
          f"over one epoch ({n_loaded} volumes, {CLI_FLAGS['num_workers']} threads)")
    calls = []
    real = A.augment_batch

    def counting(x, p, sh=None):
        calls.append(sh)
        return real(x, p, sh)

    trace_dir = os.path.join(tmp, "trace_devaug")
    vq.nearest_codeword.launches = 0
    rs.fused_residual_layer.launches = rs.fused_residual_layer.bwd_launches = 0
    os.environ["SYNTHANATOMY_PROFILE_DIR"] = trace_dir
    try:
        with mock.patch.object(A, "augment_batch", counting):
            t0 = time.perf_counter()
            out = run(mode="training", epochs=2, **aug_flags)
            aug_s = time.perf_counter() - t0
    finally:
        del os.environ["SYNTHANATOMY_PROFILE_DIR"]
    n = (vq.nearest_codeword.launches, rs.fused_residual_layer.launches,
         rs.fused_residual_layer.bwd_launches)
    _require(min(n) > 0, f"device-augmented CLI step launches: argmin {n[0]}, residual fwd "
                         f"{n[1]}, bwd {n[2]}")
    _require(len(calls) == 4 and all(c == shifts for c in calls),
             f"augment_batch calls {calls}, want 4 on the 3-pass route {shifts}")
    hist = out["history"]
    _require(len(hist) == 2 and all(np.isfinite(v) for h in hist for v in h.values()),
             f"device-augmented training history {hist}")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        trace = json.load(f)
    win = _trace_window(trace, 2, 3)
    host = [_trace_window(trace, i, i)["host_ms"] for i in range(4)]
    print(f"[augment] run_vqvae --device_augmentation=True (2 epochs of 2 steps, p 0.2, the "
          f"3-pass route {shifts}, {aug_s:.1f} s; each step's host span "
          f"{', '.join(f'{h:.1f}' for h in host)} ms): {win['ms'] / 2:.1f} ms per step (steps "
          f"3-4, loader, augmentation and host included), device busy "
          f"{100 * win['busy_ms'] / win['ms']:.1f}%, against the host-augmented step "
          f"{host_step_ms:.1f} ms at {100 * host_busy:.1f}% busy (steps 3-4 above); launches "
          f"argmin {n[0]}, residual fwd {n[1]}, bwd {n[2]}  [{smi}]")
    for name, ms in sorted(win["by_kernel"].items(), key=lambda kv: -kv[1])[:6]:
        print(f"[augment]   {ms / 2:9.2f} ms a step  {name[:90]}")
    del out
    torch.cuda.empty_cache()

    # the bench's train step with the chain, at the CLI's batch, losses and
    # adversary, in this process (cuDNN's engines reused)
    res = bench_vqvae.main([f"--batch={VQ_BATCH}", "--adversarial", "--loss=jukebox_perceptual",
                            "--device_augment", "--recon=False"])
    _require(np.isfinite(res["train_loss"]), f"bench_vqvae {res}")
    torch.cuda.empty_cache()
    rates = bench_dataloader.main(["--n=4", f"--workers={CLI_FLAGS['num_workers']}"])
    _require(rates and all(r > 0 for r in rates.values()), f"bench_dataloader {rates}")


# phase 19: the prior's CLI and the synthesis tool on phase 18's latents,
# with the README's stage-2 flags at the paper form tools/bench runs
PRIOR_FLAGS = dict(
    vocab_size=2048, n_embd=512, n_layers=24, n_head=16, local_attn_heads=8,
    local_window_size=420, ordering_type="raster_scan", use_rezero=True,
    spatial_position_emb="absolute",
)
PRIOR_TRAIN, PRIOR_SAMPLE, PRIOR_DECODE = 12, 32, 4
# per prior train step: 24 layers x (row 5: 3 forward + 4 backward, row 6:
# 1 forward + 2 backward)
PRIOR_FAVOR_PER_STEP, PRIOR_LOCAL_PER_STEP = 24 * 7, 24 * 3


def _argv(**flags):
    """``run --flag=value ...`` as a user types it (tuples as literals)."""
    return ["run"] + [f"--{k}={v}" for k, v in flags.items()]


@contextlib.contextmanager
def _per_call(owner, attr, counters, calls, sync):
    """Wraps ``owner.attr`` (a function returning callables, or a method)
    so that each call of what it wraps appends (host start, wall s; the
    change of each counter) to ``calls``.  ``counters`` are (object,
    attribute) pairs read before and after.  With ``sync`` the card is
    synchronised around each call, so that the wall time is the call's;
    without it the host may run ahead, as it does in the unwrapped run."""
    import torch

    def read():
        return [getattr(o, a) for o, a in counters]

    def timed(fn):
        def run(*a, **k):
            if sync:
                torch.cuda.synchronize()
            before, t0 = read(), time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            calls.append((t0, time.perf_counter() - t0,
                          [x - y for x, y in zip(read(), before)]))
            return out
        return run

    real = getattr(owner, attr)
    if isinstance(owner, type):  # a method
        patch = timed(real)
    else:  # a factory: time what it returns
        def patch(*a, **k):
            return timed(real(*a, **k))
    with mock.patch.object(owner, attr, patch):
        yield calls


def _check_prior_cli(dev, smi, tmp):
    """Phase 19: ``synthanatomy_tpu_torch.run_transformer`` trains (then
    resumes) the paper prior on phase 18's extracted grids and samples
    from it; ``run_vqvae`` decodes samples with phase 18's stage-1
    checkpoint; ``tools/synthesize`` runs both experiments in one command.
    Each goes through ``cli.dispatch`` with the argv a user types.  Runs in
    a process of its own (``_run_phase``).  Returns its numbers."""
    import glob
    import re
    import shutil

    import numpy as np
    import torch

    from synthanatomy_tpu_torch import inferers
    from synthanatomy_tpu_torch.cli import dispatch
    from synthanatomy_tpu_torch.data import nifti
    from synthanatomy_tpu_torch.interop import export_performer_state_dict
    from synthanatomy_tpu_torch.models import sampling
    from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE
    from synthanatomy_tpu_torch.ops import favor_attention as fa
    from synthanatomy_tpu_torch.ops import fused_decode as fd
    from synthanatomy_tpu_torch.ops import local_attention_flash as lf
    from synthanatomy_tpu_torch.run_transformer import run as run_prior
    from synthanatomy_tpu_torch.run_vqvae import run as run_vqvae
    from synthanatomy_tpu_torch.runners import transformer as prunner
    from synthanatomy_tpu_torch.runners import vqvae as vrunner
    from synthanatomy_tpu_torch.tools import synthesize
    from synthanatomy_tpu_torch.train import checkpoints as ckpt
    from synthanatomy_tpu_torch.train import transformer_steps

    t_phase = time.perf_counter()
    proj = os.path.join(tmp, "experiments")
    grids = sorted(glob.glob(os.path.join(proj, "smoke", "baseline_vqvae", "outputs",
                                          "*_quantization_0.npy")))
    _require(len(grids) == CLI_TRAIN, f"phase 18 left {len(grids)} extracted grids")
    dirs = {}
    for name, n in (("train", PRIOR_TRAIN), ("sample", PRIOR_SAMPLE)):
        dirs[name] = os.path.join(tmp, f"prior_{name}")
        os.makedirs(dirs[name])
        for i in range(n):  # copies under new names
            shutil.copy(grids[i % len(grids)], os.path.join(dirs[name], f"lat{i:02d}.npy"))
    common = dict(project_directory=proj, experiment_name="smoke", num_workers=4, **PRIOR_FLAGS)
    train_flags = dict(common, mode="training", training_subjects=dirs["train"],
                       validation_subjects=dirs["train"], batch_size=TRAIN_BATCH,
                       eval_batch_size=TRAIN_BATCH, eval_every=2, checkpoint_every=1,
                       log_every=1)
    print(f"[prior] {PRIOR_TRAIN} training and {PRIOR_SAMPLE} sampling grids {GRID} copied from "
          f"phase 18's extraction")

    # training, traced by the runner's StepProfiler; each step's launches
    # read around the step
    counters = [(fa.favor_attention_fused, "launches"), (lf.local_attention_flash, "launches")]
    steps = []
    trace_dir = os.path.join(tmp, "prior_trace")
    torch.cuda.reset_peak_memory_stats()
    os.environ["SYNTHANATOMY_PROFILE_DIR"] = trace_dir
    try:
        with _per_call(transformer_steps, "make_transformer_train_step", counters, steps, False):
            t0 = time.perf_counter()
            out = dispatch({"run": run_prior}, _argv(**train_flags, epochs=2))
            train_s = time.perf_counter() - t0
    finally:
        del os.environ["SYNTHANATOMY_PROFILE_DIR"]
    hist = out["history"]
    _require(len(hist) == 2 and "val_Loss" in hist[1]
             and all(np.isfinite(v) for h in hist for v in h.values()),
             f"prior training history {hist}")
    per_step = {tuple(n) for _, _, n in steps}
    _require(len(steps) == 4 and per_step == {(PRIOR_FAVOR_PER_STEP, PRIOR_LOCAL_PER_STEP)},
             f"prior steps' launches (row 5, row 6): {[n for _, _, n in steps]}, want "
             f"{(PRIOR_FAVOR_PER_STEP, PRIOR_LOCAL_PER_STEP)} a step")
    with open(os.path.join(trace_dir, "trace.json")) as f:
        trace = json.load(f)
    win = _trace_window(trace, 2, 3)
    names = _trace_window(trace, 0, 3)["by_kernel"]
    rows = {"5": r"favor_(state|scan|fwd|dq|dkv)_kernel", "6": r"local_(fwd|bwd_dq|bwd_dkv)_kernel"}
    missing = [r for r, pat in rows.items() if not any(re.search(pat, k) for k in names)]
    _require(not missing, f"row(s) {missing} missing from the prior's trace")
    step_ms, busy = win["ms"] / 2, 100 * win["busy_ms"] / win["ms"]
    print(f"[prior] training: 2 epochs x 2 steps of B{TRAIN_BATCH} + eval ({train_s:.1f} s); "
          f"history {[{k: round(v, 5) for k, v in h.items()} for h in hist]}; launches a step "
          f"row 5 {PRIOR_FAVOR_PER_STEP} (24 x 7), row 6 {PRIOR_LOCAL_PER_STEP} (24 x 3) in all "
          f"4 steps; rows 5 and 6 in the trace")
    print(f"[prior] training through the CLI, steps 3-4 (epoch 2): {step_ms:.1f} ms per step (host "
          f"start of step 3 to the end of step 4's device work, loader and host included; to "
          f"step 4's host end {win['host_ms'] / 2:.1f}), device busy {busy:.1f}% "
          f"({win['busy_ms'] / 2:.1f} ms a step)  [{smi}]")
    for name, ms in sorted(win["by_kernel"].items(), key=lambda kv: -kv[1])[:8]:
        print(f"[prior]   {ms / 2:9.2f} ms a step  {name[:90]}")

    # the second call resumes from checkpoint_epoch=2, untraced
    resumed = []
    t0 = time.perf_counter()
    with _per_call(transformer_steps, "make_transformer_train_step", counters, resumed, False):
        out = dispatch({"run": run_prior}, _argv(**train_flags, epochs=3))
    resume_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ckdir = out["dirs"]["checkpoint_directory"]
    _require(len(out["history"]) == 1 and out["state"].step == 6,
             f"prior resume: {len(out['history'])} epochs, step {out['state'].step}")
    _require({"checkpoint_epoch=3", "model_state_dict_epoch=3.pt"} <= set(os.listdir(ckdir)),
             f"prior checkpoints {os.listdir(ckdir)}")
    sd = torch.load(os.path.join(ckdir, "model_state_dict_epoch=3.pt"), weights_only=True)
    want = export_performer_state_dict(out["state"].model)
    _require(list(sd) == list(want), "the raw export's keys are not export_performer_state_dict's")
    _require(tuple(sd["performer.net.layers.0.0.fn.fn.fast_attention.projection_matrix"].shape)
             == (256, 64), "projection key")
    print(f"[prior] resume: epoch 3 from checkpoint_epoch=2 (step {out['state'].step}, "
          f"{resume_s:.1f} s), checkpoint_epoch=3 and model_state_dict_epoch=3.pt ({len(sd)} "
          f"keys, export_performer_state_dict's); peak {peak:.2f} GiB over the training "
          f"calls  [{smi}]")
    # a host-bound loop issues steps at its step time: the pace between the
    # resumed steps' host starts (one sample; the batch's copy included)
    pace = 1e3 * (resumed[1][0] - resumed[0][0])
    print(f"[prior] untraced, host start of resumed step 5 to that of step 6: {pace:.1f} ms "
          f"(one sample)  [{smi}]")
    del out, sd, want
    torch.cuda.empty_cache()

    # sampling: 32 grids in two sampler calls of B16
    calls = []
    stages = [(prunner, "build_performer"), (ckpt, "load_checkpoint")]
    t0 = time.perf_counter()
    with _per_call(inferers.TransformerInferenceInferer, "__call__",
                   [(fd.fused_decode_step, "launches")], calls, True), \
            _stopwatch({}, stages) as spent:
        out = dispatch({"run": run_prior}, _argv(
            **common, mode="inference", training_subjects=dirs["sample"], eval_batch_size=BATCH,
            temperature=1.0, top_k=50))
    sample_s = time.perf_counter() - t0
    samples = sorted(p for p in out["written"] if p.endswith("_sample.npy"))
    _require(len(samples) == PRIOR_SAMPLE, f"sampling wrote {len(samples)} grids")
    for p in samples:
        a = np.load(p)
        _require(a.dtype == np.uint16 and a.shape == GRID and int(a.max()) < 2048,
                 f"{p}: {a.dtype} {a.shape} max {a.max()}")
    _require(len(calls) == PRIOR_SAMPLE // BATCH and all(n == [SEQ] for _, _, n in calls),
             f"sampler calls' row 1 launches {[n for _, _, n in calls]}, want {SEQ} each")
    call_s = [c for _, c, _ in calls]
    print(f"[prior] sampling through the CLI: {PRIOR_SAMPLE} uint16 grids {GRID} below 2048 in "
          f"{len(calls)} sampler calls of B{BATCH} (top-k 50), {SEQ} row 1 step launches each; "
          f"per call {call_s[0]:.3f} s (the first: capture and warm-up) and {call_s[1]:.3f} s "
          f"({BATCH * SEQ / call_s[1]:.1f} latent tok/s); the run {sample_s:.1f} s, of which "
          f"model build {spent.get('build_performer', 0):.1f} s, checkpoint load "
          f"{spent.get('load_checkpoint', 0):.1f} s  [{smi}]")
    del out
    torch.cuda.empty_cache()

    # decoding 4 samples with phase 18's stage-1 checkpoint
    dec_dir = os.path.join(tmp, "prior_decode")
    os.makedirs(dec_dir)
    for p in samples[:PRIOR_DECODE]:
        os.link(p, os.path.join(dec_dir, os.path.basename(p)))
    dstages = [(vrunner, "build_vqvae"), (ckpt, "load_checkpoint"), (nifti, "save_nifti"),
               (inferers.VQVAEDecodingInferer, "__call__")]
    t0 = time.perf_counter()
    with _stopwatch({}, dstages) as spent:
        out = dispatch({"run": run_vqvae}, _argv(**dict(
            CLI_FLAGS, mode="decoding", training_subjects=dec_dir, project_directory=proj)))
    decode_s = time.perf_counter() - t0
    vols = [p for p in out["written"] if p.endswith("_sample.nii.gz")]
    _require(len(vols) == PRIOR_DECODE, f"decoding wrote {vols}")
    for p in vols:
        v = nifti.load_nifti(p, as_closest_canonical=False).data
        _require(v.shape == VOLUME and np.isfinite(v).all(), f"{p}: {v.shape}")
    print(f"[prior] decoding the samples through run_vqvae: {decode_s / PRIOR_DECODE:.2f} s per "
          f"volume ({PRIOR_DECODE} volumes in {decode_s:.1f} s; model build "
          f"{spent.get('build_vqvae', 0):.1f} s, checkpoint load "
          f"{spent.get('load_checkpoint', 0):.1f} s, forward {spent.get('__call__', 0):.1f} s, "
          f"NIfTI writes {spent.get('save_nifti', 0):.1f} s)  [{smi}]")
    del out
    torch.cuda.empty_cache()

    # one-command synthesis from both experiments
    written_ok = []
    real_save = nifti.save_nifti

    def checked_save(path, data, affine=None):
        written_ok.append(tuple(data.shape) == VOLUME and bool(np.isfinite(data).all()))
        return real_save(path, data, affine)

    vq_net = {k: CLI_FLAGS[k] for k in ("no_levels", "no_channels", "num_embeddings",
                                        "embedding_dim", "downsample_parameters",
                                        "upsample_parameters")}
    sstages = [(sampling, "sample_fused"), (BaselineVQVAE, "decode_samples"),
               (nifti, "save_nifti")]
    synth_dir = os.path.join(tmp, "synthesis")
    fd.fused_decode_step.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(nifti, "save_nifti", checked_save), \
            _stopwatch({}, sstages) as spent:
        written = dispatch({"run": synthesize.run}, _argv(
            project_directory=proj, experiment_name="smoke", output_directory=synth_dir,
            latent_shape=GRID, num_volumes=BATCH, batch_size=BATCH, top_k=50,
            **PRIOR_FLAGS, **vq_net))
    synth_s = time.perf_counter() - t0
    _require(len(written) == BATCH and len(written_ok) == BATCH and all(written_ok),
             f"synthesis wrote {len(written)} volumes, finite and {VOLUME}: {written_ok}")
    _require(fd.fused_decode_step.launches == SEQ,
             f"synthesis launched row 1 {fd.fused_decode_step.launches} times, want {SEQ}")
    lat = sorted(glob.glob(os.path.join(synth_dir, "synth_*_latents.npy")))
    _require(len(lat) == BATCH and all(np.load(p).shape == GRID for p in lat), "synth latents")
    gen_s = sum(spent.get(k, 0.0) for k in ("sample_fused", "decode_samples", "save_nifti"))
    print(f"[prior] tools/synthesize: {BATCH} finite volumes {VOLUME} in {synth_s:.1f} s "
          f"({BATCH * 60 / synth_s:.1f} volumes/min with model builds and checkpoint loads; "
          f"{BATCH * 60 / gen_s:.1f} over sampling, decoding and writes): sampling "
          f"{spent.get('sample_fused', 0):.2f} s ({SEQ} row 1 launches), decoding "
          f"{spent.get('decode_samples', 0):.2f} s, NIfTI writes {spent.get('save_nifti', 0):.2f} "
          f"s  [{smi}]")
    _check_round_trip(smi, tmp, proj, dec_dir, dirs["sample"])
    phase_s = time.perf_counter() - t_phase
    print(f"[prior] phase 19 took {phase_s:.1f} s in its own process")
    return {"step_ms": step_ms, "busy": busy, "pace_ms": pace, "sample_call_s": call_s,
            "phase_s": phase_s}


VQ_NET_FLAGS = ("no_levels", "no_channels", "num_embeddings", "embedding_dim",
                "downsample_parameters", "upsample_parameters")


def _check_round_trip(smi, tmp, proj, dec_dir, sample_dir):
    """Phase 19's checkpoint round trip: phase 18's VQ-VAE and phase 19's
    prior exported to reference ``.pt`` files, converted back to ``.npz``
    and imported as ``checkpoint_epoch=0`` of a new experiment; every
    network tensor equal to the original's, and both CLIs load them."""
    import numpy as np
    import torch

    from synthanatomy_tpu_torch.cli import dispatch
    from synthanatomy_tpu_torch.data import nifti
    from synthanatomy_tpu_torch.ops import fused_decode as fd
    from synthanatomy_tpu_torch.run_transformer import run as run_prior
    from synthanatomy_tpu_torch.run_vqvae import run as run_vqvae
    from synthanatomy_tpu_torch.tools import (
        convert_checkpoint,
        convert_performer_checkpoint,
        export_checkpoint,
        import_checkpoint,
    )

    t0 = time.perf_counter()
    rt = os.path.join(tmp, "round_trip")
    os.makedirs(rt)
    imported = "smoke_import"
    target = [f"--project_directory={proj}", f"--experiment_name={imported}"]
    vq_argv = [f"--{k}={CLI_FLAGS[k]}" for k in VQ_NET_FLAGS]
    pr_argv = [f"--{k}={v}" for k, v in PRIOR_FLAGS.items()] + [f"--latent_shape={GRID}"]
    origin = {}
    for net, argv, convert, convert_argv in (
            ("baseline_vqvae", vq_argv, convert_checkpoint.main,
             ["--n_levels=4", "--n_res_layers=3"]),
            ("performer", pr_argv, convert_performer_checkpoint.main, ["--depth=24"])):
        src = os.path.join(proj, "smoke", net, "checkpoints", "checkpoint_epoch=3")
        pt, npz = os.path.join(rt, f"{net}.pt"), os.path.join(rt, f"{net}.npz")
        kind = "vqvae" if net == "baseline_vqvae" else "performer"
        export_checkpoint.main([kind, src, pt] + argv)
        convert([kind, pt, npz] + convert_argv if kind == "vqvae" else [pt, npz] + convert_argv)
        path = import_checkpoint.main([kind, npz] + target + argv)
        want = torch.load(src, map_location="cpu", weights_only=True)["model"]
        got = torch.load(path, map_location="cpu", weights_only=True)["model"]
        _require(list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want),
                 f"{net}: the imported network differs from checkpoint_epoch=3")
        origin[net] = len(want)
    rt_s = time.perf_counter() - t0
    print(f"[round trip] export -> convert -> import of phase 18's VQ-VAE and phase 19's prior "
          f"(checkpoint_epoch=3 -> reference .pt -> .npz -> {imported}/*/checkpoint_epoch=0): "
          f"{origin['baseline_vqvae']} and {origin['performer']} network tensors equal bit for "
          f"bit ({rt_s:.1f} s on the host)")

    # both CLIs load them: decoding phase 19's samples, sampling 16 grids
    out = dispatch({"run": run_vqvae}, _argv(**dict(
        CLI_FLAGS, mode="decoding", training_subjects=dec_dir, project_directory=proj,
        experiment_name=imported)))
    vols = sorted(p for p in out["written"] if p.endswith("_sample.nii.gz"))
    _require(len(vols) == PRIOR_DECODE, f"decoding through the imported VQ-VAE wrote {vols}")
    dmax = max(float(np.abs(
        nifti.load_nifti(p, as_closest_canonical=False).data
        - nifti.load_nifti(_output(proj, "smoke", "baseline_vqvae", p),
                           as_closest_canonical=False).data).max()) for p in vols)
    seed_dir = os.path.join(rt, "sample16")
    os.makedirs(seed_dir)
    for p in sorted(os.listdir(sample_dir))[:BATCH]:
        os.link(os.path.join(sample_dir, p), os.path.join(seed_dir, p))
    fd.fused_decode_step.launches = 0
    out = dispatch({"run": run_prior}, _argv(
        project_directory=proj, experiment_name=imported, num_workers=4, mode="inference",
        training_subjects=seed_dir, eval_batch_size=BATCH, temperature=1.0, top_k=50,
        **PRIOR_FLAGS))
    grids = sorted(p for p in out["written"] if p.endswith("_sample.npy"))
    _require(len(grids) == BATCH and fd.fused_decode_step.launches == SEQ,
             f"sampling through the imported prior: {len(grids)} grids, "
             f"{fd.fused_decode_step.launches} row 1 launches")
    same = np.mean([np.array_equal(np.load(p), np.load(_output(proj, "smoke", "performer", p)))
                    for p in grids])
    print(f"[round trip] run_vqvae decodes {len(vols)} samples through the imported VQ-VAE (max "
          f"abs difference from phase 19's decoding of the same grids {dmax:.3e}); "
          f"run_transformer samples {len(grids)} grids through the imported prior ({SEQ} row 1 "
          f"launches; {100 * same:.0f}% of the grids equal to the first call of phase 19's "
          f"sampling with the same seed)  [{smi}]")


def _output(proj, experiment, network, path):
    """The file of ``path``'s name among another experiment's outputs."""
    return os.path.join(proj, experiment, network, "outputs", os.path.basename(path))


# phase 20: the two-stage quality loop at its defaults
QUALITY_ROWS = {"1": ("fused_decode", "fused_decode_step", "launches"),
                "3": ("vq", "nearest_codeword", "launches"),
                "5": ("favor_attention", "favor_attention_fused", "launches"),
                "6": ("local_attention_flash", "local_attention_flash", "launches"),
                "7": ("res_stack", "fused_residual_layer", "launches")}


def _check_quality(dev, smi, tmp):
    """Phase 20: ``tools/quality_loop`` at its defaults on the card (JAX's
    bars: MS-SSIM 0.90, CE 1.0, half the grids distinct, every sample in
    the reconstructions' envelope), with the launches of the rows it
    reaches.  Runs in a process of its own (``_run_phase``)."""
    import importlib

    from synthanatomy_tpu_torch.models import vqvae as vqm
    from synthanatomy_tpu_torch.tools import quality_loop

    fns = {row: getattr(importlib.import_module(f"synthanatomy_tpu_torch.ops.{mod}"), fn)
           for row, (mod, fn, _) in QUALITY_ROWS.items()}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = quality_loop.main(["--workdir", os.path.join(tmp, "quality_loop")])
    wall = time.perf_counter() - t0
    n = {row: fn.launches for row, fn in fns.items()}
    notes = {}
    # the loop's largest residual-layer input: level 0, half the volume's side
    largest = (48 // 2) ** 3
    if n["7"] == 0:
        _require(largest < vqm._FUSED_MIN_VOXELS, "row 7 reached no launch at a size it takes")
        notes["7"] = (f"not reached: the fused residual layer runs on volumes of >= "
                      f"{vqm._FUSED_MIN_VOXELS} voxels (JAX's routing), and the loop's largest "
                      f"residual input is 24^3 = {largest}")
    missing = [row for row in ("1", "3", "5", "6") if n[row] == 0]
    _require(not missing, f"the quality loop launched no kernel of row(s) {missing}: {n}")
    print(f"[quality] tools/quality_loop at its defaults: VQ-VAE val MS-SSIM "
          f"{result['val_ms_ssim']} after {result['vq_epochs']} epochs (bar 0.90), prior val CE "
          f"{result['prior_val_ce']} after {result['prior_epochs']} epochs (bar 1.0), "
          f"{result['unique_grids']}/{result['n_samples']} distinct grids, "
          f"{result['samples_in_envelope']}/{result['n_samples']} samples in the envelope, "
          f"mean pairwise |d| {result['decoded_diversity']}; {wall:.1f} s  [{smi}]")
    print(f"[quality] launches: " + ", ".join(
        f"row {row} {n[row]}" + (f" ({notes[row]})" if row in notes else "")
        for row in sorted(n)))
    return {"result": result, "launches": n, "wall_s": wall}


# phase number and seconds before its child is killed (phase 20 took 44-62 s on
# an H100 80GB HBM3 at 700 W; the rest leaves room for 80 + 40 epochs)
PHASES = {"--cli-phase": (18, 600), "--prior-phase": (19, 600), "--quality-phase": (20, 300)}


def _run_phase(flag, root):
    """Runs phase 18, 19 or 20 in a child process (this script with
    ``flag`` and ``root``, the directory the phases share), its output on
    this one's; returns what the child wrote.  The child is killed if it
    outlives its phase's seconds in ``PHASES``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "phase.json")
        sys.stdout.flush()
        sys.stderr.flush()
        number, timeout = PHASES[flag]
        try:
            rc = subprocess.run([sys.executable, "-u", os.path.abspath(__file__), flag, root,
                                 result], timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"phase {number} outlived {timeout} s") from None
        _require(rc == 0, f"phase {number} exited with code {rc}")
        with open(result) as f:
            return json.load(f)


def _child_phase(flag, root, result):
    """The child's side of ``_run_phase``: phase 18, 19 or 20 on card 0,
    in ``root``; what it returns written to ``result``."""
    import torch

    sys.path.insert(0, REPO)
    check = {"--cli-phase": _check_cli, "--prior-phase": _check_prior_cli,
             "--quality-phase": _check_quality}[flag]
    with open(result, "w") as f:
        json.dump(check(torch.device("cuda", 0), _smi(), root), f)
    return 0


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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
    # cuDNN picks each convolution's engine by its heuristics in this
    # process (phase 18, which autotunes under the CLI's flags, has its own)
    torch.backends.cudnn.benchmark = False

    # 1. the card
    smi = _smi()
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.sources())} kernel libraries ready in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")
    for line in _build.ptxas_report().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    _check_sass()

    # 18-19. the stage-1 CLI and tools/bench, then the prior's CLI and the
    # synthesis tool on phase 18's experiments, each in a process of its own
    import tempfile

    with tempfile.TemporaryDirectory() as cli_root:
        cli_step_ms = _run_phase("--cli-phase", cli_root)
        prior = _run_phase("--prior-phase", cli_root)
    # 20. the two-stage quality loop, in a process of its own
    with tempfile.TemporaryDirectory() as quality_root:
        _run_phase("--quality-phase", quality_root)

    # 3. kernel against plain
    variants = [("int8", False, False), ("int8", False, True),
                ("int4", True, False), ("int4", True, True)]
    models = {}
    max_err = 0.0
    for shape_name, shape in (("paper", PAPER), ("small", SMALL)):
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
    performer, ordering = _performer(True, seed=0, device=dev, **PAPER)
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
    small_model, small_order = _performer(True, seed=5, device=dev, grid=SMALL_GRID, **SMALL)
    small_cpu = _performer(True, seed=5, device="cpu", grid=SMALL_GRID, **SMALL)[0]
    g_card = make_sampler(small_model, small_order, batch=2, do_sample=False,
                          ring_quant=True)(None).cpu()
    g_cpu = make_sampler(small_cpu, small_order, batch=2, do_sample=False,
                         ring_quant=True)(None)
    agree = float((g_card == g_cpu).float().mean())
    _require(agree >= 0.9, f"small greedy grids: kernel vs plain agreement {agree}")
    print(f"[check] small prior greedy grids, kernel (card) vs plain (CPU): "
          f"agreement {agree:.4f} over {g_cpu.numel()} codes")

    # 5. timings: row 1 at t 700, t on the card as the sampler's graph holds
    # it; elapsed (host-paced where its launches are slower to issue than
    # to run) and device time, beside the plain step and the bound
    from torch.profiler import ProfilerActivity, profile

    cfg = fd.FusedDecodeConfig(
        depth=24, batch=BATCH, dim=512, heads=16, dim_head=64, local_heads=8,
        local_window=420, nb_features=performer.nb_features, ring_quant=True,
        use_rezero=True)
    times, dev_times = {}, {}
    decode_bound = None
    t_dev = torch.tensor(700, device=dev)
    for wq in ("int8", "int4"):
        c = dataclasses.replace(cfg, weight_quant=wq)
        params = fd.strip_reference_weights(fd.pack_fused_params(performer, weight_quant=wq))
        st, h = _random_state(c, torch.Generator(device=dev).manual_seed(9), dev)
        if wq == "int8":  # what the step at t 700 reads and writes (_decode_step_bytes)
            n_weights = sum(t.numel() for t in params.values() if t.dtype == torch.int8)
            decode_bound = _bound(2 * BATCH * n_weights, _decode_step_bytes(params, st, h, c, 700),
                                  PEAK_BF16)

        def run():
            return fd.fused_decode_step(params, st, h, t_dev, c)

        def plain():
            return fd.fused_decode_step_ref(params, st, h, 700, c)

        # plain, kernel, kernel, plain (the card may drift within a call)
        p1, k1, d1 = _time_ms(plain, 5), _time_ms(run, 30), _device_ms(run, 30)
        d2, k2, p2 = _device_ms(run, 30), _time_ms(run, 30), _time_ms(plain, 5)
        times[wq] = ((k1 + k2) / 2, (p1 + p2) / 2)
        dev_times[wq] = (d1 + d2) / 2
        print(f"[time] row 1 decode step B{BATCH} paper width, {wq} weights, int8 rings, t 700: "
              f"elapsed {times[wq][0]:.4f} ms ({k1:.4f}, {k2:.4f}), device time "
              f"{dev_times[wq]:.4f} ms ({d1:.4f}, {d2:.4f}); plain {times[wq][1]:.3f} ms "
              f"({p1:.3f}, {p2:.3f}); bound {decode_bound[0]:.4f} ms ({decode_bound[1]}, "
              f"int8 weights)  [{smi}]")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = {}
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                dt = getattr(evt, "self_device_time_total", None)
                dt = evt.self_cuda_time_total if dt is None else dt
                n, ms = rows.get(evt.key, (0, 0.0))
                rows[evt.key] = (n + evt.count, ms + dt / 1e3)
        n_kernels = sum(n for n, _ in rows.values())
        busy = sum(ms for _, ms in rows.values())
        _require(n_kernels <= 5 * cfg.depth + 1,
                 f"one step made {n_kernels} kernel launches, more than 5 L + 1 = "
                 f"{5 * cfg.depth + 1}")
        print(f"[profile] row 1, one step ({wq} weights): {n_kernels} kernel launches per token "
              f"(5 L + 1 = {5 * cfg.depth + 1}), kernel durations summed {busy:.4f} ms (each "
              f"launch starts before the one ahead ends, so they overlap; the step's time is "
              f"the device time above: the profiler stretches it)  [{smi}]")
        for key, (n, ms) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
            print(f"[profile]   {ms:8.4f} ms {100 * ms / busy:5.1f}%  {n:4d} x  {key[:80]}")
        del params, st

    # a token of the fused sampler: one graph replay
    from synthanatomy_tpu_torch.models.sampling import fused_logits_stepper

    tok = torch.full((BATCH,), 5, dtype=torch.long, device=dev)
    with torch.no_grad():
        step = fused_logits_stepper(performer, batch=BATCH, ring_quant=True)
        for t in range(3):  # t 0 and 1 eagerly, the capture at t 1, t 2 the first replay
            step(tok, t)
        ms = _time_ms(lambda: step(tok, 3), 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(tok, 3)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_cuda_time_total if getattr(e, "self_device_time_total", None)
                   is None else e.self_device_time_total for e in rows) / 1e3
        print(f"[profile] fused sampler token B{BATCH} (int8 weights, int8 rings), CUDA-graph "
              f"replay: {ms:.4f} ms per token (CUDA events), {sum(e.count for e in rows)} "
              f"kernels, kernel durations summed {busy:.4f} ms (they overlap)  [{smi}]")
    del step
    fused_s = {}
    for wq in ("int8", "int4"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samplers[wq](gen)
        torch.cuda.synchronize()
        dt = fused_s[wq] = time.perf_counter() - t0
        print(f"[time] sampling B{BATCH}, {wq} weights, int8 rings, one CUDA graph per token: "
              f"{dt:.3f} s per "
              f"call, {BATCH * SEQ / dt:.1f} latent tok/s  [{smi}]")
    cli_s = prior["sample_call_s"][1]
    print(f"[prior] the CLI's second sampler call (phase 19, its own process, top-k 50) "
          f"{cli_s:.3f} s, {BATCH * SEQ / cli_s:.1f} latent tok/s, against phase 5's int8 call "
          f"{fused_s['int8']:.3f} s in this run  [{smi}]")
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
    # row 5's launches a layer at the paper shape, from the library's plan
    favor_per_step = 24 * fa.launches_per_call(
        torch.empty(1, 1, 1, 64, dtype=torch.bfloat16, device=dev),
        model.blocks[0].attn.projection, model.blocks[0].attn.scan_chunk)
    for name, got, want in (("favor", train_launches["favor"], TRAIN_STEPS * favor_per_step),
                            ("local", train_launches["local"], TRAIN_STEPS * LAUNCHES_PER_STEP)):
        _require(got == want, f"{name} kernel: {got} launches in {TRAIN_STEPS} steps, "
                              f"want {want}")
    _require(not torch.equal(proj0, model.blocks[0].attn.projection), "no redraw")
    _, ev = make_transformer_eval_step(model)(state, inputs, targets)
    final = float(ev["Loss"])
    _require(all(np.isfinite(losses)) and np.isfinite(final), f"losses {losses} {final}")
    _require(final < losses[0], f"loss did not fall: {losses} then {final}")
    print(f"[train] paper prior B{TRAIN_BATCH} x {SEQ} tokens, bf16, {TRAIN_STEPS} steps "
          f"(redraw every 2): losses {[round(x, 4) for x in losses]}, after {final:.4f}; "
          f"launches per step favor {train_launches['favor'] // TRAIN_STEPS} (24 layers x 3 "
          f"fwd + 4 bwd), local {train_launches['local'] // TRAIN_STEPS} (24 layers x fwd + 2 "
          f"bwd)")

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
    print(f"[prior] the CLI's step (phase 19, its own process, loader and host included) "
          f"{prior['step_ms']:.1f} ms traced, device busy {prior['busy']:.1f}%, and "
          f"{prior['pace_ms']:.1f} ms untraced (resumed steps' pace), against phase 8's bare "
          f"step {step_k:.1f} ms in this run  [{smi}]")

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
    favor = _time_favor(smi, q, k, v, g, proj, pairs["favor"])
    ktimes["favor"] = (favor["fwd+bwd"]["ms"], favor["fwd+bwd"]["plain_ms"])
    local = _time_local(dev, smi, q, k, v, g, pairs["local"])
    ktimes["local"] = (local["fwd+bwd"]["ms"], local["fwd+bwd"]["plain_ms"])

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

    # bounds of the training kernels at the timed shape; the library call
    # beside local attention: SDPA with the banded causal mask
    favor_bound = favor["fwd+bwd"]["bound"]
    local_bound, sdpa_ms = local["fwd+bwd"]["bound"], local["fwd+bwd"]["library_ms"]
    print(f"[time] bounds: favor {favor_bound[0]:.4f} ms ({favor_bound[1]}), local "
          f"{local_bound[0]:.4f} ms ({local_bound[1]})  [{smi}]")
    del state, model, train_step, q, k, v, g, prof
    torch.cuda.empty_cache()

    # 9. the stage-1 kernels against their plain versions
    verr = _check_vq_kernels(dev)
    rerr = _check_res_kernels(dev)
    torch.cuda.empty_cache()
    # 10-11. the paper stage 1, then the kernels' timings
    print(f"[mem] before phase 10: {_free_gib()}")
    s1 = _check_stage1(dev, smi)
    print(f"[cli] the CLI's step (phase 18, its own process, cuDNN autotuned) {cli_step_ms:.1f} "
          f"ms against phase 11's bare step (cuDNN heuristics) {s1['step'][0]:.1f} ms in this "
          f"run  [{smi}]")
    t1 = _time_stage1_kernels(dev, smi)
    torch.cuda.empty_cache()
    # 12-13. the splash kernels, then the bench entry point through them
    serr = _check_splash(dev)
    sb = _check_bench(dev, smi)
    torch.cuda.empty_cache()
    # 14-15. the exact decode path, then row 2 and the probes
    _check_exact_decode(dev, smi, fused_s)
    torch.cuda.empty_cache()
    ds = _check_decode_side(dev, smi)
    torch.cuda.empty_cache()
    # 16-17. row 9d through the kernel-body probe; the fused step validated
    # on a trained prior
    ds.update(_check_kernel_body(dev, smi))
    torch.cuda.empty_cache()
    _check_validation(dev, smi)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms=None,
              dev_ms=None):
        path = replaces if replaces.startswith("tools/") else f"synthanatomy_tpu/ops/{replaces}"
        rec = {"name": name, "route": "cuda", "source": f"synthanatomy_tpu_torch/csrc/{source}",
               "replaces": path, "launches": launches,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
               "bound_by": bound[1], "library_ms": library_ms}
        if dev_ms is not None:
            rec["dev_ms"] = dev_ms
        return rec

    print(json.dumps({"kernels": [
        entry("fused_decode_step", "fused_decode.cu", "fused_decode.py:541", launches, max_err,
              *times["int8"], decode_bound),
        entry("favor_attention_fused", "favor_attention.cu", "favor_pallas.py:148",
              train_launches["favor"], kerr["favor"], *ktimes["favor"], favor_bound),
        entry("local_attention_flash", "local_attention.cu", "local_attention_pallas.py:128",
              train_launches["local"], kerr["local"], *ktimes["local"], local_bound, sdpa_ms),
        entry("nearest_codeword", "vq_argmin.cu", "vq.py:103", s1["launches"]["argmin"],
              verr["argmin"], t1["argmin"]["ms"], t1["argmin"]["plain_ms"],
              (t1["argmin"]["bound_ms"], t1["argmin"]["bound_by"]),
              dev_ms=t1["argmin"]["dev_ms"]),
        entry("nearest_codeword_stats", "vq_argmin.cu", "vq.py:176", s1["stats_launches"],
              verr["stats"], t1["stats"]["ms"], t1["stats"]["plain_ms"],
              (t1["stats"]["bound_ms"], t1["stats"]["bound_by"]), dev_ms=t1["stats"]["dev_ms"]),
        entry("fused_residual_layer", "res_stack.cu", "res_stack_pallas.py:116",
              s1["launches"]["fwd"], rerr["fwd"], t1["res_fwd"]["ms"], t1["res_fwd"]["plain_ms"],
              (t1["res_fwd"]["bound_ms"], t1["res_fwd"]["bound_by"])),
        entry("fused_residual_layer_bwd", "res_stack.cu", "res_stack_pallas.py:271",
              s1["launches"]["bwd"], rerr["bwd"], t1["res_bwd"]["ms"], t1["res_bwd"]["plain_ms"],
              (t1["res_bwd"]["bound_ms"], t1["res_bwd"]["bound_by"])),
        entry("local_attention_splash", "local_attention_splash.cu",
              "local_attention_splash.py:91", sb["launches"], serr, sb["ms"], sb["plain_ms"],
              sb["bound"], sb["sdpa_ms"]),
        *[entry(name, src, rep_, *ds[name]) for name, src, rep_ in (
            ("int8_matmul", "int8_matmul.cu", "quant.py:103"),
            ("weight_stream_int8", "weight_stream.cu", "tools/probe_int4.py:49"),
            ("weight_stream_int4", "weight_stream.cu", "tools/probe_int4.py:108"),
            ("int4_unpack", "int4_unpack.cu", "tools/probe_int4_unpack.py:142"),
            ("launch_overhead", "launch_overhead.cu", "tools/probe_pallas_overhead.py:48"),
            ("kernel_body_local_fwd", "local_attention.cu", "tools/probe_kernel_body.py:93"),
            ("kernel_body_local_bwd", "local_attention.cu", "tools/probe_kernel_body.py:168"),
            ("kernel_body_favor", "favor_attention.cu", "tools/probe_kernel_body.py:264"))],
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in PHASES:
        sys.exit(_child_phase(*sys.argv[1:4]))
    sys.exit(main())

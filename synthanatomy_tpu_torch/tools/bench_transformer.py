"""Stage-2 (Performer prior) training-throughput bench and ablations.

Port of ``tools/bench_transformer.py``, with the same flags and
defaults: the paper prior, 24 layers, d512, 16 heads (8 local, window
420) over 1401-token sequences (1400 latents + BOS), vocab 2048, batch
6, remat of the attention sub-blocks unless ``--no-remat`` or
``--reversible``.  Measures ms/step and tokens/s on the card; timing
ends with ``torch.cuda.synchronize()``.

    python -m synthanatomy_tpu_torch.tools.bench_transformer                 # paper config
    python -m synthanatomy_tpu_torch.tools.bench_transformer --splash-local \\
        --pallas-favor --use-rezero --spatial-emb absolute --attn-dtype bfloat16
    python -m synthanatomy_tpu_torch.tools.bench_transformer --cpu --depth 1 ...  # sanity run

``--splash-local`` routes the local heads through the splash kernel
(``ops/local_attention_splash.py``) the way the JAX bench does: it
rebinds ``models.performer.local_attention_flash``, which
``PerformerAttention.forward`` looks up at call time, for the length of
the run.  ``--pallas-local`` / ``--pallas-favor`` take the port's banded
local and FAVOR+ kernels.  Runs on the card; ``--cpu`` runs on the host,
for sanity runs only.  ``main`` returns what it printed as a dict.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import time

import numpy as np
import torch

PEAK_BF16_TFLOPS = 989.0  # NVIDIA H100 SXM, dense bf16


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=6)
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--local-heads", type=int, default=8)
    p.add_argument("--window", type=int, default=420)
    p.add_argument("--seq", type=int, default=1400)
    p.add_argument("--vocab", type=int, default=2048)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--scan-chunk", type=int, default=128)
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--pallas-local", action="store_true")
    p.add_argument("--pallas-favor", action="store_true")
    p.add_argument("--splash-local", action="store_true",
                   help="route the local heads through the splash kernel "
                        "(ops/local_attention_splash.py)")
    p.add_argument("--splash-block", type=int, default=256,
                   help="splash block_q=block_kv (padded seq rounds up)")
    p.add_argument("--splash-fused-bwd", action="store_true",
                   help="use splash's fused dq/dkv backward")
    p.add_argument("--reversible", action="store_true")
    p.add_argument("--use-rezero", action="store_true",
                   help="paper block form (reference README.md:140)")
    p.add_argument("--spatial-emb", default=None, choices=["fixed", "absolute"],
                   help="spatial coordinate embeddings (paper: absolute)")
    p.add_argument("--grid", default="10,14,10",
                   help="latent grid for --spatial-emb (prod == --seq)")
    p.add_argument("--attn-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="internal attention matmul dtype (fp32 accumulate)")
    p.add_argument("--fwd-only", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host CPU, for config sanity runs only")
    return p.parse_args(argv)


def _device(args) -> torch.device:
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible: the bench runs on the card "
                           "(pass --cpu for a sanity run on the host)")
    return torch.device("cuda", 0)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def local_route(args):
    """With ``--splash-local``, the local heads' kernel call site bound to
    the splash kernel for the length of the block (and ``args.pallas_local``
    set, as the JAX bench sets it)."""
    if not args.splash_local:
        yield
        return
    from synthanatomy_tpu_torch.models import performer as perf_mod
    from synthanatomy_tpu_torch.ops.local_attention_splash import local_attention_splash

    banded = perf_mod.local_attention_flash
    perf_mod.local_attention_flash = functools.partial(
        local_attention_splash, block_q=args.splash_block, block_kv=args.splash_block,
        use_fused_bwd=args.splash_fused_bwd)
    args.pallas_local = True
    try:
        yield
    finally:
        perf_mod.local_attention_flash = banded


def build_model(args, dev):
    """The bench's Performer on ``dev``, from seed 0."""
    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer

    L = args.seq + 1  # + BOS
    sp_grid = sp_ordering = None
    if args.spatial_emb:
        sp_grid = tuple(int(s) for s in args.grid.split(","))
        if int(np.prod(sp_grid)) != args.seq:
            raise ValueError(f"--grid {sp_grid} must hold --seq {args.seq} latents")
        sp_ordering = Ordering("raster_scan", 3, sp_grid)
    attn_dtype = torch.bfloat16 if args.attn_dtype == "bfloat16" else torch.float32
    return Performer(
        num_tokens=args.vocab + 1, max_seq_len=L, dim=args.dim, depth=args.depth,
        heads=args.heads, dim_head=64, local_attn_heads=args.local_heads,
        local_window_size=args.window, scan_chunk=args.scan_chunk,
        remat_attention=not (args.no_remat or args.reversible), reversible=args.reversible,
        use_pallas_local=args.pallas_local or args.splash_local,
        use_pallas_favor=args.pallas_favor, attn_compute_dtype=attn_dtype,
        use_rezero=args.use_rezero, spatial_position_emb=args.spatial_emb,
        spatial_shape=sp_grid, ordering=sp_ordering, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0), device=dev,
    )


def batch(args, dev):
    """(inputs, targets): seeded tokens and their next-token shift."""
    x = np.random.default_rng(0).integers(0, args.vocab, (args.batch, args.seq + 1))
    inputs = torch.as_tensor(x, dtype=torch.long, device=dev)
    targets = torch.as_tensor(np.roll(x, -1, axis=1), dtype=torch.long, device=dev)
    return inputs, targets


def main(argv=None) -> dict:
    from synthanatomy_tpu_torch.train.transformer_steps import (
        create_transformer_train_state,
        make_transformer_train_step,
    )

    args = parse_args(argv)
    dev = _device(args)
    with local_route(args):
        if args.splash_local:
            print(f"local heads -> splash kernel (block={args.splash_block}, "
                  f"fused_bwd={args.splash_fused_bwd})")
        model = build_model(args, dev)
        state = create_transformer_train_state(model, seed=0)
        inputs, targets = batch(args, dev)
        L = args.seq + 1
        n_params = sum(p.numel() for p in model.parameters())
        print(f"params: {n_params / 1e6:.1f}M")
        out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "n_params": n_params}

        if args.fwd_only:
            model.eval()

            @torch.no_grad()
            def fwd():
                return model(inputs).float().mean()

            t0 = time.perf_counter()
            val = fwd()
            _sync(dev)
            print(f"first call: {time.perf_counter() - t0:.1f}s")
            for _ in range(args.warmup):
                fwd()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                val = fwd()
            _sync(dev)
            dt = (time.perf_counter() - t0) / args.steps
            print(f"fwd-only on {out['device']}: {dt * 1e3:.1f} ms/step")
            out.update(fwd_ms=dt * 1e3, value=float(val))
            return out

        step = make_transformer_train_step(model)
        sched = {"lr": 1e-4}
        losses = []
        t0 = time.perf_counter()
        state, metrics = step(state, inputs, targets, None, sched)
        losses.append(metrics["Loss"])
        _sync(dev)
        print(f"first step: {time.perf_counter() - t0:.1f}s")
        for _ in range(args.warmup):
            state, metrics = step(state, inputs, targets, None, sched)
            losses.append(metrics["Loss"])
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = step(state, inputs, targets, None, sched)
            losses.append(metrics["Loss"])
        _sync(dev)
        dt = (time.perf_counter() - t0) / max(args.steps, 1)
        toks = args.batch * L / dt
        print(f"train on {out['device']}: {dt * 1e3:.1f} ms/step  {toks / 1e3:.1f}k tok/s  "
              f"(b={args.batch} L={L} depth={args.depth} local={args.local_heads} "
              f"chunk={args.scan_chunk} remat={not args.no_remat} "
              f"attn_dtype={args.attn_dtype})")
        out.update(ms_per_step=dt * 1e3, tok_per_s=toks, losses=[float(x) for x in losses])
        if dev.type == "cuda":
            # rough utilisation line: 6·P·tokens FLOPs per train step
            out["model_tflops"] = 6 * n_params * args.batch * L / dt / 1e12
            print(f"model-FLOPs util: {out['model_tflops']:.1f} TFLOP/s "
                  f"(peak H100 bf16 {PEAK_BF16_TFLOPS:g})")
        return out


if __name__ == "__main__":
    main()

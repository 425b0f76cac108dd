"""Headline benchmark — AR prior sampling throughput (latent tokens/s).

The port's counterpart of the top-level ``bench.py``: the paper's
Performer (24 layers / d512 / 16 heads of 64, 8 of them local with
window 420, ReZero blocks, learned spatial tables, vocab 2049, the
10×14×10 = 1400-token raster grid; reference README.md:106-141) with
seeded weights, on one CUDA card.

- measured: ``make_sampler(..., batch=16, fused="auto", ring_quant=True,
  weight_quant="int4")``, the fused decode step (``csrc/fused_decode.cu``,
  one CUDA graph a token), 3 calls after a warm-up call.  There is no
  fallback: if the fused step does not cover the prior or fails, the
  run fails;
- baseline: the reference's sampling algorithm — a full forward over
  the sequence per generated token with NO cache (reference
  src/networks/transformers/transformer.py:84-93), its attention on the
  FAVOR+ and local-attention kernels — on the same card, 60 steps after
  4 warm-up steps, extrapolated to the whole grid, so ``vs_baseline`` is
  the algorithmic speedup on the same hardware.

Prints exactly one JSON line with bench.py's keys (``metric``, ``value``,
``unit``, ``vs_baseline``); ``main`` returns it as a dict.  On the card:
``python -m synthanatomy_tpu_torch.tools.bench``, which measures the paper
form (``PAPER``) and nothing else; ``--cpu`` is a sanity run of a tiny
prior (``SANITY``) on the host, its form named in ``unit``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

METRIC = "ar_sampling_tokens_per_sec_paper24L"


# the paper's prior and the measurement bench.py makes of it
PAPER = dict(batch=16, depth=24, dim=512, heads=16, local_heads=8, window=420,
             grid=(10, 14, 10), vocab=2048, reps=3, naive_warmup=4, naive_steps=60)
# the host's sanity run: the same code path at a tiny prior
SANITY = dict(batch=2, depth=1, dim=128, heads=2, local_heads=1, window=6, grid=(2, 3, 4),
              vocab=17, reps=1, naive_warmup=1, naive_steps=2)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true",
                   help="a sanity run of a tiny prior on the host (plain versions of the "
                        "kernels)")
    return p.parse_args(argv)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer
    from synthanatomy_tpu_torch.models.sampling import make_sampler, sample_next_index

    cpu = parse_args(argv).cpu
    if cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    else:
        raise RuntimeError("no CUDA card visible: the bench runs on the card "
                           "(pass --cpu for a sanity run on the host)")
    args = argparse.Namespace(**(SANITY if cpu else PAPER))
    grid = args.grid
    seq = int(np.prod(grid))
    bos = args.vocab
    ordering = Ordering("raster_scan", 3, grid)
    # the paper's block and embedding form (ReZero + learned spatial
    # tables), which the fused step covers
    model = Performer(
        num_tokens=args.vocab + 1, max_seq_len=seq + 1, dim=args.dim, depth=args.depth,
        heads=args.heads, dim_head=64, local_attn_heads=args.local_heads,
        local_window_size=args.window, use_rezero=True, spatial_position_emb="absolute",
        spatial_shape=grid, ordering=ordering, use_pallas_local=True,
        use_pallas_favor=True, attn_compute_dtype=torch.bfloat16, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0), device=dev,
    )
    model.eval()

    # ---- fused sampler ----------------------------------------------------
    sampler = make_sampler(model, ordering, batch=args.batch, temperature=1.0,
                           fused="auto", ring_quant=True, weight_quant="int4")
    if not sampler.fused:
        raise RuntimeError("the fused decode step does not cover the bench's prior")
    gen = torch.Generator(device=dev).manual_seed(2)
    sampler(gen)  # warm-up: packing, graph capture
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        grid_out = sampler(gen)
    _sync(dev)
    fast_dt = (time.perf_counter() - t0) / args.reps
    if tuple(grid_out.shape) != (args.batch, *grid):
        raise RuntimeError(f"sampler returned {tuple(grid_out.shape)}")
    fast_tps = args.batch * seq / fast_dt

    # ---- reference-algorithm baseline (same card) -------------------------
    @torch.no_grad()
    def naive_step(tokens, t, g):
        logits = model(tokens[:, :-1])[:, t]
        tokens[:, t + 1] = sample_next_index(logits, temperature=1.0, sample=True,
                                             generator=g)
        return tokens

    tokens = torch.full((args.batch, seq + 1), bos, dtype=torch.long, device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    for t in range(args.naive_warmup):
        tokens = naive_step(tokens, t, g)
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(args.naive_warmup, args.naive_warmup + args.naive_steps):
        tokens = naive_step(tokens, t, g)
    _sync(dev)
    naive_per_step = (time.perf_counter() - t0) / args.naive_steps
    naive_tps = args.batch / naive_per_step  # a step's cost does not depend on t

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {
        "metric": METRIC,
        "value": round(fast_tps, 1),
        "unit": f"latent tokens/s on one {name} (batch {args.batch}, "
                f"{args.depth}L/d{args.dim}/{args.heads}h Performer, {seq}-token grid)",
        "vs_baseline": round(fast_tps / naive_tps, 2),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""Fused-decode weight-stream ablation: int8 against packed-int4 weights.

Port of ``tools/bench_decode_quant.py``, with its flag (``--batches``):
the paper sampler (24L/d512/16h, 8 local heads of window 420, ReZero,
learned spatial tables, 1400-token 10×14×10 grid, int8 rings, seeded
random weights) through ``make_sampler(fused=True)`` at each serving
batch, with both weight formats; prints latent tok/s and µs per step,
timed on the host clock around whole sampler calls ended by
``torch.cuda.synchronize()``.

    python -m synthanatomy_tpu_torch.tools.bench_decode_quant [--batches 8,16]
    python -m synthanatomy_tpu_torch.tools.bench_decode_quant --cpu --depth 1 \\
        --dim 128 --heads 2 --local-heads 1 --window 6 --grid 2,3,2 --batches 2 --reps 1

``main`` returns {(batch, weights): tok/s}.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from synthanatomy_tpu_torch.models.ordering import Ordering
from synthanatomy_tpu_torch.models.performer import Performer
from synthanatomy_tpu_torch.models.sampling import make_sampler
from synthanatomy_tpu_torch.tools._probe_util import device_name, probe_device


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batches", default="8,16")
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the host")
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--local-heads", type=int, default=8)
    p.add_argument("--window", type=int, default=420)
    p.add_argument("--grid", default="10,14,10")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    dev = probe_device(args.cpu)
    grid = tuple(int(g) for g in args.grid.split(","))
    seq = int(np.prod(grid))
    ordering = Ordering("raster_scan", 3, grid)
    model = Performer(
        num_tokens=2049, max_seq_len=seq + 1, dim=args.dim, depth=args.depth,
        heads=args.heads, dim_head=64, local_attn_heads=args.local_heads,
        local_window_size=args.window, use_rezero=True, spatial_position_emb="absolute",
        spatial_shape=grid, ordering=ordering, dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0), device="cpu",
    ).to(dev)
    print(f"device: {device_name(dev)}")
    out = {}
    for b in (int(x) for x in args.batches.split(",")):
        for wq in ("int8", "int4"):
            sampler = make_sampler(model, ordering, batch=b, temperature=1.0, fused=True,
                                   ring_quant=True, weight_quant=wq)
            sampler(torch.Generator(device=dev).manual_seed(2))  # warm
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(args.reps):
                sampler(torch.Generator(device=dev).manual_seed(3 + i))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / args.reps
            out[(b, wq)] = b * seq / dt
            print(f"B={b:3d} weights={wq}: {out[(b, wq)]:8.0f} tok/s "
                  f"({dt / seq * 1e6:.0f} us/step)", flush=True)
    return out


if __name__ == "__main__":
    main()

"""Micro-bench of the banded local-attention kernel at the paper shape
(B6, 8 local heads, w 420, L 1401, d 64), forward or forward + backward.

Port of ``tools/bench_local_kernel.py``, with its flags and printed line.
The JAX tool amortises its host's dispatch floor over a ``lax.scan``;
here ``--iters`` calls run between CUDA events (the host clock on the
CPU) after one warm call.  ``--variant`` names what the port has:
``current`` (row 6, ``ops/local_attention_flash``: the banded kernel),
``splash`` (row 8, ``ops/local_attention_splash``: the block-sparse
kernel) or ``plain`` (row 6's plain twin).  No rotary, as in the JAX
tool; the backward is d(Σ out²)/d(q, k, v) through autograd.

    python -m synthanatomy_tpu_torch.tools.bench_local_kernel [--variant current] \\
        [--iters 50] [--bwd]
    python -m synthanatomy_tpu_torch.tools.bench_local_kernel --cpu --batch 1 --heads 2 \\
        --seq 40 --d 16 --window 12 --iters 1

``main`` returns seconds per call.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from synthanatomy_tpu_torch.ops.local_attention_flash import (
    local_attention_flash,
    local_attention_flash_plain,
)
from synthanatomy_tpu_torch.ops.local_attention_splash import local_attention_splash
from synthanatomy_tpu_torch.tools._probe_util import device_name, elapsed_s, probe_device

VARIANTS = ("current", "splash", "plain")


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=6)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--window", type=int, default=420)
    p.add_argument("--seq", type=int, default=1401)
    p.add_argument("--d", type=int, default=64)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--bwd", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--variant", default="current", choices=VARIANTS)
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the host")
    args = p.parse_args(argv)
    dev = probe_device(args.cpu)
    print(f"device: {device_name(dev)}", file=sys.stderr)

    dt = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (args.batch, args.heads, args.seq, args.d)
    q, k, v = (torch.randn(*shape, generator=gen, device=dev).to(dt) for _ in range(3))

    def one(q, k, v):
        if args.variant == "splash":
            return local_attention_splash(q, k, v, window=args.window, use_rotary=False,
                                          compute_dtype=dt)
        if args.variant == "plain":
            return local_attention_flash_plain(q, k, v, args.window)
        return local_attention_flash(q, k, v, window=args.window, causal=True,
                                     use_rotary=False, compute_dtype=dt)

    if args.bwd:
        def run():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            loss = (one(*leaves).float() ** 2).sum()
            return torch.autograd.grad(loss, leaves)
    else:
        def run():
            with torch.no_grad():
                return one(q, k, v)

    t0 = time.time()
    run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"compile+1st: {time.time() - t0:.1f}s", file=sys.stderr)
    dt_s = elapsed_s(lambda: [run() for _ in range(args.iters)], dev) / args.iters
    kind = "fwd+bwd" if args.bwd else "fwd"
    print(f"{kind}: {dt_s * 1e3:.3f} ms/call "
          f"(b{args.batch} h{args.heads} w{args.window} L{args.seq})")
    return dt_s


if __name__ == "__main__":
    main()

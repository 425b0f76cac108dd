"""Micro-bench: one local-attention op at the paper shape, the plain path
against the banded kernel, forward and forward + backward.

Port of ``tools/bench_local_attn.py``, with its flags and printed lines.
"xla" is the port of the XLA path (``ops/local_attention.local_attention``,
plain PyTorch), "pallas" the banded kernel of row 6
(``ops/local_attention_flash.local_attention_flash``,
``csrc/local_attention.cu``), both with rotary phases and bf16
products.  Each time is the mean of
``STEPS`` calls between CUDA events after ``WARMUP`` calls (the host
clock on the CPU); the backward is d(Σ out²)/d(q, k, v) through
autograd.

    python -m synthanatomy_tpu_torch.tools.bench_local_attn [--b 6 --h 16 --n 1401 \\
        --d 64 --window 420]
    python -m synthanatomy_tpu_torch.tools.bench_local_attn --cpu --b 1 --h 2 --n 40 \\
        --d 16 --window 12

``main`` returns the four times (s) and the forward's max |Δ|.
"""

from __future__ import annotations

import argparse

import torch

from synthanatomy_tpu_torch.ops.local_attention import local_attention
from synthanatomy_tpu_torch.ops.local_attention_flash import local_attention_flash
from synthanatomy_tpu_torch.tools._probe_util import device_name, elapsed_s, probe_device

STEPS, WARMUP = 30, 3


def timeit(fn, dev, steps=STEPS, warmup=WARMUP):
    for _ in range(warmup):
        fn()
    return elapsed_s(lambda: [fn() for _ in range(steps)], dev) / steps


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--b", type=int, default=6)
    p.add_argument("--h", type=int, default=16)
    p.add_argument("--n", type=int, default=1401)
    p.add_argument("--d", type=int, default=64)
    p.add_argument("--window", type=int, default=420)
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the host")
    args = p.parse_args(argv)
    dev = probe_device(args.cpu)
    print(f"device: {device_name(dev)}")

    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = torch.randn(3, args.b, args.h, args.n, args.d, generator=gen,
                          device=dev).to(torch.bfloat16)
    w = args.window

    def xla_f(q, k, v):
        return local_attention(q, k, v, window=w, compute_dtype=torch.bfloat16)

    def pal_f(q, k, v):
        return local_attention_flash(q, k, v, window=w, compute_dtype=torch.bfloat16)

    def grad_of(fn):
        def run():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            loss = (fn(*leaves).float() ** 2).sum()
            return torch.autograd.grad(loss, leaves)
        return run

    res = {}
    with torch.no_grad():
        res["xla_fwd"] = timeit(lambda: xla_f(q, k, v), dev)
        print(f"xla fwd:    {res['xla_fwd'] * 1e3:8.2f} ms")
        res["pallas_fwd"] = timeit(lambda: pal_f(q, k, v), dev)
        print(f"pallas fwd: {res['pallas_fwd'] * 1e3:8.2f} ms")
    res["xla_bwd"] = timeit(grad_of(xla_f), dev)
    print(f"xla bwd:    {res['xla_bwd'] * 1e3:8.2f} ms")
    res["pallas_bwd"] = timeit(grad_of(pal_f), dev)
    print(f"pallas bwd: {res['pallas_bwd'] * 1e3:8.2f} ms")

    with torch.no_grad():
        a, ref = pal_f(q, k, v).float(), xla_f(q, k, v).float()
    res["max_abs_diff"] = float((a - ref).abs().max())
    print("max|Δ| fwd:", res["max_abs_diff"])
    return res


if __name__ == "__main__":
    main()

"""Probe: what does streaming int8 or packed-int4 weights through a GEMV
cost on this card?

Port of ``tools/probe_int4.py``, with its shapes (B 16, K 512, N 2048,
L 96 layers), variants, printed lines and arithmetic: an L-step chain
``acc += fold(x · W_i · s_i) · 1e-3`` (``ops/probes.weight_stream``, the
kernel ``csrc/weight_stream.cu``) over int8 weights and over the same
values nibble-packed two to a byte.  The JAX probe's ``jnp.int4``
variant has no PyTorch tensor type; on this card its layout is the
nibble-packed one, and the probe says so on its own line.  Each variant
is checked against the probe's own f32 reference formula and against the
kernel's plain twin; a failure prints FAILED and ``main`` raises at the
end.  Then each is timed as a chain of ``--reps`` calls
(``c = c + f(c) · 1e-6``), best of 3, with CUDA events.

    python -m synthanatomy_tpu_torch.tools.probe_int4            # on the card
    python -m synthanatomy_tpu_torch.tools.probe_int4 --cpu --reps 2   # plain versions

``main`` returns what it printed as a dict.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from synthanatomy_tpu_torch.ops import probes
from synthanatomy_tpu_torch.tools._probe_util import device_name, elapsed_s, probe_device, rel_err

B, K, N, L = 16, 512, 2048, 96  # GEMV-ish decode shape, L layers
TOL = 1e-4  # f32 sums in other orders over exact bf16 products


def reference(x: np.ndarray, w_i8: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """The probe's XLA reference (f32), in numpy."""
    acc = np.zeros((x.shape[0], w_i8.shape[1]), np.float32)
    for i in range(w_i8.shape[0]):
        y = (x.astype(np.float32) @ w_i8[i].astype(np.float32)) * scales[i]
        acc = acc + y.reshape(x.shape[0], -1, w_i8.shape[1]).sum(1) * np.float32(1e-3)
    return acc


def pack(w_i8: np.ndarray) -> np.ndarray:
    """(L, K, N) values in [-8, 7] → (L, K/2, N): row k low nibble, row
    k + K/2 high nibble, in an int8 carrier (built as uint8 first: numpy
    will not cast 128-255 to int8 as two's complement)."""
    k = w_i8.shape[1]
    lo, hi = w_i8[:, : k // 2].astype(np.int32), w_i8[:, k // 2:].astype(np.int32)
    return (((hi & 15) << 4) | (lo & 15)).astype(np.uint8).view(np.int8)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the host")
    p.add_argument("--reps", type=int, default=200)
    args = p.parse_args(argv)
    dev = probe_device(args.cpu)
    print(f"device: {device_name(dev)}")

    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(B, K)).astype(np.float32)
    x = torch.from_numpy(x_np).to(torch.bfloat16)
    w_i8 = rng.integers(-7, 8, size=(L, K, N)).astype(np.int8)
    scales = rng.uniform(0.01, 0.02, size=(L, 1, N)).astype(np.float32)
    want = torch.from_numpy(reference(x.float().numpy(), w_i8, scales))
    x, s = x.to(dev), torch.from_numpy(scales).to(dev)
    weights = {"int8": (torch.from_numpy(w_i8).to(dev), False),
               "packed-int4": (torch.from_numpy(pack(w_i8)).to(dev), True)}

    results, failed = {}, []
    for name in ("int8", "int4", "packed-int4"):
        if name == "int4":
            print("int4: PyTorch has no int4 tensor type; on this card jnp.int4's layout is the "
                  "nibble-packed one: see packed-int4")
            continue
        w, packed = weights[name]
        got = probes.weight_stream(x, w, s, packed)
        plain = probes.weight_stream_plain(x, w, s, packed)
        err, err_plain = rel_err(got, want), rel_err(got, plain)
        if err > TOL or err_plain > TOL:
            print(f"{name}: FAILED — max rel err vs XLA f32 {err:.2e}, vs plain {err_plain:.2e} "
                  f"(tol {TOL:g})")
            failed.append(name)
            continue
        print(f"{name}: compiles+runs, max rel err vs XLA f32: {err:.2e} (vs plain {err_plain:.2e})")

        def chain(w=w, packed=packed):
            c = x
            for _ in range(args.reps):
                c = c + probes.weight_stream(c, w, s, packed).to(c.dtype) * 1e-6
            return c

        chain()
        per = min(elapsed_s(chain, dev) for _ in range(3)) / args.reps
        wbytes = L * K * N * (0.5 if packed else 1)
        print(f"  {per*1e6:7.1f} us/step  -> {wbytes/per/1e9:6.0f} GB/s "
              f"weight stream ({wbytes/1e6:.0f} MB/step)")
        results[name] = {"err": err, "err_plain": err_plain, "s_per_step": per,
                         "weight_bytes": wbytes}

    if "int8" in results and "packed-int4" in results:
        results["speedup"] = results["int8"]["s_per_step"] / results["packed-int4"]["s_per_step"]
        print(f"packed-int4 speedup over int8 at this shape: {results['speedup']:.2f}x")
    if failed:
        raise RuntimeError(f"probe_int4: {failed} disagree with the reference")
    return results


if __name__ == "__main__":
    main()

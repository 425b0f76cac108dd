"""Probe: the nibble-unpack formulations and the packed product on this
card.

Port of ``tools/probe_int4_unpack.py``, with its shapes, variants and
printed lines.  E runs the unpack + two bf16 products + per-half scales
(B 16, K 256, N 512) and F the same under an L = 4 layer grid with
(1, K/2, N) weight blocks (one launch; the output is the last layer's
product), both through ``ops/quant.int4_matmul`` (``csrc/int8_matmul.cu``).
A-D unpack (K2 128, N 256) packed bytes by four formulations
(``ops/probes.int4_unpack``, ``csrc/int4_unpack.cu``), which must equal
the unpacked values exactly.  Each is checked against its plain twin;
a failure prints FAILED and ``main`` raises at the end.

    python -m synthanatomy_tpu_torch.tools.probe_int4_unpack         # on the card
    python -m synthanatomy_tpu_torch.tools.probe_int4_unpack --cpu   # plain versions

``main`` returns what it printed as a dict.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from synthanatomy_tpu_torch.ops import probes, quant
from synthanatomy_tpu_torch.tools._probe_util import device_name, probe_device, rel_err

K2, N = 128, 256
B, K, NN = 16, 256, 512
L = 4
TOL = 1e-5  # f32 sums of exact bf16 products in other orders


def _packed(hi: np.ndarray, lo: np.ndarray) -> torch.Tensor:
    """Nibbles → int8 carrier, through uint8 (numpy will not cast 128-255
    to int8 as two's complement)."""
    return torch.from_numpy((((hi & 15) << 4) | (lo & 15)).astype(np.uint8).view(np.int8))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the host")
    args = p.parse_args(argv)
    dev = probe_device(args.cpu)
    print(f"device: {device_name(dev)}")

    rng = np.random.default_rng(0)
    lo = rng.integers(-7, 8, size=(K2, N))
    hi = rng.integers(-7, 8, size=(K2, N))
    packed = _packed(hi, lo).to(dev)
    want = torch.from_numpy(np.concatenate([lo, hi], 0).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32)).to(torch.bfloat16).to(dev)
    w_hi = rng.integers(-7, 8, (K // 2, NN))  # the probe draws the high nibbles first
    pw = _packed(w_hi, rng.integers(-7, 8, (K // 2, NN))).to(dev)
    sc = torch.from_numpy(rng.uniform(0.01, 0.02, (2, NN)).astype(np.float32)).to(dev)

    results, failed = {}, []
    pwl = pw[None].expand(L, -1, -1).contiguous()
    scl = sc[None].expand(L, -1, -1).contiguous()
    for key, label, run in (
            ("E", "E unpack+two-dots+scales", lambda: quant.int4_matmul(x, pw, sc)),
            ("F", "F grid + (1,K/2,N) weight blocks", lambda: quant.int4_matmul(x, pwl, scl))):
        got = run()
        err = rel_err(got, quant.int4_matmul_plain(x, pw, sc))
        results[key] = err
        if tuple(got.shape) != (B, NN) or not err <= TOL:
            print(f"{label}: FAILED — shape {tuple(got.shape)}, max rel err vs plain {err:.2e}")
            failed.append(key)
        else:
            print(f"{label}: compiles+runs (max rel err vs plain {err:.2e})")

    for v, name in enumerate(probes.UNPACK_VARIANTS):
        out = probes.int4_unpack(packed, v)
        ok = torch.equal(out.cpu(), want)
        same = torch.equal(out, probes.unpack_int4_plain(packed, v))
        results[name] = ok and same
        if ok and same:
            print(f"{name}: compiles+runs, exact={ok}")
        else:
            print(f"{name}: FAILED — exact={ok}, equal to plain={same}")
            failed.append(name)
    if failed:
        raise RuntimeError(f"probe_int4_unpack: {failed} failed")
    return results


if __name__ == "__main__":
    main()

"""Hold another build of the nearest-codeword kernels (rows 3 and 4,
``csrc/vq_argmin.cu``) against the port's on one card, in turns.

``SRC.cu`` is another source of the same C interface (``vq_argmin``,
``vq_argmin_stats``: an earlier version of the kernel), built by
``_build`` against the port's headers.  At N 4200 (B3 × 10×14×10
latents), K 2048, D 32 by default, f32, its indices are checked against
the port's (equal but on near-ties, counts exact), then
``nearest_codeword`` and ``nearest_codeword_stats`` are timed beside it
in turns (other, kernel, kernel, other), as elapsed time (CUDA events
around back-to-back calls, ``tools/_probe_util.event_ms``) and as device
time (``device_ms``: the calls queued behind a GPU spin).  The plain
versions and the ``addmm + argmin`` yardstick are timed by
``chip_smoke.py`` phase 11.  Every line carries the card's name and power
limit.

    python -m synthanatomy_tpu_torch.tools.bench_vq parent/vq_argmin.cu [--reps 200]

``main`` returns {"argmin" | "stats": {"ms", "dev_ms", "other_ms",
"other_dev_ms"}}.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import torch

from synthanatomy_tpu_torch import _build
from synthanatomy_tpu_torch.ops import vq
from synthanatomy_tpu_torch.tools._probe_util import card_name, device_ms, event_ms, probe_device


def _calls(so, x, w):
    """The other build's argmin and argmin + statistics on x and w."""
    n, d = x.shape
    k = w.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    counts = torch.empty(k, device=x.device)
    dw = torch.empty(k, d, device=x.device)

    def argmin():
        err = so.vq_argmin(n, k, d, x.data_ptr(), w.data_ptr(), idx.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"vq_argmin: CUDA error {err}")
        return idx

    def stats():
        err = so.vq_argmin_stats(n, k, d, x.data_ptr(), w.data_ptr(), idx.data_ptr(),
                                 counts.data_ptr(), dw.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"vq_argmin_stats: CUDA error {err}")
        return idx, counts, dw

    return argmin, stats


def check_same(x, w, got, want, counts=None, want_counts=None) -> int:
    """Raise unless ``got`` equals ``want`` but on near-ties (rows whose
    two codes' f64 distances lie within 1e-5 of the distance scale) and
    the counts are equal; returns the rows that differ."""
    rows = torch.nonzero(got != want).flatten()
    if rows.numel():
        wd = w.double()
        dist = (wd * wd).sum(1)[None, :] - 2.0 * x[rows].double() @ wd.t()
        gap = float((dist.gather(1, got[rows].long()[:, None])
                     - dist.gather(1, want[rows].long()[:, None])).abs().max())
        if gap > 1e-5 * float(dist.abs().max()):
            raise RuntimeError(f"argmin differs on {rows.numel()} rows, gap {gap}")
    if counts is not None and not torch.equal(counts, want_counts):
        raise RuntimeError("counts differ")
    return int(rows.numel())


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", type=Path, help="another source of the same C interface")
    p.add_argument("--n", type=int, default=4200)
    p.add_argument("--k", type=int, default=2048)
    p.add_argument("--d", type=int, default=32)
    p.add_argument("--reps", type=int, default=200)
    args = p.parse_args(argv)
    dev = probe_device(False)
    card = card_name()
    gen = torch.Generator(device=dev).manual_seed(50)
    n, k, d = args.n, args.k, args.d
    x = torch.randn(n, d, generator=gen, device=dev)
    w = torch.randn(k, d, generator=gen, device=dev)
    shape = f"N {n}, K {k}, D {d}, f32"

    so = _build.load_library(args.src.resolve())
    so.vq_argmin.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    so.vq_argmin_stats.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
    argmin, stats = _calls(so, x, w)
    idx, counts, _ = vq.nearest_codeword_stats(x, w)
    o_idx, o_counts, _ = stats()
    diff = check_same(x, w, o_idx.clone(), idx, o_counts, counts)
    out = {}
    for name, kern, other in (("argmin", lambda: vq.nearest_codeword(x, w), argmin),
                              ("stats", lambda: vq.nearest_codeword_stats(x, w), stats)):
        reads = {}
        for label, timer in (("ms", event_ms), ("dev_ms", device_ms)):
            o1, k1 = timer(other, args.reps), timer(kern, args.reps)
            k2, o2 = timer(kern, args.reps), timer(other, args.reps)
            reads[label] = ((o1 + o2) / 2, (k1 + k2) / 2, (o1, k1, k2, o2))
        out[name] = {"ms": reads["ms"][1], "dev_ms": reads["dev_ms"][1],
                     "other_ms": reads["ms"][0], "other_dev_ms": reads["dev_ms"][0]}
        print(f"[turns] {name}: {args.src} {reads['ms'][0]:.4f} vs kernel {reads['ms'][1]:.4f} "
              f"ms elapsed, {reads['dev_ms'][0]:.4f} vs {reads['dev_ms'][1]:.4f} device "
              f"({shape}); turns elapsed {[round(v, 4) for v in reads['ms'][2]]}, device "
              f"{[round(v, 4) for v in reads['dev_ms'][2]]}; rows that differ (near-ties): "
              f"{diff} [{card}]")
    return out


if __name__ == "__main__":
    main()

"""Time a probe kernel built from other sources against the package's
own build, in turns, on one card: row 9b's nibble unpack
(``int4_unpack``) or row 9c's tile program (``launch_overhead``).

Each SOURCE is ``current`` (the package's own ``csrc/KERNEL.cu``, the
default) or the path of another source with the same C entry point (an
earlier commit's, unpacked by ``git archive`` under a gitignored
directory), built by ``_build``.  Each build is first held against the
plain twin at its probe's shape: the four unpack formulations exactly,
the tile program at G 3 within 1e-2 of max |plain|.  Then, the builds in
order and then in reverse:

- ``int4_unpack``: formulation A's device time at K2 128, N 256
  (``_probe_util.device_ms``: the calls queued behind a GPU spin);
- ``launch_overhead``: the program at G 0 (its fixed cost, no product)
  replayed from a CUDA graph, µs a launch (``_probe_util.graph_us``),
  and its device time at G 24, 96 and 192, whose slope is a step.

The floor under each, an empty launch of its grid, is read for the
package's own build by ``chip_smoke.py`` (phase 15c, row 9b) and by
``probe_pallas_overhead.prologue_split`` (row 9c).  Every line carries
the card's name and power limit.

    python -m synthanatomy_tpu_torch.tools.bench_builds KERNEL [SOURCE ...] [--reps 200]

``main`` returns {SOURCE: {reading: value}}, each value the mean of its
two turns.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import torch

from synthanatomy_tpu_torch import _build
from synthanatomy_tpu_torch.ops import probes
from synthanatomy_tpu_torch.tools import probe_int4_unpack, probe_pallas_overhead
from synthanatomy_tpu_torch.tools._probe_util import card_name, device_ms, graph_us, probe_device

I, P = ctypes.c_int, ctypes.c_void_p
STEPS = (24, 96, 192)


def _ok(err: int, src: str) -> None:
    if err:
        raise RuntimeError(f"{src}: CUDA error {err}")


def _unpack(lib, src, dev, gen):
    """Readings of one int4_unpack build: {name: reps → value}."""
    lib.int4_unpack.argtypes = [I, I, P, P, P]
    lib.int4_unpack.restype = I
    packed = torch.randint(-128, 128, (probe_int4_unpack.K2, probe_int4_unpack.N), generator=gen,
                           device=dev).to(torch.int8)
    out = torch.empty(2 * packed.shape[0], packed.shape[1], device=dev)

    def call(variant):
        _ok(lib.int4_unpack(variant, packed.numel(), packed.data_ptr(), out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream), src)
        return out

    for v in range(4):
        if not torch.equal(call(v), probes.unpack_int4_plain(packed, v)):
            raise RuntimeError(f"{src}: {probes.UNPACK_VARIANTS[v]} is not exact")
    print(f"[check] {src}: the four formulations exact")
    return {"A_dev_ms": lambda reps: device_ms(lambda: call(0), reps)}


def _overhead(lib, src, dev, gen):
    """Readings of one launch_overhead build: {name: reps → value}."""
    lib.launch_overhead.argtypes = [I] * 4 + [P] * 4
    lib.launch_overhead.restype = I
    m, k, n = probe_pallas_overhead.M, probe_pallas_overhead.K_DIM, probe_pallas_overhead.N
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)

    def call(steps):
        _ok(lib.launch_overhead(m, k, n, steps, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream), src)
        return out

    want = probes.tile_steps_plain(x, w, 3).float()
    err = float((call(3).float() - want).abs().max())
    if err > 1e-2 * float(want.abs().max()):
        raise RuntimeError(f"{src}: max abs err {err} against the plain twin at G 3")
    print(f"[check] {src}: G 3 within 1e-2 of max |plain| (max abs err {err:.3e})")
    reads = {"g0_graph_us": lambda reps: graph_us(lambda: call(0), 20, reps)}
    reads.update({f"G{g}_dev_ms": lambda reps, g=g: device_ms(lambda: call(g), reps)
                  for g in STEPS})
    return reads


KERNELS = {"int4_unpack": _unpack, "launch_overhead": _overhead}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("kernel", choices=sorted(KERNELS))
    p.add_argument("sources", nargs="*", default=["current"],
                   help="'current' or paths of other sources of the kernel")
    p.add_argument("--reps", type=int, default=200)
    args = p.parse_args(argv)
    dev = probe_device(False)
    card = card_name()
    builds = {}
    for src in args.sources:
        lib = _build.load_library(args.kernel if src == "current" else Path(src).resolve())
        # the same seed for every build: the same inputs
        builds[src] = KERNELS[args.kernel](lib, src, dev, torch.Generator(dev).manual_seed(80))
    turns = {src: {name: [] for name in reads} for src, reads in builds.items()}
    for src in list(builds) + list(builds)[::-1]:
        for name, read in builds[src].items():
            turns[src][name].append(read(args.reps))
    res = {}
    for src, reads in turns.items():
        res[src] = {name: sum(v) / 2 for name, v in reads.items()}
        print(f"[time] {args.kernel} {src}: " + ", ".join(
            f"{name} {res[src][name]:.5f} ({v[0]:.5f}, {v[1]:.5f})" for name, v in reads.items())
            + f"  [{card}]")
        if args.kernel == "launch_overhead":
            step = (res[src][f"G{STEPS[-1]}_dev_ms"] - res[src][f"G{STEPS[0]}_dev_ms"]) / (
                STEPS[-1] - STEPS[0]) * 1e3
            res[src]["step_us"] = step
            print(f"[time] launch_overhead {src}: a step {step:.3f} us (G {STEPS[0]} to "
                  f"{STEPS[-1]})  [{card}]")
    return res


if __name__ == "__main__":
    main()

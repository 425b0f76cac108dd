"""Probe: what does one more kernel launch cost on this card, against
the same work folded into one launch's loop?

Port of ``tools/probe_pallas_overhead.py``, with its shapes, variants,
printed lines and arithmetic.  The tile program is G sequential steps of
acc += x · w, (256, 512) × (512, 512) bf16 with f32 accumulation, written
as bf16 (``ops/probes.tile_steps``, the kernel
``csrc/launch_overhead.cu``; the TPU's grid steps are its loop).  The
same total work (G = 96 steps) runs as 1 × 96, 4 × 24, 24 × 4 and 96 × 1
launches, each chained to the next by c = c + y · 1e-6, for ``--reps``
repetitions, timed with CUDA events; the slopes give the cost of a
launch.  The counterpart of the TPU probe's "everything under one jit"
is a CUDA graph of one repetition, replayed ``--reps`` times, timed the
same way; both slopes are printed.  A link of the chain is three
launches here, the tile program and two elementwise kernels (the
multiply and the add), where JAX under ``jit`` fuses the link's
elementwise work into one XLA op: so each slope is the cost of a tile
program launch, its own fixed cost (prologue, cluster sums) and two
elementwise launches.  On the card one more line splits the first two:
the tile program at G 0 (staging, cluster sums and writes, no product)
against an empty kernel of its grid, both replayed from a CUDA graph.
A sweep of G at one launch gives the cost of a step, beside the
tensor-core ideal 2·256·512·512 / 989e12.  Each launch shape's first
call is checked against the plain twin; a failure prints FAILED and
``main`` raises at the end.

    python -m synthanatomy_tpu_torch.tools.probe_pallas_overhead          # on the card
    python -m synthanatomy_tpu_torch.tools.probe_pallas_overhead --cpu --reps 1

``main`` returns what it printed as a dict.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from synthanatomy_tpu_torch.ops import probes
from synthanatomy_tpu_torch.tools._probe_util import (
    device_name,
    elapsed_s,
    graph_us,
    probe_device,
)

M, K_DIM, N = 256, 512, 512  # per-step tile product (bf16, f32 accumulation)
G = 96  # total steps: the per-step launch count of the two training kernel families
SWEEP = (24, 48, 96, 192)
PEAK_BF16 = 989e12  # NVIDIA H100 SXM, dense bf16
TOL = 1e-2  # bf16 output: one rounding of f32 sums taken in other orders


def _check(x, w, steps):
    """Kernel against plain on the same inputs: elementwise within TOL of
    the largest magnitude."""
    got = probes.tile_steps(x, w, steps).float()
    want = probes.tile_steps_plain(x, w, steps).float()
    err = float((got - want).abs().max())
    return err, err <= TOL * float(want.abs().max())


def _rep(x, w, num_calls, steps_per_call):
    c = x
    for _ in range(num_calls):
        # data dependency call to call (residual-stream shape)
        c = c + probes.tile_steps(c, w, steps_per_call).to(c.dtype) * 1e-6
    return c


def build(x, w, num_calls, steps_per_call, reps, graph):
    """A callable running ``reps`` repetitions of ``num_calls`` chained
    launches of ``steps_per_call`` steps: eagerly, or as replays of a CUDA
    graph of one repetition (which copies its result back to its input,
    so the replays chain too)."""
    if not graph:
        def run():
            c = x
            for _ in range(reps):
                c = _rep(c, w, num_calls, steps_per_call)
            return c
        return run
    static = x.clone()
    _rep(static, w, num_calls, steps_per_call)  # warm up outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        static.copy_(_rep(static, w, num_calls, steps_per_call))

    def run():
        for _ in range(reps):
            g.replay()
        return static
    run.graph = g  # keep the graph alive as long as the callable
    return run


def timed(run, dev, label):
    run()  # warm
    dt = elapsed_s(run, dev)
    print(f"  {label}: {dt * 1e3:8.1f} ms total")
    return dt


def prologue_split(x, w, reps, calls=20):
    """The tile program's own fixed cost: ``tile_steps(x, w, 0)`` (staging,
    cluster sums and writes, no product) against an empty kernel of its
    grid, µs a launch, each replayed from a CUDA graph of ``calls``
    launches ``reps`` times."""
    plan = probes.tile_steps_plan(x.shape[0], x.shape[1], w.shape[1])
    geo = (plan["blocks"], plan["threads"], plan["cluster"], plan["smem"])
    g0 = graph_us(lambda: probes.tile_steps(x, w, 0), calls, reps)
    empty = graph_us(lambda: probes.empty_launch(x.device, *geo), calls, reps)
    print(f"\nprologue vs empty launch (CUDA graph replays; {geo[0]} blocks of {geo[1]} "
          f"threads in clusters of {geo[2]}, {geo[3]} B of shared memory): tile program at "
          f"G 0 {g0:.2f} us a launch, empty kernel of its grid {empty:.2f} us, the program's "
          f"own fixed cost {g0 - empty:.2f} us")
    return {"g0_us": g0, "empty_us": empty, "plan": plan}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the host")
    p.add_argument("--reps", type=int, default=200)
    args = p.parse_args(argv)
    dev = probe_device(args.cpu)
    reps = args.reps
    print(f"device: {device_name(dev)}")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(M, K_DIM)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(K_DIM, N)).astype(np.float32)).to(torch.bfloat16)
    x, w = x.to(dev), w.to(dev)

    shapes = [(1, G, f"A: 1 call, grid={G}"), (4, G // 4, f"B4: 4 calls, grid={G // 4}"),
              (24, G // 24, f"B24: 24 calls, grid={G // 24}"), (G, 1, f"B{G}: {G} calls, grid=1")]
    out, failed = {"err": 0.0}, []
    for steps in sorted({s for _, s, _ in shapes} | set(SWEEP)):
        err, ok = _check(x, w, steps)
        out["err"] = max(out["err"], err)
        if not ok:
            print(f"tile_steps({steps} steps): FAILED — max abs err vs plain {err:.3e}")
            failed.append(steps)
    if failed:
        raise RuntimeError(f"probe_pallas_overhead: tile program differs from plain at {failed}")

    modes = ("eager", "graph") if dev.type == "cuda" else ("eager",)
    for mode in modes:
        print(f"\nsame total work ({G} grid steps x {M}x{K_DIM}x{N} bf16 matmul), {reps} reps, "
              f"{'launched eagerly' if mode == 'eager' else 'CUDA graph replays'}:")
        res = {}
        for num_calls, gpc, label in shapes:
            res[num_calls] = timed(build(x, w, num_calls, gpc, reps, mode == "graph"), dev,
                                   label) / reps
        per_call = (res[G] - res[1]) / (G - 1)
        per_call24 = (res[24] - res[1]) / (24 - 1)
        print(f"\nper-invocation overhead ({G}-call slope, {mode}): {per_call * 1e6:.1f} us")
        print(f"per-invocation overhead (24-call slope, {mode}): {per_call24 * 1e6:.1f} us")
        out[mode] = {"s_per_rep": res, "per_call_s": per_call, "per_call24_s": per_call24}
    if dev.type != "cuda":
        print("(no CUDA graph on the host)")
    else:
        out["prologue"] = prologue_split(x, w, reps)

    print("\ngrid sweep (1 call):")
    gs = {g: timed(build(x, w, 1, g, reps, False), dev, f"grid={g}") / reps for g in SWEEP}
    per_step = (gs[SWEEP[-1]] - gs[SWEEP[0]]) / (SWEEP[-1] - SWEEP[0])
    ideal = 2 * M * K_DIM * N / PEAK_BF16
    per_call = out["eager"]["per_call_s"]
    print(f"\nper-grid-step cost: {per_step * 1e6:.2f} us "
          f"(tensor-core ideal for the tile: {ideal * 1e6:.3f} us)")
    print(f"projected saving, 96→48 invocations/step: {per_call * 48 * 1e3:.2f} ms")
    print(f"projected saving, 96→4 invocations/step:  {per_call * 92 * 1e3:.2f} ms")
    out.update(sweep=gs, per_step_s=per_step, ideal_s=ideal)
    return out


if __name__ == "__main__":
    main()

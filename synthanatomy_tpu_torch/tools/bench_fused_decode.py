"""Row 1's fused decode step at the paper shape on the card: its time, its
kernels by their place in a layer, and what each part adds to the step.

    python -m synthanatomy_tpu_torch.tools.bench_fused_decode [--weight-quant int8|int4] [--ablate]

Times ``ops.fused_decode.fused_decode_step`` for the paper prior (24
layers, d512, 16 heads of 64 with 8 local, window 420, m 256, ReZero;
seeded random weights and state) at B16, t 700 on the card, int8 rings:
elapsed time between CUDA events and device time (the calls queued behind
a spin, so the host's pace does not show), then one step under
torch.profiler, each kernel's mean duration by its place in the layer.
The launches overlap (programmatic dependent launch), so the durations
sum to more than the step, and the profiler stretches the step itself.

``--ablate`` also builds ``csrc/fused_decode.cu`` with one part of the
step cut out after its wait (``-DFD_CUT=<mask>``, the source's own
switch; the results are wrong: timing only) and times each in turns with
the full step on the same inputs, so the difference is what that part
adds to the step's critical path.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess

import torch

from synthanatomy_tpu_torch import _build
from synthanatomy_tpu_torch.ops import fused_decode as fd
from synthanatomy_tpu_torch.tools._probe_util import device_ms, event_ms

PLACES = ("qkv", "attention", "out", "ff1", "ff2")

# each ablation: its FD_CUT mask (csrc/fused_decode.cu: kCutFavor 1,
# kCutLocal 2, kCutGemvWork 4, kCutFinish 8)
ABLATIONS = {
    "no attention work": 1 | 2,
    "no FAVOR work": 1,
    "no local work": 2,
    "no GEMV work after the wait": 4,
    "no cluster sum and finish": 8,
}


def _model_and_inputs(weight_quant: str, dev):
    from synthanatomy_tpu_torch.models.performer import Performer

    model = Performer(2049, 1401, 512, 24, 16, 64, 8, 420, nb_features=256, use_rezero=True,
                      dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    with torch.no_grad():
        for blk in model.blocks:
            blk.g_attn.fill_(0.7)
            blk.g_ff.fill_(0.5)
    model = model.to(dev)
    cfg = fd.FusedDecodeConfig(depth=24, batch=16, dim=512, heads=16, dim_head=64,
                               local_heads=8, local_window=420, nb_features=256,
                               weight_quant=weight_quant, ring_quant=True, use_rezero=True)
    params = fd.strip_reference_weights(fd.pack_fused_params(model, weight_quant=weight_quant))
    gen = torch.Generator(device=dev).manual_seed(9)
    L, R, m = cfg.depth, cfg.ring_size, cfg.nb_features
    st = {"S": (torch.randn(L, m, cfg.bg, generator=gen, device=dev) * 0.5).to(torch.bfloat16),
          "z": torch.rand(L, cfg.batch * cfg.gh, m, generator=gen, device=dev) * 2.5 + 0.5}
    for k in ("ck", "cv"):
        st[k] = torch.randint(-127, 128, (L, R, cfg.bl), generator=gen, device=dev,
                              dtype=torch.int8)
        st[k + "_s"] = torch.rand(L, R, cfg.batch * cfg.local_heads, generator=gen,
                                  device=dev) * 0.015 + 0.005
    h = torch.randn(cfg.batch, cfg.dim, generator=gen, device=dev)
    return cfg, params, st, h


def _by_place(run, depth):
    """Mean kernel duration (µs) by place in a layer, under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    if len(ev) != 5 * depth + 1:
        raise RuntimeError(f"one step made {len(ev)} kernels, want {5 * depth + 1}")
    places = {"begin": [ev[0].time_range.elapsed_us()]}
    for i, e in enumerate(ev[1:]):
        places.setdefault(PLACES[i % 5], []).append(e.time_range.elapsed_us())
    return {k: sum(v) / len(v) for k, v in places.items()}


def _build_ablations(names):
    """{name: library} of csrc/fused_decode.cu built with each ablation's
    FD_CUT mask, in parallel, next to the package's own libraries."""
    out = _build._BUILD_DIR / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        lib = out / f"libfused_decode_cut{ABLATIONS[name]}.so"
        jobs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, f"-DFD_CUT={ABLATIONS[name]}", "-o", str(lib),
             str(_build._CSRC / "fused_decode.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, lib, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc, ablation {name!r}:\n{err}")
        libs[name] = fd._bind(ctypes.CDLL(str(lib)))
    return libs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weight-quant", default="int8", choices=("int8", "int4"))
    ap.add_argument("--ablate", action="store_true", help="also time each part cut out")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_fused_decode: no CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cfg, params, st, h = _model_and_inputs(args.weight_quant, dev)
    t = torch.tensor(700, device=dev)

    def with_lib(lib):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return lambda: fd._launch(lib, params, st, h, t, cfg, stream)

    full = with_lib(fd._lib())
    out = {"elapsed_ms": event_ms(full, args.reps), "device_ms": device_ms(full, args.reps)}
    out["places"] = _by_place(full, cfg.depth)
    print(f"row 1, B16 paper width, {args.weight_quant} weights, int8 rings, t 700: elapsed "
          f"{out['elapsed_ms']:.4f} ms, device {out['device_ms']:.4f} ms  [{smi}]")
    print("  mean kernel µs by place, under the profiler: "
          + ", ".join(f"{k} {v:.2f}" for k, v in out["places"].items()))
    if args.ablate:
        libs = _build_ablations(list(ABLATIONS))
        runs = {"full step": full, **{n: with_lib(lib) for n, lib in libs.items()}}
        got = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):  # in turns, both ways
            for n in order:
                runs[n]()
                got[n].append(device_ms(runs[n], args.reps))
        out["ablations"] = {n: sum(v) / len(v) for n, v in got.items()}
        base = out["ablations"]["full step"]
        for n, ms in out["ablations"].items():
            print(f"  {n}: device {ms:.4f} ms ({', '.join(f'{x:.4f}' for x in got[n])})"
                  + ("" if n == "full step" else f"; the part adds {base - ms:.4f} ms"))
    if not all(math.isfinite(v) for v in (out["elapsed_ms"], out["device_ms"])):
        raise RuntimeError("non-finite timing")
    return out


if __name__ == "__main__":
    main()

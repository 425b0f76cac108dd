"""The readings that set a cell's output-check limits: the program's own
on each seed, its lower-precision control's and the planted faults'.

    python3 benchmark/controls/readings.py --workload <cell> --seeds 11,12,13 [--controls 3] [--seconds 4]

One JSON line a seed: ``{"seed", "program": {number: value}, "control":
{...}, "faults": {fault: {...}}}``; the control and the faults on the
first ``--controls`` seeds only.  Each seed runs the cell's set-up, a
short window of ``--seconds`` and its check.  The benchmark's runs never
run this.

- Synthesis: the control is the program's own int4 path (the
  configuration serves int8 weights): the fused step with int4 weights,
  teacher-forced on the 16 rows of the call the check reads, its logits
  read against the reference as the program's are; and the reference
  decoder with its convolutions' operands in fp8 (the configuration
  decodes in bf16).
- Prior training: the control is the reference with every product's
  operands in the next precision down (fp8 below the configuration's
  bf16, TF32 below its float32 with TF32 off) in the program's place,
  through the first steps and through the window's last step from the
  program's state before it; the fault is half of each batch left out,
  the mean taken over the rest, in the reference put in the program's
  place.  A state left unchanged reads 1 on ``change_gap`` and
  ``last_change_median_gap`` by their definition and needs no run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _driver(cell, seed: int, seconds: float, device):
    """The cell's driver through set-up and a short window."""
    from benchmark.harness.core import Context, load_module
    from benchmark.harness.trace import Spans, Tracer

    mod = load_module(cell.file("drivers", f"{cell.workload['driver']}.py"),
                      cell.workload["driver"])
    drv = mod.Driver(Context(cell, seed, device, Spans(device)))
    drv.setup()
    drv.window(seconds, Tracer(False, device, drv.ctx.spans))
    return drv


def synthesis(cell, seed: int, seconds: float, device, controls: bool) -> dict:
    import torch

    from benchmark.harness import program as P
    from benchmark.harness import weights as W
    from benchmark.reference import prior as ref_prior
    from benchmark.reference import vqvae as ref_vqvae
    from benchmark.reference.precision import exact_f32, fp8

    drv = _driver(cell, seed, seconds, device)
    cfg, bos = drv.cfg, drv.cfg["vocab_size"]
    seqs = ref_prior.tokens_from_grid(drv.call_grids)
    if controls:
        inputs = ref_prior.teacher_inputs(seqs, bos)
        step = drv.recorder.make_stepper(drv.prior, batch=seqs.shape[0],
                                         ring_quant=bool(cfg["use_int8_rings"]),
                                         weight_quant="int4")
        with torch.no_grad():
            low = torch.stack([step(inputs[:, t], t).float() for t in range(seqs.shape[1])],
                              dim=1)
        del step
    drv.release()
    _free(device)
    out = {"seed": seed, "program": {c.name: c.value for c in drv.check()}}
    if not controls:
        return out
    with torch.no_grad(), exact_f32():
        gap, lerr = drv.compare_logits(low, seqs)
        wv = W.draw(drv.vq_shapes, P.sub_seed(seed, "vqvae"), device)
        err = 0.0
        for grid, _ in drv.kept:
            ref = ref_vqvae.decode(wv, drv.dec_cfg, grid[None])
            vol = ref_vqvae.decode(wv, drv.dec_cfg, grid[None], rnd=fp8)
            err = max(err, float(torch.linalg.vector_norm(vol - ref)
                                 / torch.linalg.vector_norm(ref)))
    out["control"] = {"token_logit_gap": gap, "logit_err": lerr, "volume_rel_err": err}
    return out


def prior_train(cell, seed: int, seconds: float, device, controls: bool) -> dict:
    from benchmark.reference.precision import exact_f32, lower

    from benchmark.reference import train as ref_train

    def readings(first: dict, last: dict) -> dict:
        # the compared numbers, and the last step's worst leaf's change gap beside them
        return {**drv.gaps(first, last),
                "last_change_worst_gap": ref_train.gaps(last, drv.ref_last)["change_gap"]}

    drv = _driver(cell, seed, seconds, device)
    drv.release()
    _free(device)
    drv.check()
    out = {"seed": seed, "program": readings(drv.program, drv.last),
           "last_step": drv.last["step"]}
    if not controls:
        return out
    with exact_f32():
        rnd = lower(drv.cfg)
        out["control"] = readings(drv.reference_first(rnd), drv.reference_last(rnd))
        out["faults"] = {"half_batch": readings(drv.reference_first(half=True),
                                                drv.reference_last(half=True))}
    return out


READINGS = {"synthesis": synthesis, "prior_train": prior_train}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--controls", type=int, default=3,
                   help="the number of seeds, from the first, that also read the control and faults")
    p.add_argument("--seconds", type=float, default=4.0, help="the short window each seed runs")
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness.core import load_cell

    if not torch.cuda.is_available():
        print("readings: the control readings are taken on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(ROOT, args.workload)
    fn = READINGS[cell.workload["driver"]]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(fn(cell, seed, args.seconds, device, i < args.controls)), flush=True)
        _free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

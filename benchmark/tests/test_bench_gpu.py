"""On a card, at each cell's own size: the program's readings stay within
the check's limits, and its lower-precision control and the planted
faults do not; and each control, put in the program's place, turns a
whole run's ``correct`` false.  Skips without a card.

    python -m pytest -q -m gpu benchmark/tests/test_bench_gpu.py
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from benchmark.controls import readings
from benchmark.harness.core import load_cell, main

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check_and_the_program_passes(card, cell):
    c = load_cell(REPO, cell)
    limits = c.workload["limits"]
    r = readings.READINGS[c.workload["driver"]](c, 3900000001, 4.0, card, True)
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r
    for fault in r.get("faults", {}).values():
        assert any(fault[k] > v for k, v in limits.items()), r


def _run(cell: str, capsys, seconds: float = 4.0) -> dict:
    rc = main(["--workload", cell, "--seed", "3900000002", "--seconds", str(seconds),
               "--trace", "0"], root=REPO, t0=time.perf_counter())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.gpu
def test_the_int4_path_in_the_programs_place_is_not_correct(card, capsys, monkeypatch):
    """synth-paper-b16 with the fused step's int4 weights in place of the
    int8 ones the configuration serves."""
    from synthanatomy_tpu_torch.models import sampling

    make = sampling.fused_logits_stepper
    monkeypatch.setattr(sampling, "fused_logits_stepper",
                        lambda *a, **kw: make(*a, **dict(kw, weight_quant="int4")))
    result = _run("synth-paper-b16", capsys)
    assert not result["correct"], result["checks"]


@pytest.mark.gpu
def test_the_tf32_reference_in_the_programs_place_is_not_correct(card, capsys, monkeypatch):
    """prior-train-f32-b24 with the reference at TF32 (the precision below
    the configuration's float32 with TF32 off) in place of the program's
    forward and backward; the program's Adam steps."""
    from benchmark.reference import prior as ref_prior
    from benchmark.reference.precision import exact_f32, tf32
    from synthanatomy_tpu_torch.train import transformer_steps

    c = load_cell(REPO, "prior-train-f32-b24")
    rows = int(c.workload["traffic"]["reference_rows"])

    def make(model, **kw):
        def step(state, inputs, targets, conditionings, sched):
            p = model.state_dict(keep_vars=True)
            state.optimizer.zero_grad(set_to_none=True)
            n, total = inputs.shape[0], 0.0
            with exact_f32():
                for r in range(0, n, rows):
                    part = ref_prior.ce_loss(p, c.config, inputs[r:r + rows],
                                             targets[r:r + rows], rnd=tf32)
                    part = part * (min(rows, n - r) / n)
                    part.backward()
                    total = total + part.detach()
            for group in state.optimizer.param_groups:
                group["lr"] = float(sched["lr"])
            state.optimizer.step()
            return state, {"Loss": total}
        return step

    monkeypatch.setattr(transformer_steps, "make_transformer_train_step", make)
    result = _run("prior-train-f32-b24", capsys, seconds=1.0)
    assert not result["correct"], result["checks"]

"""The harness on the CPU: tiny cells run end to end as files added to a
copy of the benchmark, the result line's shape, the import guard, and
faults planted underneath the timed path turning ``correct`` false."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness.core import forbidden_modules
from benchmark.tests.tiny import add_tiny, run_cell

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _snapshot(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in (root / "benchmark").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_config_and_metric_added_as_files_run(bench_root, capsys):
    """A later change adds a configuration, a cell and a per-layer metric
    as new files and BENCHMARK.json entries only; the harness finds and
    runs them, and no file that was there changes."""
    before = _snapshot(bench_root)
    cell = add_tiny(bench_root, "synth-paper-b16", name="tiny-added")
    (bench_root / "benchmark" / "metrics" / "added.calls_traced.py").write_text(
        "def read(run):\n    return run.facts.get('traced_units')\n")
    spec = json.loads((bench_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "added.calls_traced", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "test", "moves": "setup_s",
                              "workloads": [cell]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result = run_cell(bench_root, cell, trace=1, capsys=capsys)
    assert result["metrics"]["added.calls_traced"] == {"value": 1.0, "unit": "calls"}
    after = _snapshot(bench_root)
    assert all(after[k] == v for k, v in before.items())


@pytest.mark.parametrize("cell", CELLS)
def test_a_dry_run_loads_no_jax(cell, tmp_path):
    """A CPU dry run of each driver in a fresh process: it ends with code 0
    (the harness exits 3 if it finds a forbidden module) and its
    sys.modules holds no jax, jaxlib or synthanatomy_tpu (whole names)."""
    code = f"""
import json, shutil, sys, time
from pathlib import Path
sys.path.insert(0, {str(REPO)!r})
root = Path({str(tmp_path)!r})
shutil.copy({str(REPO / 'BENCHMARK.json')!r}, root / 'BENCHMARK.json')
shutil.copytree({str(REPO / 'benchmark')!r}, root / 'benchmark')
from benchmark.tests.tiny import add_tiny
from benchmark.harness.core import main
cell = add_tiny(root, {cell!r})
rc = main(['--workload', cell, '--seed', '2500000000', '--seconds', '0.5', '--trace', '0'],
          root=root, t0=time.perf_counter(), allow_cpu=True)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
sys.exit(rc)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "synthanatomy_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "synthanatomy_tpu"}


def test_the_import_guard_compares_whole_names(monkeypatch):
    for name in ("synthanatomy_tpu.models", "jax", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    found = forbidden_modules()
    assert "synthanatomy_tpu.models" in found and "jax" in found and "flax.linen" in found
    assert "jaxtyping_like" not in found
    assert not [m for m in found if m.startswith("synthanatomy_tpu_torch")]


def test_a_reader_that_loads_jax_refuses_the_run(bench_root, capsys, monkeypatch):
    """The guard runs after the per-layer readers: a reader that imports
    ``jax`` (a stub here) leaves the run with no result."""
    from benchmark.harness.core import main

    stubs = bench_root / "stubs"
    stubs.mkdir()
    (stubs / "jax.py").write_text("")
    monkeypatch.syspath_prepend(str(stubs))
    # sys.modules as it was once the test ends: the stub taken out
    monkeypatch.setitem(sys.modules, "jax", sys.modules.get("jax"))
    del sys.modules["jax"]
    cell = add_tiny(bench_root, "synth-paper-b16")
    (bench_root / "benchmark" / "metrics" / "loads.jax.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    spec = json.loads((bench_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "loads.jax", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "test", "moves": "setup_s",
                              "workloads": [cell]})
    (bench_root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc = main(["--workload", cell, "--seed", "3000000001", "--seconds", "0.5", "--trace", "1"],
              root=bench_root, t0=0.0, allow_cpu=True)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "forbidden modules loaded: jax" in out.err


def test_the_harness_refuses_without_a_card(bench_root, capsys, monkeypatch):
    from benchmark.harness.core import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
              root=bench_root, t0=0.0)
    assert rc == 2 and capsys.readouterr().out == ""


def test_result_lines(bench_root, capsys):
    cell = add_tiny(bench_root, "synth-paper-b16")
    plain = run_cell(bench_root, cell, capsys=capsys)
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert plain["correct"] and set(plain["metrics"]) == {"synth_vol_per_min", "setup_s"}
    traced = run_cell(bench_root, cell, trace=1, capsys=capsys)
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    assert {"busy_s", "window_s"} <= set(traced["device"])
    # a CPU run writes no device metric
    assert "fused_decode_roofline" not in traced["metrics"]
    assert "mfu.synth" not in traced["metrics"]


# -- faults planted underneath the timed path --------------------------------


def _altered_logits(logits, t):
    """Row 1's logits with their lowest token raised above the top, at
    every 5th position."""
    if t % 5 == 3:
        logits = logits.clone()
        logits[1, logits[1, :-1].argmin()] = logits[1].max() + 1.0
    return logits


def _mixed_slots(logits, t):
    """Each row given its neighbour's logits."""
    return logits.roll(1, dims=0)


@pytest.mark.parametrize("fault", [_altered_logits, _mixed_slots])
def test_an_altered_answer_is_not_correct(bench_root, capsys, monkeypatch, fault):
    """The fused step's logits altered where they are produced: one row's
    at some positions, or each row's swapped with its neighbour's."""
    from synthanatomy_tpu_torch.models import sampling

    make = sampling.fused_logits_stepper

    def faulty(*args, **kw):
        step = make(*args, **kw)
        return lambda tok, t: fault(step(tok, t), int(t))

    monkeypatch.setattr(sampling, "fused_logits_stepper", faulty)
    result = run_cell(bench_root, add_tiny(bench_root, "synth-paper-b16"), capsys=capsys)
    assert not result["correct"]
    assert result["checks"]["token_logit_gap"]["value"] > result["checks"]["token_logit_gap"]["limit"]


def test_a_token_altered_after_its_draw_is_not_correct(bench_root, capsys, monkeypatch):
    """A served grid that differs from the tokens the step was fed."""
    from synthanatomy_tpu_torch.models import sampling

    to_grid = sampling._grid_from_sequence

    def altered(tokens, ordering):
        tokens = tokens.clone()
        tokens[0, 5] = (tokens[0, 5] + 1) % 31
        return to_grid(tokens, ordering)

    monkeypatch.setattr(sampling, "_grid_from_sequence", altered)
    result = run_cell(bench_root, add_tiny(bench_root, "synth-paper-b16"), capsys=capsys)
    assert not result["correct"]
    assert result["checks"]["logit_err"]["value"] > result["checks"]["logit_err"]["limit"]


def test_an_altered_volume_is_not_correct(bench_root, capsys, monkeypatch):
    from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE

    decode = BaselineVQVAE.decode_samples
    monkeypatch.setattr(BaselineVQVAE, "decode_samples", lambda self, idx: decode(self, idx) * 1.2)
    result = run_cell(bench_root, add_tiny(bench_root, "synth-paper-b16"), capsys=capsys)
    assert not result["correct"]
    assert result["checks"]["volume_rel_err"]["value"] > result["checks"]["volume_rel_err"]["limit"]


TRAIN = [c for c in CELLS if "train" in c]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_sound_train_run_is_correct(bench_root, capsys, cell):
    assert run_cell(bench_root, add_tiny(bench_root, cell), capsys=capsys)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(bench_root, capsys,
                                                                 monkeypatch, cell):
    from synthanatomy_tpu_torch.losses.transformer import ce_loss
    from synthanatomy_tpu_torch.train import transformer_steps

    def make(model, **kw):
        def step(state, inputs, targets, conditionings, sched):
            with torch.no_grad():
                loss, _ = ce_loss(model(inputs), targets)
            return state, {"Loss": loss}
        return step

    monkeypatch.setattr(transformer_steps, "make_transformer_train_step", make)
    result = run_cell(bench_root, add_tiny(bench_root, cell), capsys=capsys)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert result["checks"]["last_change_median_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out_is_not_correct(bench_root, capsys, monkeypatch, cell):
    from synthanatomy_tpu_torch.train import transformer_steps

    make = transformer_steps.make_transformer_train_step

    def halved(model, **kw):
        step = make(model, **kw)

        def half(state, inputs, targets, conditionings, sched):
            n = inputs.shape[0] // 2
            return step(state, inputs[:n], targets[:n], conditionings, sched)
        return half

    monkeypatch.setattr(transformer_steps, "make_transformer_train_step", halved)
    result = run_cell(bench_root, add_tiny(bench_root, cell), capsys=capsys)
    assert not result["correct"]

"""The port's prior-training bench (synthanatomy_tpu_torch/tools/
bench_transformer.py) at a tiny size on the CPU: each flag set builds,
trains (or runs the forward) and reports finite numbers; ``--splash-local``
routes every local-head call through the splash wrapper for the run and
no longer."""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from synthanatomy_tpu_torch.models import performer as perf_mod
from synthanatomy_tpu_torch.ops import local_attention_splash as ts
from synthanatomy_tpu_torch.tools import bench_transformer as bench

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TINY = ["--cpu", "--batch", "2", "--depth", "2", "--dim", "64", "--heads", "2",
        "--local-heads", "1", "--window", "6", "--seq", "24", "--grid", "2,3,4",
        "--vocab", "17", "--scan-chunk", "8", "--steps", "2", "--warmup", "1"]

FLAGS = {
    "default": [],
    "splash": ["--splash-local"],
    "splash-fused": ["--splash-local", "--splash-fused-bwd", "--splash-block", "128"],
    "fwd-only": ["--fwd-only"],
    "reversible": ["--reversible"],
    "no-remat": ["--no-remat"],
    "spatial-fixed": ["--spatial-emb", "fixed"],
    "paper-form": ["--splash-local", "--pallas-favor", "--use-rezero", "--spatial-emb",
                   "absolute", "--attn-dtype", "bfloat16"],
}


@pytest.mark.parametrize("name", list(FLAGS))
def test_bench_runs_on_cpu(name):
    calls = []
    core = ts.splash_attention_core

    def counted(*a, **k):
        calls.append(a[0].shape)
        return core(*a, **k)

    banded = perf_mod.local_attention_flash
    with mock.patch.object(ts, "splash_attention_core", counted):
        out = bench.main(TINY + FLAGS[name])
    assert perf_mod.local_attention_flash is banded  # the route is undone
    assert out["device"] == "cpu" and out["n_params"] > 0
    if name == "fwd-only":
        assert np.isfinite(out["fwd_ms"]) and np.isfinite(out["value"])
        assert not calls
        return
    steps = 1 + 1 + 2  # first step, warmup, timed steps
    assert len(out["losses"]) == steps and np.all(np.isfinite(out["losses"]))
    assert out["ms_per_step"] > 0 and out["tok_per_s"] > 0
    if "--splash-local" in FLAGS[name]:
        # remat on: each layer's attention forward runs twice per step
        assert len(calls) == 2 * 2 * steps
        block = 128 if "--splash-fused-bwd" in FLAGS[name] else 256
        assert all(s[-2] == block for s in calls)  # L 25 padded to the block
    else:
        assert not calls


def _f32_performer(*args, **kw):
    return _PERFORMER(*args, **dict(kw, dtype=torch.float32))


_PERFORMER = perf_mod.Performer


def test_splash_route_matches_banded_route():
    """At f32 attention the splash kernels and the banded kernels compute
    the same attention: the two routes' losses agree over the steps.

    The bench's own model, flags and route, built with f32 parameters.
    With the bench's bf16 parameters the comparison is ill-conditioned:
    the two routes' gradients differ only in summation order, which is
    enough to flip bf16 roundings of an Adam update, and the trajectories
    part after the second step (by 2.3e-4 relative on some machines)."""
    with mock.patch.object(perf_mod, "Performer", _f32_performer):
        a = bench.main(TINY + ["--splash-local"])["losses"]
        b = bench.main(TINY + ["--pallas-local"])["losses"]
    assert len(a) == 4  # the first step, one warm-up step, two timed steps
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_bench_needs_the_card_without_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("the refusal is checked where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.main([a for a in TINY if a != "--cpu"])

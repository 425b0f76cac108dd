"""The port's stage-1 tools on the CPU at tiny shapes:
``tools/bench_vqvae`` (the round trip; the train step with D and the
device augmentation, each resampler) and ``tools/bench_dataloader`` (the
three loader cases); both read every flag the JAX tools read, and add
only ``--device``."""

import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu_torch.tools import bench_dataloader, bench_vqvae  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flags(path):
    return set(re.findall(r'kw\.get\("(\w+)"', open(path).read()))


@pytest.mark.parametrize("name", ["bench_vqvae", "bench_dataloader"])
def test_flags_are_jax_plus_device(name):
    jax_flags = _flags(os.path.join(REPO, "tools", f"{name}.py"))
    port_flags = _flags(os.path.join(REPO, "synthanatomy_tpu_torch", "tools", f"{name}.py"))
    assert jax_flags and port_flags - jax_flags <= {"device"}
    assert jax_flags <= port_flags


@pytest.mark.parametrize("resampler", ["shear", "gather"])
def test_bench_vqvae_trains_with_device_augmentation(resampler, capsys, monkeypatch):
    from synthanatomy_tpu_torch.ops import augment

    shifts = []
    real = augment.augment_batch
    monkeypatch.setattr(augment, "augment_batch",
                        lambda x, p, s=None: shifts.append(s) or real(x, p, s))
    argv = ["--device=cpu", "--shape=(32,32,32)", "--levels=2", "--batch=2", "--adversarial",
            "--device_augment", "--recon=False"]
    if resampler == "gather":
        argv.append("--gather_augment")
    out = bench_vqvae.main(argv)
    assert np.isfinite(out["train_loss"]) and out["train_ms"] > 0 and "recon_ms" not in out
    assert len(shifts) == 4  # the first call and 3 timed steps
    assert all((s is None) == (resampler == "gather") for s in shifts)
    printed = capsys.readouterr().out
    assert "[train+adv+devaug] batch=2 loss=mse" in printed and "[cpu]" in printed


def test_bench_vqvae_round_trip_and_plain_step(capsys):
    out = bench_vqvae.main(["--device=cpu", "--shape=(16,16,16)", "--levels=2", "--batch=1",
                            "--fused_res=False", "--remat=False"])
    assert out["recon_ms"] > 0 and np.isfinite(out["train_loss"])
    printed = capsys.readouterr().out
    assert "extract+decode" in printed and "latent (1, 4, 4, 4)" in printed
    assert "[train] batch=1 loss=mse" in printed


def test_bench_vqvae_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        bench_vqvae.main(["--shape=(16,16,16)"])


def test_bench_dataloader_three_cases(capsys):
    from synthanatomy_tpu_torch.native import native_available

    rates = bench_dataloader.main(["--n=4", "--shape=(12,12,12)", "--workers=2"])
    want = {"pure python"}
    if native_available():
        want |= {"native C++", "native C++ + device-augment"}
    assert set(rates) == want and all(r > 0 for r in rates.values())
    assert "writing 4 volumes of (12, 12, 12)" in capsys.readouterr().out

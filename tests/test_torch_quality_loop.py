"""The port's ``tools/quality_loop`` on the CPU:

- ``make_brain_volume``, ``volume_stats`` and ``stat_envelope`` equal to
  JAX's ``tools/quality_loop.py`` (bit for bit, same seeds and arrays);
- the flag dicts are JAX's verbatim;
- stages 0-5 through the port's CLIs at narrow widths with
  ``device="cpu"`` (four 48³ volumes, a 2-level/8-channel VQ-VAE, a
  1-layer d16 prior, one chunk each, bars that any finite metric meets);
- the stage-6 verdict on statistics made to pass and made to fail.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu_torch.tools import quality_loop as T  # noqa: E402
from tools import quality_loop as J  # noqa: E402


@pytest.mark.parametrize("seed,size", [(7, 48), (3, 20)])
def test_numpy_helpers_equal_jax(seed, size):
    vols = {}
    for name, mod in (("port", T), ("jax", J)):
        rng = np.random.default_rng(seed)
        vols[name] = [mod.make_brain_volume(rng, size) for _ in range(3)]
    for a, b in zip(vols["port"], vols["jax"]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    stats_t = [T.volume_stats(v) for v in vols["port"]]
    stats_j = [J.volume_stats(v) for v in vols["jax"]]
    assert stats_t == stats_j
    assert T.stat_envelope(stats_t) == J.stat_envelope(stats_j)
    assert T.stat_envelope(stats_t, widen=0.1) == J.stat_envelope(stats_j, widen=0.1)


def test_flag_dicts_are_jax_verbatim():
    import ast
    import inspect

    dicts = {}
    for node in ast.walk(ast.parse(inspect.getsource(J.main))):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and getattr(node.value.func, "id", "") == "dict" \
                and node.targets[0].id in ("vq", "tr"):
            dicts[node.targets[0].id] = {kw.arg: kw.value for kw in node.value.keywords}
    names = {"data_dir": "D", "lat_dir": "L", "root": "R", "args.n_samples": 8}

    def value(node):
        text = ast.unparse(node)
        return names[text] if text in names else ast.literal_eval(node)

    want_vq = {k: value(v) for k, v in dicts["vq"].items()}
    want_tr = {k: value(v) for k, v in dicts["tr"].items()}
    assert T.vq_flags("D", "R") == want_vq
    assert T.prior_flags("L", "R", 8) == want_tr


VQ_NARROW = dict(no_channels=8, no_res_layers=1, num_embeddings=(16,), embedding_dim=(4,),
                 num_workers=0, compute_dtype="float32", device="cpu", batch_size=2,
                 eval_batch_size=2)
PRIOR_NARROW = dict(vocab_size=16, n_embd=16, n_layers=1, n_head=2, dim_head=8, nb_features=8,
                    local_attn_heads=1, local_window_size=8, num_workers=0,
                    compute_dtype="float32", device="cpu", batch_size=2)


def test_stages_0_to_5_at_narrow_widths(tmp_path, capsys):
    root = str(tmp_path / "loop")
    data_dir = T.write_volumes(root, 4, 48)
    assert sorted(os.listdir(data_dir)) == [f"subj{i:03d}.nii.gz" for i in range(4)]
    vq = dict(T.vq_flags(data_dir, root), **VQ_NARROW)
    ms, vq_epochs = T.train_vqvae(vq, ms_ssim=-1.0, chunk=1, max_chunks=1, t_start=0.0)
    assert vq_epochs == 1 and -1.0 < ms <= 1.0  # the metric was computed
    lat_dir, latents = T.extract_latents(vq, root, epochs=1, chunk=1, n_subjects=4)
    grid = np.load(os.path.join(lat_dir, latents[0]))
    assert grid.shape == (12, 12, 12) and grid.dtype == np.uint16 and grid.max() < 16
    env = T.recon_envelope(vq, root, lat_dir, epochs=1, chunk=1, n_subjects=4)
    assert set(env) == {"foreground_frac", "bright_frac", "mean_intensity", "grad_mag"}
    assert all(lo < hi for lo, hi in env.values())

    tr = dict(T.prior_flags(lat_dir, root, 2), **PRIOR_NARROW)
    ce, pr_epochs = T.train_prior(tr, ce=float("inf"), chunk=1, max_chunks=1, t_start=0.0)
    assert pr_epochs == 1 and np.isfinite(ce)
    samp_dir, uniq = T.sample_grids(tr, root, latents, lat_dir, n_samples=2, epochs=1)
    assert uniq == 2 and len(os.listdir(samp_dir)) == 2
    files, vols = T.decode_grids(vq, root, samp_dir, epochs=1, chunk=1, n_samples=2)
    assert len(files) == 2 and all(v.shape == (48, 48, 48) and np.isfinite(v).all()
                                   for v in vols)
    out = capsys.readouterr().out
    for tag in ("[0/6]", "[1/6]", "[2/6]", "[2b/6]", "[3/6]", "[4/6]", "[5/6]"):
        assert tag in out, tag


def _made_vols(n, seed=0):
    rng = np.random.default_rng(seed)
    return [T.make_brain_volume(rng, 20) for _ in range(n)]


def test_verdict_passes_inside_the_envelope(capsys):
    vols = _made_vols(4)
    env = T.stat_envelope([T.volume_stats(v) for v in vols])
    n_ok, diversity = T.verdict([f"s{i}" for i in range(4)], vols, env, 4)
    assert n_ok == 4 and diversity > 0.005
    assert "[6/6] 4/4 sampled volumes inside" in capsys.readouterr().out


def test_verdict_fails_outside_the_envelope(capsys):
    vols = _made_vols(4)
    env = T.stat_envelope([T.volume_stats(v) for v in vols])
    bad = list(vols)
    bad[1] = np.zeros_like(bad[1])  # no foreground at all
    with pytest.raises(AssertionError, match="1 sampled volumes out of envelope"):
        T.verdict([f"s{i}" for i in range(4)], bad, env, 4)
    assert "OUT-OF-ENVELOPE s1" in capsys.readouterr().out


def test_verdict_fails_on_identical_samples():
    vols = _made_vols(1) * 3
    env = T.stat_envelope([T.volume_stats(v) for v in _made_vols(4)])
    with pytest.raises(AssertionError, match="near-identical"):
        T.verdict(["a", "b", "c"], vols, env, 3)


def test_main_refuses_without_a_card(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        T.main(["--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()

"""The port's checkpoints and reference-layout exports against the JAX
package: folder layout, discovery, the auto-resume flip, pruning and the
best-metric rule on the same directory trees; a ``torch.save`` round trip
of a whole train state (and the models-only load); and the ``interop``
exports on weights carried across from JAX: the same keys and shapes as
JAX's ``export_*`` output, the values within 1e-6."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu import interop as jinterop
from synthanatomy_tpu.models.discriminator import BaselineDiscriminator as JDisc
from synthanatomy_tpu.models.vqvae import BaselineVQVAE as JVQVAE
from synthanatomy_tpu.train import checkpoints as JC
from synthanatomy_tpu_torch import interop as tinterop
from synthanatomy_tpu_torch.models.discriminator import BaselineDiscriminator
from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE
from synthanatomy_tpu_torch.train import checkpoints as TC
from synthanatomy_tpu_torch.train.vqvae_steps import (
    create_vqvae_train_state,
    make_vqvae_train_step,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

DOWN = ((4, 2, 1, 1),) * 2
UP = ((4, 2, 1, 0, 1),) * 2
TREES = {
    "empty": [],
    "epochs": ["checkpoint_epoch=3", "checkpoint_epoch=12", "checkpoint_epoch=7"],
    "with-best": ["checkpoint_epoch=2", "checkpoint_key_metric=0.8123"],
    "negative-best": ["checkpoint_epoch=5", "checkpoint_key_metric=-0.0412"],
    "two-best": ["checkpoint_epoch=1", "checkpoint_key_metric=0.5", "checkpoint_key_metric=0.6"],
    "strays": ["checkpoint_epoch=4.pt", "checkpoint_epoch=x", "model_state_dict_epoch=4.pt",
               "notes.txt"],
    "strays-and-epoch": ["model_state_dict_epoch=9.pt", "checkpoint_epoch=9"],
}


def _make(root, names):
    d = root / "proj" / "exp" / "baseline_vqvae" / "checkpoints"
    d.mkdir(parents=True)
    for n in names:
        (d / n).write_bytes(b"")
    return d


def _outcome(fn, *a, **k):
    try:
        out = fn(*a, **k)
    except (FileNotFoundError, ValueError) as e:
        return type(e).__name__
    if isinstance(out, tuple) and out and isinstance(out[0], str):
        return (os.path.basename(out[0]),) + out[1:]
    return out


@pytest.mark.parametrize("tree", list(TREES))
def test_discovery_and_resume_match_jax(tmp_path, tree):
    d = _make(tmp_path, TREES[tree])
    root = str(tmp_path / "proj")
    for starting in (0, 4, 9, 12):
        td, te = TC.create_folder_structure(root, "exp", "baseline_vqvae", starting_epoch=starting)
        jd, je = JC.create_folder_structure(root, "exp", "baseline_vqvae", starting_epoch=starting)
        assert td == jd and te == je
        for mode in ("training", "extracting"):
            for ev in ("recent", "best", "other"):
                kw = dict(mode=mode, starting_epoch=te, evaluation_checkpoint=ev)
                assert (_outcome(TC.check_for_checkpoints, str(d), **kw)
                        == _outcome(JC.check_for_checkpoints, str(d), **kw)), (mode, ev, te)


def _tiny_state(seed=0, adversarial=True):
    gen = torch.Generator().manual_seed(seed)
    model = BaselineVQVAE(2, DOWN, UP, n_embed=16, embed_dim=4, n_channels=8, n_res_channels=8,
                          n_res_layers=1, dtype=torch.float32, generator=gen, device="cpu")
    d_model = (BaselineDiscriminator(ndf=4, n_layers=2, dtype=torch.float32, generator=gen,
                                     device="cpu") if adversarial else None)
    return create_vqvae_train_state(model, seed, d_model=d_model, device="cpu")


def _train(state, steps=2):
    step = make_vqvae_train_step(state.model, loss_name="mse", d_model=state.d_model)
    x = torch.rand(2, 1, 16, 16, 16, generator=torch.Generator().manual_seed(3))
    sched = {"lr": 3e-4, "d_lr": 5e-4, "decay": 0.5, "commitment_cost": 0.25, "epoch": 0}
    for _ in range(steps):
        state, metrics = step(state, x, sched)
    return state, metrics


def test_train_state_round_trip(tmp_path):
    state, _ = _train(_tiny_state(0))
    state.generator.manual_seed(77)
    torch.rand(3, generator=state.generator)
    path = TC.save_checkpoint(str(tmp_path), state, 2)
    assert os.path.basename(path) == "checkpoint_epoch=2" and os.path.isfile(path)
    assert os.listdir(tmp_path) == ["checkpoint_epoch=2"]  # nothing half-written left

    fresh = _tiny_state(5)
    TC.load_checkpoint(path, fresh)
    assert fresh.step == state.step == 2
    for a, b in ((state.model, fresh.model), (state.d_model, fresh.d_model)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    for a, b in ((state.g_opt, fresh.g_opt), (state.d_opt, fresh.d_opt)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, st in sa["state"].items():
            for k, v in st.items():
                assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert torch.equal(torch.rand(4, generator=state.generator),
                       torch.rand(4, generator=fresh.generator))
    # the restored state trains on exactly as the saved one does
    s1, m1 = _train(state, 1)
    s2, m2 = _train(fresh, 1)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k

    # models only (a training checkpoint read for inference), with or
    # without a discriminator in the reading state
    for adversarial in (True, False):
        inf = _tiny_state(9, adversarial)
        TC.load_checkpoint(path, inf, models_only=True)
        assert inf.step == 0
        for k, v in torch.load(path, weights_only=True)["model"].items():
            assert torch.equal(v, inf.model.state_dict()[k]), k
        assert inf.g_opt.state_dict()["state"] == {}  # no optimizer state read


def test_models_only_load_takes_the_saved_weights(tmp_path):
    state, _ = _train(_tiny_state(0), 1)
    path = TC.save_checkpoint(str(tmp_path), state, 1)
    inf = _tiny_state(9)
    TC.load_checkpoint(path, inf, models_only=True)
    for a, b in ((state.model, inf.model), (state.d_model, inf.d_model)):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k


class _DirCheckpointer:
    """Stands in for orbax in JAX's savers: a save makes the directory
    (the names and the pruning are what is compared)."""

    def save(self, path, state, force=False):
        os.makedirs(path, exist_ok=True)

    def wait_until_finished(self):
        pass


def test_pruning_and_best_metric_match_jax(tmp_path, monkeypatch):
    """The same sequence of saves leaves the same names in both trees."""
    monkeypatch.setattr(JC.ocp, "StandardCheckpointer", _DirCheckpointer)
    jstate = None
    state = _tiny_state(0, adversarial=False)
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tdir.mkdir()
    jdir.mkdir()
    for epoch, metric in ((1, 0.25), (2, None), (3, 0.71234), (4, -0.5), (5, None)):
        TC.save_checkpoint(str(tdir), state, epoch)
        JC.save_checkpoint(str(jdir), jstate, epoch)
        if metric is not None:
            TC.save_best_checkpoint(str(tdir), state, metric)
            JC.save_best_checkpoint(str(jdir), jstate, metric)
        assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == ["checkpoint_epoch=5", "checkpoint_key_metric=-0.5000"]
    TC.prune_old_checkpoints(str(tdir), keep_epoch=7)
    JC.prune_old_checkpoints(str(jdir), keep_epoch=7)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))


def _random_variables(init, x_shape, seed=0):
    """A JAX variable tree of ``init``'s structure and shapes (traced, not
    run), filled with seeded normal values: every leaf differs."""
    shapes = jax.eval_shape(init, jax.random.key(0), jnp.zeros(x_shape))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize("subpixel", [False, True])
def test_vqvae_export_matches_jax(subpixel):
    jm = JVQVAE(n_levels=2, downsample_parameters=DOWN, upsample_parameters=UP, n_embed=16,
                embed_dim=4, n_channels=8, n_res_channels=8, n_res_layers=2, dtype=jnp.float32,
                use_subpixel_conv=subpixel)
    v = _random_variables(lambda k, x: jm.init(k, x), (1, 8, 8, 8, 1))
    vq = v["vq"]
    tm = tinterop.vqvae_from_jax(v["params"], vq, 2, 2, downsample_parameters=DOWN,
                                 upsample_parameters=UP, dtype=torch.float32,
                                 use_subpixel_conv=subpixel, device="cpu")
    want = jinterop.export_vqvae_state_dict(v["params"], vq, n_levels=2, n_res_layers=2,
                                            use_subpixel_conv=subpixel)
    got = tinterop.export_vqvae_state_dict(tm)
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == np.asarray(w).shape, k
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=k)


def test_discriminator_export_matches_jax():
    jd = JDisc(dtype=jnp.float32, ndf=8, n_layers=2)
    v = _random_variables(lambda k, x: jd.init(k, x, training=False), (1, 16, 16, 16, 1))
    stats = v["batch_stats"]
    td = tinterop.discriminator_from_jax(v["params"], stats, dtype=torch.float32, device="cpu")
    want = jinterop.export_discriminator_state_dict(v["params"], stats, n_layers=2)
    got = tinterop.export_discriminator_state_dict(td)
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == np.asarray(w).shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=k)


def test_save_raw_state_dict_writes_a_torch_file(tmp_path):
    sd = tinterop.export_vqvae_state_dict(_tiny_state(0, adversarial=False).model)
    out = tinterop.save_raw_state_dict(str(tmp_path / "model_state_dict_epoch=3"), sd)
    assert out.endswith("model_state_dict_epoch=3.pt")
    back = torch.load(out, weights_only=True)
    assert list(back) == list(sd) and all(torch.equal(back[k], sd[k]) for k in sd)

"""``run_transformer --pp_stages`` on the CPU: gloo ranks
(``tests/torch_sp_tp_worker.py cli``, started by
``parallel.distributed.launch``: 2 ranks, then 4) against one-process
runs of the same flags (``tests/test_pp_runner.py``: 4×4×4 latents,
vocab 16, dim 32, depth 2, 4 heads, 2 local of window 8, B2, f32, an
epoch of 2 steps with an evaluation).

- ``--pp_stages=2`` over 2 ranks (two one-layer stages, 2 microbatches),
  plain and with 'bos_replacement' conditioning, trains to the
  one-process run: the final loss within JAX's rtol 1e-4 (here 1e-5, and
  the evaluation CE too) and each parameter within rtol 2e-3, atol 5e-4
  (``tests/test_pp_runner.py:75``), all of them within 1e-4 in norm.
  Rank 0 returns the canonical state; every other rank returns its stage
  alone (the non-block parameters and its layers'), each tensor equal to
  rank 0's of its name, with the same history.
- Over 4 ranks ``--pp_stages=2`` takes the (2, 2) PP×DP layout
  (``--batch_size`` counts a data group's rows) and trains as the DP run
  over 2 ranks, ``--mesh_shape='(2,)'``.
- Checkpoints stay canonical: the ``--pp_stages=2`` checkpoint restores
  into a one-device state bit-identically, with Adam's state for every
  parameter; a one-process run resumes it to epoch 2, and a
  ``--pp_stages=2`` run resumes a one-process checkpoint to epoch 2, each
  as the uninterrupted one-process run.
- ``--pp_stages=4`` with ``--n_layers=2`` raises "divide n_layers" on 4
  ranks; a rotary prior raises ``NotImplementedError("PP step: …")``;
  ``--pp_stages`` with ``--sp_shards`` or ``--mesh_shape`` is refused by
  the flags (``tests/test_pp_runner.py:113``).
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu_torch.config import TransformerConfig  # noqa: E402
from synthanatomy_tpu_torch.parallel.distributed import launch  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sp_tp_worker.py")
FLAGS = dict(device="cpu", mode="training", epochs=1, batch_size=2, eval_batch_size=2,
             eval_every=1, checkpoint_every=1, log_every=1, num_workers=1, vocab_size=16,
             n_embd=32, n_layers=2, n_head=4, dim_head=8, nb_features=8, local_attn_heads=2,
             local_window_size=8, ordering_type="raster_scan", gamma=0.999,
             compute_dtype="float32", attn_compute_dtype="float32", seed=7)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_pp")
    lat = root / "latents"
    lat.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        np.save(lat / f"s{i}_quantization_0.npy",
                rng.integers(0, 16, size=(4, 4, 4)).astype(np.uint16))
    cond = root / "cond.csv"
    cond.write_text("subject,age\n" + "".join(f"s{i}_quantization_0.npy,{i % 2}\n"
                                               for i in range(4)))
    proj = str(root / "proj")
    base = dict(FLAGS, training_subjects=str(lat), validation_subjects=str(lat),
                project_directory=proj)
    conditioned = dict(conditioning_path=str(cond), conditionings=("age",),
                       conditioning_type="bos_replacement")
    from synthanatomy_tpu_torch.run_transformer import run

    one = {"plain": run(**dict(base, experiment_name="one")),
           "cond": run(**dict(base, experiment_name="one_cond", **conditioned))}
    resume_dir = os.path.join(proj, "pp_from_one", "performer", "checkpoints")
    os.makedirs(resume_dir)
    shutil.copy(os.path.join(proj, "one", "performer", "checkpoints", "checkpoint_epoch=1"),
                resume_dir)
    one["plain2"] = run(**dict(base, experiment_name="one", epochs=2))

    two = {
        "pp2": dict(base, experiment_name="pp2", pp_stages=2),
        "pp2_cond": dict(base, experiment_name="pp2_cond", pp_stages=2, **conditioned),
        "pp_from_one": dict(base, experiment_name="pp_from_one", pp_stages=2, epochs=2),
        "pp2_rotary": dict(base, experiment_name="rotary", pp_stages=2, position_emb="rotary"),
        "dp2": dict(base, experiment_name="dp2", mesh_shape=(2,)),
    }
    four = {
        "pp2x2": dict(base, experiment_name="pp2x2", pp_stages=2),
        "pp4_deep": dict(base, experiment_name="pp4", pp_stages=4),
    }
    outs = {}
    for n, runs in ((2, two), (4, four)):
        d = root / f"ranks{n}"
        d.mkdir()
        torch.save({"runs": runs}, d / "spec.pt")
        launch([sys.executable, WORKER, "cli", str(d / "spec.pt"), str(d)], n, timeout=300)
        outs[n] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(n)]
    ckpt = os.path.join(proj, "pp2", "performer", "checkpoints", "checkpoint_epoch=1")
    restored = _restore(dict(base, experiment_name="pp2"), ckpt)
    # one process resumes the PP checkpoint
    one["resumed_pp"] = run(**dict(base, experiment_name="pp2", epochs=2))
    return dict(one=one, two=outs[2], four=outs[4], restored=restored)


def _restore(flags, path):
    """A one-device state of ``flags``' prior with ``path`` loaded into it."""
    from synthanatomy_tpu_torch.runners import transformer as trunner
    from synthanatomy_tpu_torch.train import checkpoints as C
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    config = TransformerConfig(**{k: v for k, v in flags.items()
                                  if k in TransformerConfig.__dataclass_fields__})
    ordering = trunner.build_ordering(config, (4, 4, 4))
    model = trunner.build_performer(config, ordering, (4, 4, 4), device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    return C.load_checkpoint(path, create_transformer_train_state(model, config.seed))


def _params(res):
    if "params" in res:  # a rank's record
        return res["params"]
    return {k: v.detach() for k, v in res["state"].model.state_dict().items()}


def _same_run(got, want, name):
    """The epoch losses and evaluation CE within 1e-5 relative; the
    parameters within 1e-4 in norm, each element within rtol 2e-3, atol
    5e-4 (Adam moves an element by ~lr a step whatever its gradient's
    size, so a near-zero gradient's rounding can flip a step)."""
    assert len(got["history"]) == len(want["history"]), name
    for g, w in zip(got["history"], want["history"]):
        for key in ("Loss", "val_Loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=f"{name} {key}")
    got_p, want_p = _params(got), _params(want)
    assert set(got_p) == set(want_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k].numpy(), w.numpy(), rtol=2e-3, atol=5e-4,
                                   err_msg=f"{name} {k}")
    flat = [(got_p[k].double() - w.double(), w.double()) for k, w in want_p.items()]
    err = sum(float((d * d).sum()) for d, _ in flat) ** 0.5
    assert err <= 1e-4 * sum(float((w * w).sum()) for _, w in flat) ** 0.5, (name, err)


@pytest.mark.parametrize("name,ranks,want", [
    ("pp2", 2, "plain"), ("pp2_cond", 2, "cond"), ("pp2x2", 4, "dp2"),
])
def test_pp_cli_trains_as_one_process(cli, name, ranks, want):
    outs = cli["two" if ranks == 2 else "four"]
    ref = cli["two"][0][want] if want == "dp2" else cli["one"][want]
    _same_run(outs[0][name], ref, name)
    canon = outs[0][name]["params"]
    layers = FLAGS["n_layers"] // 2
    for r, o in enumerate(outs[1:], 1):  # the other ranks hold their stage of rank 0's
        assert o[name]["history"] == outs[0][name]["history"]
        stage = r % 2
        want = {k for k in canon if not k.startswith("blocks.")
                or stage * layers <= int(k.split(".")[1]) < (stage + 1) * layers}
        assert set(o[name]["params"]) == want, (r, sorted(o[name]["params"]))
        assert all(torch.equal(t, canon[k]) for k, t in o[name]["params"].items())


def test_pp_checkpoint_restores_into_one_device_bit_identically(cli):
    state = cli["restored"]
    got = cli["two"][0]["pp2"]["params"]
    sd = state.model.state_dict()
    assert set(sd) == set(got)
    assert all(torch.equal(sd[k], v) for k, v in got.items())
    opt = state.optimizer.state
    assert all(set(opt[p]) == {"step", "exp_avg", "exp_avg_sq"} and float(opt[p]["step"]) == 2
               for p in state.model.parameters())
    assert state.step == 2


def test_pp_checkpoint_is_canonical_both_ways(cli):
    """A one-process run resumes the ``--pp_stages=2`` checkpoint, and a
    ``--pp_stages=2`` run resumes a one-process checkpoint; each equals the
    uninterrupted one-process run at epoch 2."""
    want = cli["one"]["plain2"]
    _same_run(cli["one"]["resumed_pp"], want, "one process from --pp_stages=2")
    _same_run(cli["two"][0]["pp_from_one"], want, "--pp_stages=2 from one process")
    assert cli["one"]["resumed_pp"]["state"].step == want["state"].step == 4


def test_pp_refusals_on_the_ranks(cli):
    for out in cli["four"]:
        err = out["pp4_deep"]["error"]
        assert err == "ValueError: pp_stages=4 must divide n_layers=2 (contiguous equal stages)"
    for out in cli["two"]:
        err = out["pp2_rotary"]["error"]
        assert err.startswith("NotImplementedError: PP step: rotary position embeddings"), err


@pytest.mark.parametrize("flags,match", [
    (dict(sp_shards=2, pp_stages=2), "mutually exclusive"),
    (dict(pp_stages=2, mesh_shape=(2, 2)), "derives the device mesh"),
    (dict(pp_stages=2, zero1=True), "zero1"),
])
def test_pp_flag_validation(flags, match):
    with pytest.raises(ValueError, match=match):
        TransformerConfig(mode="training", training_subjects="x", project_directory="y",
                          experiment_name="z", **flags)

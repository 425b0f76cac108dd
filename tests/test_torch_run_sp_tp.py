"""``run_transformer`` under sequence and tensor parallelism on the CPU:
gloo ranks (``tests/torch_sp_tp_worker.py cli``, started by
``parallel.distributed.launch``: 2 ranks, then 4) against one-process
runs of the same flags (``tests/test_sp_runner.py``,
``tests/test_tp_runner.py``: 4×4×4 latents, vocab 16, dim 32, depth 2,
4 heads, 2 local of window 8, B2, f32, an epoch of 2 steps with an
evaluation).

- ``--sp_shards=2`` over 2 ranks, plain and with 'bos_replacement'
  conditioning, and ``--mesh_shape='(1, 2)'``, plain, the paper form
  with conditioning, and ScaleNorm, GLU, rotary positions and the
  attention's out-bias (forms JAX's manual TP step refuses and its
  runner trains through GSPMD): each trains to the one-process run's epoch loss and
  evaluation CE (rtol 1e-5) and parameters: all of them within 1e-4 in
  norm, and each element within JAX's runner-test bound (rtol 2e-3, atol
  5e-4, ``tests/test_sp_runner.py:62``): Adam moves an element by ~lr a
  step whatever its gradient's size, so where a gradient is near zero (a
  norm's bias, which starts at 0) rounding can flip a step.
- Over 4 ranks the (2, 2) DP×SP layout of ``--sp_shards=2`` and
  ``--mesh_shape='(2, 2)'``: ``--batch_size`` counts a data group's rows
  (as it counts a rank's under DP), so each trains as the DP run over 2
  ranks, ``--mesh_shape='(2,)'``, at the same bounds; so does
  ``--mesh_shape='(2, 2)' --ff_dropout=0.1`` as the DP run of the same
  flags, since each data group's ranks draw from one stream (seed +
  data index, the DP run's seed + rank) and the FF's mask is drawn at
  the whole width on every rank of a model group.  At
  ``--batch_size=1`` ``--sp_shards=2`` still takes the (2, 2) layout (no
  rank sits out: the batch is a data group's, not a global one to
  divide), and trains as the DP run over 2 ranks at B1.
- Under SP every rank ends with rank 0's model; under TP rank 0 returns
  the canonical state and every other rank its share alone, each tensor
  its slice of rank 0's packed canonical one, exactly.
- Checkpoints stay canonical: a one-process run resumes the (1, 2)
  checkpoint to epoch 2, and a (1, 2) run resumes a one-process
  checkpoint to epoch 2, each as the uninterrupted one-process run.
- Inference with a model axis ignores it, as JAX does: the DP sampler over
  both ranks writes what one process writes (greedy).
- ``--pp_stages=2`` raises "must divide
  the device count" in one process and "must divide n_layers" over 2 ranks
  at depth 3 (PP trains in ``tests/test_torch_run_pp.py``); the flag
  rules of JAX's config hold (``tests/test_sp_runner.py:136``,
  ``tests/test_pp_runner.py:113``).
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
PAPER = dict(use_rezero=True, spatial_position_emb="absolute")
FORMS = dict(use_scalenorm=True, ff_glu=True, position_emb="rotary", attn_out_bias=True)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_sp_tp")
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

    one = {
        "plain": run(**dict(base, experiment_name="one")),
        "cond": run(**dict(base, experiment_name="one_cond", **conditioned)),
        "paper": run(**dict(base, experiment_name="one_paper", **PAPER, **conditioned)),
        "forms": run(**dict(base, experiment_name="one_forms", **FORMS)),
    }
    ckdir = os.path.join(proj, "one", "performer", "checkpoints")
    resume_dir = os.path.join(proj, "tp_from_one", "performer", "checkpoints")
    os.makedirs(resume_dir)
    shutil.copy(os.path.join(ckdir, "checkpoint_epoch=1"), resume_dir)
    one["plain2"] = run(**dict(base, experiment_name="one", epochs=2))

    two = {
        "dp2": dict(base, experiment_name="dp2", mesh_shape=(2,)),
        "dp2_b1": dict(base, experiment_name="dp2_b1", mesh_shape=(2,), batch_size=1),
        "sp2": dict(base, experiment_name="sp2", sp_shards=2),
        "sp2_cond": dict(base, experiment_name="sp2_cond", sp_shards=2, **conditioned),
        "tp12": dict(base, experiment_name="tp12", mesh_shape=(1, 2)),
        "tp12_paper": dict(base, experiment_name="tp12_paper", mesh_shape=(1, 2), **PAPER,
                           **conditioned),
        "tp_from_one": dict(base, experiment_name="tp_from_one", mesh_shape=(1, 2), epochs=2),
        "tp12_infer": dict(base, experiment_name="tp12", mode="inference", mesh_shape=(1, 2),
                           eval_batch_size=4, sample=False),
        "tp12_forms": dict(base, experiment_name="tp12_forms", mesh_shape=(1, 2), **FORMS),
        "dp2_dropout": dict(base, experiment_name="dp2_dropout", mesh_shape=(2,),
                            ff_dropout=0.1),
        "pp2_deep": dict(base, experiment_name="pp2_deep", pp_stages=2, n_layers=3),
    }
    four = {
        "tp22": dict(base, experiment_name="tp22", mesh_shape=(2, 2)),
        "tp22_dropout": dict(base, experiment_name="tp22_dropout", mesh_shape=(2, 2),
                             ff_dropout=0.1),
        "sp2x2": dict(base, experiment_name="sp2x2", sp_shards=2),
        "sp2_b1": dict(base, experiment_name="sp2_b1", sp_shards=2, batch_size=1),
    }
    outs = {}
    for n, runs in ((2, two), (4, four)):
        d = root / f"ranks{n}"
        d.mkdir()
        torch.save({"runs": runs}, d / "spec.pt")
        launch([sys.executable, WORKER, "cli", str(d / "spec.pt"), str(d)], n, timeout=300)
        outs[n] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(n)]
    # one process samples from the (1, 2) run's checkpoint, into its own
    # experiment, then resumes that checkpoint
    infer_dir = os.path.join(proj, "one_infer", "performer", "checkpoints")
    os.makedirs(infer_dir)
    shutil.copy(os.path.join(proj, "tp12", "performer", "checkpoints", "checkpoint_epoch=1"),
                infer_dir)
    one["infer"] = run(**dict(two["tp12_infer"], experiment_name="one_infer"))
    one["resumed_tp"] = run(**dict(base, experiment_name="tp12", epochs=2))
    return dict(one=one, two=outs[2], four=outs[4], base=base, runs={2: two, 4: four})


def _share_of(flags, canon, m, index):
    """Model rank ``index``'s share over ``m`` ranks of the canonical
    parameters ``canon`` of ``flags``' prior: packed, then its slice of
    each split tensor, the rest whole."""
    from synthanatomy_tpu_torch.parallel import tensor_parallel as TP
    from synthanatomy_tpu_torch.runners import transformer as trunner

    config = TransformerConfig(**{k: v for k, v in flags.items()
                                  if k in TransformerConfig.__dataclass_fields__})
    model = trunner.build_performer(config, trunner.build_ordering(config, (4, 4, 4)),
                                    (4, 4, 4), device="cpu")
    specs = TP.tp_param_specs(model, m, list(canon))
    return {k: t if specs[k] is None else t.chunk(m, specs[k])[index]
            for k, t in TP.pack_tp_params(model, canon, m).items()}


def _params(res):
    if "params" in res:  # a rank's record
        return res["params"]
    return {k: v.detach() for k, v in res["state"].model.state_dict().items()}


def _same_run(got, want, name):
    """The epoch losses and evaluation CE within 1e-5 relative; the
    parameters within 1e-4 in norm, each element within rtol 2e-3, atol
    5e-4."""
    assert len(got["history"]) == len(want["history"]), name
    for g, w in zip(got["history"], want["history"]):
        for key in ("Loss", "val_Loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=f"{name} {key}")
    want_p = _params(want)
    assert set(got["params"]) == set(want_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(), rtol=2e-3, atol=5e-4,
                                   err_msg=f"{name} {k}")
    flat = [(got["params"][k].double() - w.double(), w.double()) for k, w in want_p.items()]
    err = sum(float((d * d).sum()) for d, _ in flat) ** 0.5
    assert err <= 1e-4 * sum(float((w * w).sum()) for _, w in flat) ** 0.5, (name, err)


@pytest.mark.parametrize("name,ranks,want", [
    ("sp2", 2, "plain"), ("sp2_cond", 2, "cond"), ("sp2x2", 4, "dp2"), ("sp2_b1", 4, "dp2_b1"),
    ("tp12", 2, "plain"), ("tp12_paper", 2, "paper"), ("tp12_forms", 2, "forms"),
    ("tp22", 4, "dp2"), ("tp22_dropout", 4, "dp2_dropout"),
])
def test_parallel_cli_trains_as_one_process(cli, name, ranks, want):
    outs = cli["two" if ranks == 2 else "four"]
    ref = cli["two"][0][want] if want.startswith("dp2") else cli["one"][want]
    _same_run(outs[0][name], ref, name)
    canon = outs[0][name]["params"]
    flags = cli["runs"][ranks][name]
    for r, o in enumerate(outs[1:], 1):
        assert o[name]["history"]
        if "sp_shards" in flags:  # SP: every rank ends with rank 0's model
            want = canon
        else:  # TP: rank r holds its model rank's share of rank 0's
            m = flags["mesh_shape"][1]
            want = _share_of(flags, canon, m, r % m)
        assert set(o[name]["params"]) == set(want), r
        assert all(torch.equal(o[name]["params"][k], v) for k, v in want.items()), r


def test_tp_checkpoint_is_canonical_both_ways(cli):
    """A one-process run resumes the (1, 2) checkpoint, and a (1, 2) run
    resumes a one-process checkpoint; each equals the uninterrupted
    one-process run at epoch 2."""
    want = cli["one"]["plain2"]  # epoch 2 of the one-process run
    got = dict(cli["one"]["resumed_tp"], params=_params(cli["one"]["resumed_tp"]))
    _same_run(got, want, "one process from (1, 2)")
    _same_run(cli["two"][0]["tp_from_one"], want, "(1, 2) from one process")
    for res in (cli["one"]["resumed_tp"], want):
        assert res["state"].step == 4


def test_inference_with_a_model_axis_samples_as_one_process(cli):
    outs = cli["two"]
    assert outs[1]["tp12_infer"]["written"] == []  # rank 0 writes
    got = {os.path.basename(p): np.load(p) for p in outs[0]["tp12_infer"]["written"]}
    assert sorted(got) == [f"s{i}_quantization_0_sample.npy" for i in range(4)]
    for p in cli["one"]["infer"]["written"]:
        want = np.load(p)
        assert want.dtype == got[os.path.basename(p)].dtype == np.uint16
        np.testing.assert_array_equal(got[os.path.basename(p)], want)


def test_flag_validation(cli, tmp_path):
    from synthanatomy_tpu_torch.run_transformer import run

    names = dict(mode="training", training_subjects="x", project_directory="y",
                 experiment_name="z")
    with pytest.raises(ValueError, match="derives the device mesh"):
        TransformerConfig(**names, sp_shards=2, mesh_shape=(2, 2))
    with pytest.raises(ValueError, match="zero1"):
        TransformerConfig(**names, sp_shards=2, zero1=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        TransformerConfig(**names, sp_shards=2, pp_stages=2)
    with pytest.raises(ValueError, match="must divide the device count"):
        run(**dict(cli["base"], project_directory=str(tmp_path), pp_stages=2))
    for out in cli["two"]:  # over 2 ranks: the depth must divide into the stages
        assert out["pp2_deep"]["error"] == ("ValueError: pp_stages=2 must divide n_layers=3 "
                                            "(contiguous equal stages)")

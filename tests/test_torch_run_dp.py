"""Both CLIs of the port over two gloo ranks on the CPU
(``--device=cpu --mesh_shape='(2,)'``; ``tests/torch_dp_worker.py``
started once for the module by ``parallel.distributed.launch``), then
one-process runs of the same flags on what the ranks wrote:

- stage 1 (16³ volumes, mse, f32, one volume a rank a step): ``--zero1``
  trains to the replicated run's loss (rtol 1e-5) and parameters, and an
  uneven evaluation (3 validation volumes, ``--eval_batch_size=2`` a rank)
  scores each real volume once (``tests/test_vqvae_zero1_runner.py:60,
  100``): the history's val MAE and MSE are the means over the 3 volumes,
  which a padded tail (a volume counted twice) would miss;
- extraction and decoding over the ranks write every file under its
  one-device name, equal to a one-process run's;
- stage 2 (4³ latents, vocab 16, conditioned): ``--zero1`` trains to the
  replicated run's CE and parameters, and DP inference (the DP sampler,
  greedy, ``--eval_batch_size=4`` over 2 ranks) writes one grid per
  subject, each equal to a one-process run's (``tests/test_tp_runner.py:
  146, 241``); at ``--eval_batch_size=3``, which does not divide over the
  ranks, rank 0 alone samples (JAX's one-device sampler) and writes
  what one process writes.

Also ``tools/dryrun_multigpu --cpu`` over two and four ranks, its
pipeline half included.  A layout the job cannot hold raises in
``test_torch_run_transformer.py::test_unported_options_raise``.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu_torch.data.nifti import load_nifti, save_nifti  # noqa: E402
from synthanatomy_tpu_torch.parallel.distributed import launch  # noqa: E402

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dp_worker.py")
DOWN = ((4, 2, 1, 1),) * 2
UP = ((4, 2, 1, 0, 1),) * 2
VQ = dict(device="cpu", epochs=1, batch_size=1, checkpoint_every=1, num_workers=1,
          prefetch_factor=1, loss="mse", adversarial_component=False, no_levels=2,
          downsample_parameters=DOWN, upsample_parameters=UP, no_channels=8, no_res_layers=1,
          num_embeddings=(16,), embedding_dim=(4,), decay=(0.5,), gamma=0.999,
          compute_dtype="float32", seed=7, save_2d_images=None)
PRIOR = dict(device="cpu", epochs=1, batch_size=1, checkpoint_every=1, num_workers=1,
             vocab_size=16, n_embd=16, n_layers=1, n_head=2, dim_head=8, nb_features=8,
             local_attn_heads=1, local_window_size=8, ordering_type="raster_scan",
             compute_dtype="float32", attn_compute_dtype="float32", conditionings=("age",),
             conditioning_type="bos_replacement", seed=3)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    root = tmp_path_factory.mktemp("run_dp")
    rng = np.random.default_rng(0)
    train, val, lat = root / "train", root / "val", root / "latents"
    for d in (train, val, lat):
        d.mkdir()
    for i in range(4):
        save_nifti(str(train / f"subj{i}.nii.gz"),
                   rng.uniform(size=(16, 16, 16)).astype(np.float32))
        np.save(lat / f"s{i}_quantization_0.npy",
                rng.integers(0, 16, size=(4, 4, 4)).astype(np.uint16))
    for i in range(3):
        save_nifti(str(val / f"val{i}.nii.gz"), rng.uniform(size=(16, 16, 16)).astype(np.float32))
    cond = root / "cond.csv"
    cond.write_text("subject,age\n" + "".join(f"s{i}_quantization_0.npy,{i % 2}\n"
                                               for i in range(4)))
    proj = str(root / "proj")
    vq = dict(VQ, training_subjects=str(train), project_directory=proj)
    prior = dict(PRIOR, training_subjects=str(lat), project_directory=proj,
                 conditioning_path=str(cond))
    runs = {
        "vq_repl": ("vqvae", dict(vq, experiment_name="repl", mesh_shape=(2,))),
        "vq_zero1": ("vqvae", dict(vq, experiment_name="zero1", mesh_shape=(2,), zero1=True,
                                   validation_subjects=str(val), eval_batch_size=2,
                                   eval_every=1)),
        "vq_extract": ("vqvae", dict(vq, experiment_name="repl", mode="extracting")),
        "prior_repl": ("transformer", dict(prior, experiment_name="prepl", mesh_shape=(2,))),
        "prior_zero1": ("transformer", dict(prior, experiment_name="pzero1", mesh_shape=(2,),
                                            zero1=True)),
        "prior_sample": ("transformer", dict(prior, experiment_name="pzero1", mode="inference",
                                             eval_batch_size=4, sample=False)),
        "prior_sample_odd": ("transformer", dict(prior, experiment_name="prepl",
                                                 mode="inference", eval_batch_size=3,
                                                 sample=False)),
    }
    spec = {"runs": runs}
    torch.save(spec, root / "spec.pt")
    launch([sys.executable, WORKER, "cli", str(root / "spec.pt"), str(root)], 2, timeout=300)
    outs = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(outs=outs, runs=runs, root=root, proj=proj)


def _files(paths):
    """The volume and grid outputs by name (the rank-suffixed trace logs aside)."""
    return {os.path.basename(p): p for p in paths if not p.endswith(".csv")}


def test_stage1_zero1_trains_as_replicated(dp):
    repl, z1 = dp["outs"][0]["vq_repl"], dp["outs"][0]["vq_zero1"]
    key = "Loss-MSE-Reconstruction"
    np.testing.assert_allclose(z1["history"][-1][key], repl["history"][-1][key], rtol=1e-5)
    for n, v in repl["params"].items():
        torch.testing.assert_close(z1["params"][n], v, rtol=1e-5, atol=1e-6, msg=n)
    for name in ("vq_repl", "vq_zero1"):  # both ranks hold the same model
        a, b = dp["outs"][0][name]["params"], dp["outs"][1][name]["params"]
        assert all(torch.equal(a[n], b[n]) for n in a), name


def test_stage1_uneven_eval_scores_each_real_volume_once(dp):
    """3 validation volumes over 2 ranks: the metric is their mean, each
    volume once, from the checkpoint the evaluation read."""
    from synthanatomy_tpu_torch.config import VQVAEConfig
    from synthanatomy_tpu_torch.metrics import mae, mse
    from synthanatomy_tpu_torch.runners import vqvae as runner
    from synthanatomy_tpu_torch.train import checkpoints as C
    from synthanatomy_tpu_torch.train.vqvae_steps import make_vqvae_eval_step

    flags = dp["runs"]["vq_zero1"][1]
    cfg = VQVAEConfig(**{k: v for k, v in dict(flags, mesh_shape=None, zero1=False,
                                               eval_batch_size=1).items()
                         if k in VQVAEConfig.__dataclass_fields__})
    model = runner.build_vqvae(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = runner.create_vqvae_train_state(model, 0, device="cpu")
    ckdir = os.path.join(dp["proj"], "zero1", "baseline_vqvae", "checkpoints")
    C.load_checkpoint(os.path.join(ckdir, "checkpoint_epoch=1"), state, models_only=True)
    sched = runner._scheduled(cfg, 0, 1)
    step = make_vqvae_eval_step(model, loss_name="mse")
    per = {"MAE": [], "MSE": []}
    with torch.no_grad(), model.unfused():
        for batch in runner._make_loaders(cfg, "training")["val"].epoch(0):
            x = runner._volumes(batch, "cpu")
            recon = step(state, x, sched)[0].float()
            per["MAE"].append(float(mae(recon, x)))
            per["MSE"].append(float(mse(recon, x)))
    assert len(per["MAE"]) == 3
    hist = dp["outs"][0]["vq_zero1"]["history"][-1]
    assert hist == dp["outs"][1]["vq_zero1"]["history"][-1]
    for k, vals in per.items():
        np.testing.assert_allclose(hist[f"val_{k}"], np.mean(vals), rtol=1e-5, err_msg=k)
        padded = np.mean(vals + vals[:1])  # the tail padded by wrapping
        assert abs(padded - np.mean(vals)) > 1e-4 * np.mean(vals), k
    assert any(n.startswith("checkpoint_key_metric") for n in os.listdir(ckdir))


def test_extracting_and_decoding_over_ranks_match_one_process(dp):
    from synthanatomy_tpu_torch.run_vqvae import run

    outs = dp["outs"]
    flags = dict(dp["runs"]["vq_extract"][1])
    dp_files = _files(outs[0]["vq_extract"]["written"] + outs[1]["vq_extract"]["written"])
    assert not set(outs[0]["vq_extract"]["written"]) & set(outs[1]["vq_extract"]["written"])
    grids = sorted(p for n, p in dp_files.items() if n.endswith("_quantization_0.npy"))
    assert len(grids) == 4
    dp_arrays = {n: (np.load(p) if p.endswith(".npy") else load_nifti(p).data)
                 for n, p in dp_files.items()}
    one = _files(run(**flags)["written"])
    assert set(one) == set(dp_arrays)
    for n, p in one.items():
        want = np.load(p) if p.endswith(".npy") else load_nifti(p).data
        np.testing.assert_array_equal(dp_arrays[n], want, err_msg=n)

    # decoding of the extracted grids: 2 ranks against one process
    lat = dp["root"] / "grids"
    lat.mkdir()
    for p in grids:
        os.link(p, lat / os.path.basename(p))
    dec = dict(flags, mode="decoding", training_subjects=str(lat), experiment_name="repl")
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); torch.set_num_threads(1); "
            "from synthanatomy_tpu_torch.run_vqvae import run; "
            f"run(**{dec!r})")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    launch([sys.executable, "-c", code, repo], 2, timeout=120)
    outdir = os.path.join(dp["proj"], "repl", "baseline_vqvae", "outputs")
    samples = {n: load_nifti(os.path.join(outdir, n)).data for n in os.listdir(outdir)
               if n.endswith("_sample.nii.gz")}
    assert len(samples) == 4
    for n, p in _files(run(**dec)["written"]).items():
        np.testing.assert_array_equal(samples[n], load_nifti(p).data, err_msg=n)


def test_stage2_zero1_trains_as_replicated(dp):
    repl, z1 = dp["outs"][0]["prior_repl"], dp["outs"][0]["prior_zero1"]
    assert np.isfinite(z1["history"][-1]["Loss"])
    np.testing.assert_allclose(z1["history"][-1]["Loss"], repl["history"][-1]["Loss"],
                               rtol=1e-5)
    for n, v in repl["params"].items():
        torch.testing.assert_close(z1["params"][n], v, rtol=1e-5, atol=1e-6, msg=n)
    a, b = z1["params"], dp["outs"][1]["prior_zero1"]["params"]
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_stage2_dp_inference_with_conditioning_matches_one_process(dp):
    from synthanatomy_tpu_torch.run_transformer import run

    outs = dp["outs"]
    assert outs[1]["prior_sample"]["written"] == []  # rank 0 writes
    got = {n: np.load(p) for n, p in _files(outs[0]["prior_sample"]["written"]).items()}
    assert sorted(got) == [f"s{i}_quantization_0_sample.npy" for i in range(4)]
    one = _files(run(**dp["runs"]["prior_sample"][1])["written"])
    assert set(one) == set(got)
    for n, p in one.items():
        want = np.load(p)
        assert want.dtype == got[n].dtype == np.uint16
        np.testing.assert_array_equal(got[n], want, err_msg=n)


def test_stage2_inference_batch_not_dividing_runs_on_rank0(dp):
    """``--eval_batch_size=3`` over 2 ranks: no DP sampler; rank 0 samples
    the 4 files in batches of 3 (the tail padded), as one process does."""
    from synthanatomy_tpu_torch.run_transformer import run

    outs = dp["outs"]
    assert outs[1]["prior_sample_odd"]["written"] == []
    got = {n: np.load(p) for n, p in _files(outs[0]["prior_sample_odd"]["written"]).items()}
    assert sorted(got) == [f"s{i}_quantization_0_sample.npy" for i in range(4)]
    one = _files(run(**dp["runs"]["prior_sample_odd"][1])["written"])
    assert set(one) == set(got)
    for n, p in one.items():
        np.testing.assert_array_equal(got[n], np.load(p), err_msg=n)


@pytest.mark.parametrize("nprocs", [2, 4])
def test_dryrun_multigpu_ranks_agree_on_the_cpu(capfd, nprocs):
    """``tools/dryrun_multigpu --cpu``: the adversarial stage-1 and the
    prior DP steps, then the prior's DP×TP step on the (N/2, 2) layout,
    both sequence-parallel attention ops over N gloo ranks and the
    pipeline half (an N-layer prior over N stages: the pipelined forward
    and one PP step), which it checks agree (the attention and the
    pipelined forward against the one-device ops)."""
    from synthanatomy_tpu_torch.tools import dryrun_multigpu

    assert dryrun_multigpu.main(["--cpu", "--nprocs", str(nprocs)]) == 0
    out = capfd.readouterr().out
    assert f"[dryrun] {nprocs} ranks (cpu)" in out and f"{nprocs} ranks agreed" in out
    assert f"DP x TP ({nprocs // 2}, 2) prior CE" in out
    assert f"sequence-parallel attention over {nprocs} ranks" in out
    assert f"pipeline-parallel ({nprocs} stages) prior forward within" in out
    assert "DP x TP prior and PP prior steps" in out

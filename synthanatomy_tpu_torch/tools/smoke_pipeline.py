"""Smoke of the complete five-stage workflow through the port's CLIs.

The port's counterpart of ``tools/smoke_pipeline_tpu.py``: drives
``synthanatomy_tpu_torch.run_vqvae.run`` and
``synthanatomy_tpu_torch.run_transformer.run`` (the functions behind
``python -m synthanatomy_tpu_torch.run_vqvae run`` and ``...run_transformer
run``) with the production defaults (bf16, the kernels on the card):

  1. VQ-VAE adversarial training          (mode=training)
  2. latent extraction                    (mode=extracting)
  3. Performer prior training             (mode=training, conditioned)
  4. prior sampling                       (mode=inference)
  5. decoding sampled latents to NIfTI    (mode=decoding)

Small synthetic volumes (32³, latents 8³) keep the run short; the point
is the real code paths (kernels, checkpoint save and restore, file
contracts), not quality.  On the card by default; ``--device=cpu`` runs
on the host:

    python -m synthanatomy_tpu_torch.tools.smoke_pipeline [--device=cpu] [--workdir=DIR]

``--workdir`` names a new directory that the run makes and keeps;
without it the run works in a temporary directory it removes.
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
import tempfile

import numpy as np

# the prior at smoke scale in the paper's block and embedding form:
# ReZero, learned spatial tables, bos_replacement conditioning, 2 FAVOR +
# 2 local heads of 64, so that stage 4 takes the fused decode step
PRIOR = dict(
    vocab_size=64, n_embd=256, n_layers=2, n_head=4, dim_head=64, nb_features=128,
    local_attn_heads=2, local_window_size=64, ordering_type="hilbert", use_rezero=True,
    spatial_position_emb="absolute", conditionings=("age",),
    conditioning_type="bos_replacement",
)
VQVAE = dict(
    epochs=2, batch_size=2, eval_batch_size=2, eval_every=2, checkpoint_every=1,
    loss="mse", adversarial_component=True, no_levels=2,
    downsample_parameters=((4, 2, 1, 1), (4, 2, 1, 1)),
    upsample_parameters=((4, 2, 1, 0, 1), (4, 2, 1, 0, 1)), no_channels=16, no_res_layers=1,
    num_embeddings=(64,), embedding_dim=(8,), decay=(0.5,), gamma=0.999,
)
N_SUBJECTS = 4
VOLUME = (32, 32, 32)


def _move(names, src, dst):
    os.makedirs(dst)
    for f in names:
        os.rename(os.path.join(src, f), os.path.join(dst, f))


def smoke(root: str, device="0") -> dict:
    """The five stages in ``root``; returns what each produced."""
    from synthanatomy_tpu_torch.data.nifti import load_nifti, save_nifti
    from synthanatomy_tpu_torch.run_transformer import run as run_transformer
    from synthanatomy_tpu_torch.run_vqvae import run as run_vqvae

    device = "cpu" if str(device) == "cpu" else int(device)
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir)
    rng = np.random.default_rng(0)
    for i in range(N_SUBJECTS):
        save_nifti(os.path.join(data_dir, f"subj{i}.nii.gz"),
                   rng.uniform(size=VOLUME).astype(np.float32))
    common = dict(project_directory=root, experiment_name="smoke", device=device,
                  num_workers=2, prefetch_factor=2)
    vq = dict(VQVAE, training_subjects=data_dir, validation_subjects=data_dir, **common)

    print("[1/5] VQ-VAE adversarial training ...", flush=True)
    r = run_vqvae(mode="training", **vq)
    loss = r["history"][-1]["Loss-Reconstruction-Total"]
    assert np.isfinite(loss), loss
    print(f"      recon loss {loss:.4f}")

    print("[2/5] latent extraction ...", flush=True)
    run_vqvae(mode="extracting", **vq)
    out1 = os.path.join(root, "smoke", "baseline_vqvae", "outputs")
    latents = sorted(f for f in os.listdir(out1) if f.endswith("_quantization_0.npy"))
    assert len(latents) == N_SUBJECTS, latents
    lat_dir = os.path.join(root, "latents")
    _move(latents, out1, lat_dir)
    shape = np.load(os.path.join(lat_dir, latents[0])).shape
    print(f"      {len(latents)} latent grids {shape}")

    # a conditioning table joined on the subject name (csv, as pandas
    # writes it)
    cond_csv = os.path.join(root, "conditioning.csv")
    with open(cond_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["subject", "age"])
        for i, name in enumerate(latents):
            w.writerow([name, 60.0 + 10.0 * (i % 2)])
    tr = dict(PRIOR, training_subjects=lat_dir, validation_subjects=lat_dir,
              conditioning_path=cond_csv, eval_batch_size=N_SUBJECTS, **common)

    print("[3/5] Performer prior training ...", flush=True)
    r = run_transformer(mode="training", epochs=2, batch_size=N_SUBJECTS, eval_every=2,
                        checkpoint_every=1, log_every=1, gamma=0.999, **tr)
    l0, l1 = r["history"][0]["Loss"], r["history"][-1]["Loss"]
    assert np.isfinite(l1) and l1 < l0, (l0, l1)
    print(f"      CE {l0:.4f} -> {l1:.4f}")

    print("[4/5] prior sampling ...", flush=True)
    run_transformer(mode="inference", temperature=1.0, top_k=32, **tr)
    out2 = os.path.join(root, "smoke", "performer", "outputs")
    samples = sorted(f for f in os.listdir(out2) if f.endswith("_sample.npy"))
    arr = np.load(os.path.join(out2, samples[0]))
    assert len(samples) == N_SUBJECTS and arr.dtype == np.uint16 and arr.shape == shape
    assert arr.max() < PRIOR["vocab_size"], arr.max()
    samp_dir = os.path.join(root, "samples")
    _move(samples, out2, samp_dir)
    print(f"      {len(samples)} sampled grids {arr.shape}")

    print("[5/5] decoding sampled latents ...", flush=True)
    run_vqvae(mode="decoding", **dict(vq, training_subjects=samp_dir))
    decoded = sorted(f for f in os.listdir(out1) if f.endswith("_sample.nii.gz"))
    assert len(decoded) == N_SUBJECTS, os.listdir(out1)
    vol = load_nifti(os.path.join(out1, decoded[0])).data
    assert vol.shape == VOLUME and np.isfinite(vol).all()
    print(f"      {len(decoded)} decoded volumes {vol.shape}")
    return {"latents": latents, "samples": samples, "decoded": decoded, "ce": (l0, l1)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="0", help="a CUDA ordinal, or cpu")
    p.add_argument("--workdir", default=None, help="a new directory, kept after the run "
                                                   "(default: a temporary one, removed)")
    args = p.parse_args(argv)
    root = args.workdir or tempfile.mkdtemp(prefix="smoke_pipeline_")
    if args.workdir:
        os.makedirs(root)  # an existing directory raises: nothing of it is overwritten
    try:
        smoke(root, args.device)
    finally:
        if not args.workdir:
            shutil.rmtree(root, ignore_errors=True)
    print(f"SMOKE OK: 5-stage pipeline on {'the CPU' if args.device == 'cpu' else 'the card'}")


if __name__ == "__main__":
    main()

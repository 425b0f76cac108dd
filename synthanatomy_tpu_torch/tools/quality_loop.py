"""The two-stage quality loop: proof that the port's training learns.

Port of ``tools/quality_loop.py``.  Through the port's own CLIs
(``synthanatomy_tpu_torch.run_vqvae.run`` and ``run_transformer.run``):

  0. write structured synthetic "brain-like" volumes (48³: a rotated
     ellipsoid of smooth tissue, a bright shell, two dark inner blobs,
     mild noise; the smallest size the reference's MS-SSIM window rule
     accepts);
  1. train the VQ-VAE until val MS-SSIM ≥ --ms_ssim, in chunks of epochs
     through auto-resume (each chunk calls the CLI again with a larger
     --epochs);
  2. extract the latents, and (2b) decode them: the statistics envelope
     is taken over these reconstructions, so that both sides of stage 6
     carry the same codec imprint;
  3. train the prior (ReZero, learned 'absolute' spatial tables) until
     val CE ≤ --ce, chunked the same way;
  4. sample new grids (temperature 1.0) and check that at least half are
     distinct;
  5. decode them;
  6. check that every sample's statistics (foreground and bright
     fractions, mean intensity, gradient magnitude) lie inside the
     reconstructions' envelope and that the samples differ.

Every bar and flag dict is JAX's.  The tool adds ``--device`` (a CUDA
ordinal, or ``cpu``): it runs on the card unless asked for the CPU, and
raises without a card.  It prints JAX's stage lines, ``QUALITY LOOP OK``
and JAX's JSON line, ``platform`` set to the card's name.

    python -m synthanatomy_tpu_torch.tools.quality_loop [--workdir=DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["make_brain_volume", "volume_stats", "stat_envelope", "vq_flags", "prior_flags",
           "write_volumes", "train_vqvae", "extract_latents", "recon_envelope", "train_prior",
           "sample_grids", "decode_grids", "verdict", "main"]


# ---------------------------------------------------------------- data


def make_brain_volume(rng: np.random.Generator, size: int = 48) -> np.ndarray:
    """One structured synthetic volume in [0, 1]: a randomly placed,
    randomly rotated ellipsoid of smooth "tissue" intensity wrapped in a
    bright shell, with 2 dark inner blobs and mild sensor noise."""
    ax = np.arange(size, dtype=np.float32)
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([z, y, x], axis=-1)

    center = size * rng.uniform(0.44, 0.56, 3).astype(np.float32)
    radii = size * rng.uniform(0.28, 0.38, 3).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    d = ((pts - center) @ q.astype(np.float32)) / radii
    r2 = (d * d).sum(-1)

    phase = rng.uniform(0, 2 * np.pi, 3)
    freq = rng.uniform(1.0, 2.0, 3)
    field = (
        np.sin(2 * np.pi * freq[0] * z / size + phase[0])
        + np.sin(2 * np.pi * freq[1] * y / size + phase[1])
        + np.sin(2 * np.pi * freq[2] * x / size + phase[2])
    ).astype(np.float32) / 3.0

    vol = np.where(r2 < 1.0, 0.55 + 0.18 * field, 0.0).astype(np.float32)
    vol = np.where((r2 >= 0.72) & (r2 < 1.0), 0.92, vol).astype(np.float32)
    for _ in range(2):
        bc = center + rng.uniform(-0.3, 0.3, 3).astype(np.float32) * radii * 0.5
        br = size * rng.uniform(0.05, 0.09)
        bd = ((pts - bc) ** 2).sum(-1)
        vol = np.where((bd < br * br) & (r2 < 0.72), 0.12, vol)
    vol = vol + rng.normal(0, 0.01, vol.shape).astype(np.float32)
    return np.clip(vol, 0.0, 1.0).astype(np.float32)


def volume_stats(vol: np.ndarray) -> dict:
    """Shape statistics of a per-volume min-max normalised copy (the
    loader normalises its inputs the same way)."""
    v = vol.astype(np.float32)
    lo, hi = float(v.min()), float(v.max())
    v = (v - lo) / max(hi - lo, 1e-6)
    fg = v > 0.3
    grad = (
        np.abs(np.diff(v, axis=0)).mean()
        + np.abs(np.diff(v, axis=1)).mean()
        + np.abs(np.diff(v, axis=2)).mean()
    ) / 3.0
    return {
        "foreground_frac": float(fg.mean()),
        "bright_frac": float((v > 0.8).mean()),
        "mean_intensity": float(v.mean()),
        "grad_mag": float(grad),
    }


def stat_envelope(stats: list, widen: float = 0.5) -> dict:
    """[min, max] per statistic over a set, widened by ``widen`` × span
    each side (plus a small absolute floor)."""
    env = {}
    for k in stats[0].keys():
        vals = np.array([s[k] for s in stats])
        lo, hi = float(vals.min()), float(vals.max())
        pad = widen * (hi - lo) + 0.01
        env[k] = (lo - pad, hi + pad)
    return env


# ---------------------------------------------------------------- flags


def vq_flags(data_dir: str, root: str) -> Dict:
    """The stage-1 flags (JAX's ``vq`` dict, verbatim)."""
    return dict(
        training_subjects=data_dir,
        validation_subjects=data_dir,
        project_directory=root,
        experiment_name="quality",
        batch_size=4,
        eval_batch_size=4,
        num_workers=2,
        prefetch_factor=2,
        loss="mse",
        adversarial_component=False,
        augmentation_probability=0.0,
        no_levels=2,
        downsample_parameters=((4, 2, 1, 1), (4, 2, 1, 1)),
        upsample_parameters=((4, 2, 1, 0, 1), (4, 2, 1, 0, 1)),
        no_channels=48,
        no_res_layers=2,
        num_embeddings=(128,),
        embedding_dim=(32,),
        decay=(0.5,),
        gamma=0.999,
        log_every=5,
    )


def prior_flags(lat_dir: str, root: str, n_samples: int) -> Dict:
    """The stage-2 flags (JAX's ``tr`` dict, verbatim: the paper block
    form at 4L/d256)."""
    return dict(
        training_subjects=lat_dir,
        validation_subjects=lat_dir,
        project_directory=root,
        experiment_name="quality",
        batch_size=4,
        eval_batch_size=n_samples,
        num_workers=2,
        learning_rate=3e-4,
        vocab_size=128,
        n_embd=256,
        n_layers=4,
        n_head=4,
        dim_head=64,
        nb_features=128,
        local_attn_heads=2,
        local_window_size=64,
        ordering_type="raster_scan",
        use_rezero=True,
        spatial_position_emb="absolute",
        gamma=0.999,
        log_every=5,
    )


def _envelope_line(env):
    return ", ".join(f"{k}=[{a:.3f},{b:.3f}]" for k, (a, b) in env.items())


def _outputs(root, experiment, network):
    return os.path.join(root, experiment, network, "outputs")


# ---------------------------------------------------------------- stages


def write_volumes(root: str, n_subjects: int, size: int) -> str:
    """Stage 0: ``n_subjects`` volumes from seed 7 as NIfTI files under
    ``root/data`` (``root`` is emptied first)."""
    from synthanatomy_tpu_torch.data.nifti import save_nifti

    shutil.rmtree(root, ignore_errors=True)
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir)
    rng = np.random.default_rng(7)
    train_stats = []
    for i in range(n_subjects):
        vol = make_brain_volume(rng, size)
        train_stats.append(volume_stats(vol))
        save_nifti(os.path.join(data_dir, f"subj{i:03d}.nii.gz"), vol)
    print(f"[0/6] {n_subjects} structured volumes @ {size}³; train stat envelope: "
          + _envelope_line(stat_envelope(train_stats)), flush=True)
    return data_dir


def train_vqvae(vq: Dict, *, ms_ssim: float, chunk: int, max_chunks: int,
                t_start: float) -> Tuple[float, int]:
    """Stage 1: train in chunks of ``chunk`` epochs until val MS-SSIM ≥
    ``ms_ssim``; asserts the bar.  Returns (MS-SSIM, epochs)."""
    from synthanatomy_tpu_torch.run_vqvae import run as run_vqvae

    ms, epochs = -1.0, 0
    for _ in range(max_chunks):
        epochs += chunk
        r = run_vqvae(mode="training", epochs=epochs, eval_every=chunk, checkpoint_every=chunk,
                      **vq)
        ms = r["history"][-1].get("val_MS-SSIM", -1.0)
        print(f"[1/6] VQ-VAE epoch {epochs}: val MS-SSIM={ms:.4f} "
              f"MSE={r['history'][-1].get('val_MSE', float('nan')):.5f} "
              f"({time.time() - t_start:.0f}s)", flush=True)
        if ms >= ms_ssim:
            break
    assert ms >= ms_ssim, (f"VQ-VAE failed the quality bar: val MS-SSIM {ms:.4f} < {ms_ssim} "
                           f"after {epochs} epochs")
    return ms, epochs


def extract_latents(vq: Dict, root: str, *, epochs: int, chunk: int,
                    n_subjects: int) -> Tuple[str, List[str]]:
    """Stage 2: extract every training volume's grid and move the grids
    to ``root/latents``.  Returns (that directory, the file names)."""
    from synthanatomy_tpu_torch.run_vqvae import run as run_vqvae

    run_vqvae(mode="extracting", epochs=epochs, eval_every=chunk, checkpoint_every=chunk, **vq)
    out_vq = _outputs(root, vq["experiment_name"], "baseline_vqvae")
    latents = sorted(f for f in os.listdir(out_vq) if f.endswith("_quantization_0.npy"))
    assert len(latents) == n_subjects, latents
    lat_dir = os.path.join(root, "latents")
    os.makedirs(lat_dir)
    for f in latents:
        os.rename(os.path.join(out_vq, f), os.path.join(lat_dir, f))
    lat_shape = np.load(os.path.join(lat_dir, latents[0])).shape
    print(f"[2/6] extracted {len(latents)} latent grids {lat_shape}", flush=True)
    return lat_dir, latents


def recon_envelope(vq: Dict, root: str, lat_dir: str, *, epochs: int, chunk: int,
                   n_subjects: int) -> Dict:
    """Stage 2b: decode the extracted training grids and take the stat
    envelope over these reconstructions (the yardstick of stage 6)."""
    from synthanatomy_tpu_torch.data.nifti import load_nifti
    from synthanatomy_tpu_torch.run_vqvae import run as run_vqvae

    run_vqvae(mode="decoding", epochs=epochs, eval_every=chunk, checkpoint_every=chunk,
              **dict(vq, training_subjects=lat_dir))
    out_vq = _outputs(root, vq["experiment_name"], "baseline_vqvae")
    recon_files = sorted(f for f in os.listdir(out_vq) if f.endswith("_sample.nii.gz"))
    assert len(recon_files) == n_subjects, recon_files
    recon_stats = []
    for f in recon_files:
        recon_stats.append(volume_stats(load_nifti(os.path.join(out_vq, f)).data))
        os.remove(os.path.join(out_vq, f))
    env = stat_envelope(recon_stats)
    print(f"[2b/6] recon stat envelope (n={len(recon_stats)}): " + _envelope_line(env),
          flush=True)
    return env


def train_prior(tr: Dict, *, ce: float, chunk: int, max_chunks: int,
                t_start: float) -> Tuple[float, int]:
    """Stage 3: train the prior in chunks of ``chunk`` epochs until val
    CE ≤ ``ce``; asserts the bar.  Returns (CE, epochs)."""
    from synthanatomy_tpu_torch.run_transformer import run as run_transformer

    val, epochs = float("inf"), 0
    for _ in range(max_chunks):
        epochs += chunk
        r = run_transformer(mode="training", epochs=epochs, eval_every=chunk,
                            checkpoint_every=chunk, **tr)
        val = r["history"][-1].get("val_Loss", float("inf"))
        print(f"[3/6] prior epoch {epochs}: val CE={val:.4f} ({time.time() - t_start:.0f}s)",
              flush=True)
        if val <= ce:
            break
    assert val <= ce, f"prior failed the quality bar: val CE {val:.4f} > {ce} after {epochs} epochs"
    return val, epochs


def sample_grids(tr: Dict, root: str, latents: Sequence[str], lat_dir: str, *,
                 n_samples: int, epochs: int) -> Tuple[str, int]:
    """Stage 4: one batch of ``n_samples`` grids at temperature 1.0
    (BOS-seeded from a subset directory, so that the sample count is the
    batch), moved to ``root/samples``; asserts at least half distinct.
    Returns (that directory, the number of distinct grids)."""
    from synthanatomy_tpu_torch.run_transformer import run as run_transformer

    seed_dir = os.path.join(root, "seed_latents")
    os.makedirs(seed_dir)
    for f in latents[:n_samples]:
        shutil.copy(os.path.join(lat_dir, f), os.path.join(seed_dir, f))
    run_transformer(mode="inference", temperature=1.0, top_k=None, epochs=epochs,
                    **dict(tr, training_subjects=seed_dir, validation_subjects=seed_dir))
    out_tr = _outputs(root, tr["experiment_name"], "performer")
    sample_files = sorted(f for f in os.listdir(out_tr) if f.endswith("_sample.npy"))
    assert len(sample_files) == n_samples, sample_files
    grids = np.stack([np.load(os.path.join(out_tr, f)) for f in sample_files])
    assert grids.dtype == np.uint16 and grids.max() < tr["vocab_size"], (grids.dtype, grids.max())
    # latent-level diversity: the prior must not have collapsed to one grid
    uniq = len({g.tobytes() for g in grids})
    print(f"[4/6] sampled {len(sample_files)} grids {grids.shape[1:]}, {uniq} unique",
          flush=True)
    assert uniq >= max(2, n_samples // 2), f"mode collapse: {uniq} unique"
    samp_dir = os.path.join(root, "samples")
    os.makedirs(samp_dir)
    for f in sample_files:
        os.rename(os.path.join(out_tr, f), os.path.join(samp_dir, f))
    return samp_dir, uniq


def decode_grids(vq: Dict, root: str, samp_dir: str, *, epochs: int, chunk: int,
                 n_samples: int) -> Tuple[List[str], List[np.ndarray]]:
    """Stage 5: decode the sampled grids.  Returns (file names, volumes)."""
    from synthanatomy_tpu_torch.data.nifti import load_nifti
    from synthanatomy_tpu_torch.run_vqvae import run as run_vqvae

    run_vqvae(mode="decoding", epochs=epochs, eval_every=chunk, checkpoint_every=chunk,
              **dict(vq, training_subjects=samp_dir))
    out_vq = _outputs(root, vq["experiment_name"], "baseline_vqvae")
    files = sorted(f for f in os.listdir(out_vq) if f.endswith("_sample.nii.gz"))
    assert len(files) == n_samples, files
    vols = [load_nifti(os.path.join(out_vq, f)).data for f in files]
    print(f"[5/6] decoded {len(vols)} volumes {vols[0].shape}", flush=True)
    return files, vols


def verdict(files: Sequence[str], vols: Sequence[np.ndarray], env: Dict,
            n_samples: int) -> Tuple[int, float]:
    """Stage 6: every sampled volume's statistics inside ``env`` and a
    mean pairwise |Δ| above 0.005; asserts both.  Returns (volumes inside,
    the mean pairwise |Δ|)."""
    n_ok = 0
    failures = []
    for f, vol in zip(files, vols):
        s = volume_stats(vol)
        bad = {k: (round(s[k], 4), tuple(round(b, 4) for b in env[k]))
               for k in env if not (env[k][0] <= s[k] <= env[k][1])}
        if bad:
            failures.append((f, bad))
        else:
            n_ok += 1
    pairs = [float(np.abs(vols[i] - vols[j]).mean())
             for i in range(len(vols)) for j in range(i + 1, len(vols))]
    diversity = float(np.mean(pairs))
    for f, bad in failures:
        print(f"      OUT-OF-ENVELOPE {f}: {bad}", flush=True)
    print(f"[6/6] {n_ok}/{n_samples} sampled volumes inside the training stat envelope; "
          f"mean pairwise |Δ|={diversity:.4f}", flush=True)
    assert n_ok == n_samples, f"{len(failures)} sampled volumes out of envelope"
    assert diversity > 0.005, f"decoded samples near-identical: {diversity}"
    return n_ok, diversity


# ---------------------------------------------------------------- main


def _platform(device) -> str:
    import torch

    if str(device) == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device=cpu to run on the CPU")
    return torch.cuda.get_device_name(int(device))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "quality_loop"))
    p.add_argument("--n_subjects", type=int, default=32)
    p.add_argument("--size", type=int, default=48)
    p.add_argument("--ms_ssim", type=float, default=0.90, help="stage-1 val MS-SSIM threshold")
    p.add_argument("--ce", type=float, default=1.0,
                   help="stage-2 val CE threshold (nats/token)")
    p.add_argument("--vq_chunk", type=int, default=10)
    p.add_argument("--max_vq_chunks", type=int, default=8)
    p.add_argument("--prior_chunk", type=int, default=5)
    p.add_argument("--max_prior_chunks", type=int, default=8)
    p.add_argument("--n_samples", type=int, default=8)
    p.add_argument("--device", default="0", help="a CUDA ordinal, or cpu")
    args = p.parse_args(argv)
    device = "cpu" if args.device == "cpu" else int(args.device)
    platform = _platform(device)

    t_start = time.time()
    root = args.workdir
    data_dir = write_volumes(root, args.n_subjects, args.size)
    vq = dict(vq_flags(data_dir, root), device=device)
    ms, vq_epochs = train_vqvae(vq, ms_ssim=args.ms_ssim, chunk=args.vq_chunk,
                                max_chunks=args.max_vq_chunks, t_start=t_start)
    lat_dir, latents = extract_latents(vq, root, epochs=vq_epochs, chunk=args.vq_chunk,
                                       n_subjects=args.n_subjects)
    env = recon_envelope(vq, root, lat_dir, epochs=vq_epochs, chunk=args.vq_chunk,
                         n_subjects=args.n_subjects)
    tr = dict(prior_flags(lat_dir, root, args.n_samples), device=device)
    ce, pr_epochs = train_prior(tr, ce=args.ce, chunk=args.prior_chunk,
                                max_chunks=args.max_prior_chunks, t_start=t_start)
    samp_dir, uniq = sample_grids(tr, root, latents, lat_dir, n_samples=args.n_samples,
                                  epochs=pr_epochs)
    files, vols = decode_grids(vq, root, samp_dir, epochs=vq_epochs, chunk=args.vq_chunk,
                               n_samples=args.n_samples)
    n_ok, diversity = verdict(files, vols, env, args.n_samples)

    result = {
        "tool": "quality_loop",
        "vq_epochs": vq_epochs,
        "val_ms_ssim": round(ms, 4),
        "prior_epochs": pr_epochs,
        "prior_val_ce": round(ce, 4),
        "n_samples": args.n_samples,
        "unique_grids": uniq,
        "samples_in_envelope": n_ok,
        "decoded_diversity": round(diversity, 4),
        "wall_s": round(time.time() - t_start, 1),
        "platform": platform,
    }
    print("QUALITY LOOP OK")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

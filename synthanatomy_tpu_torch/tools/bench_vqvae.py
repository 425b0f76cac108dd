"""Stage-1 benchmark (the JAX package's BASELINE.md configs 1-2).

Port of ``tools/bench_vqvae.py``, at the paper geometry (160×224×160,
4 levels, 256 channels, codebook 2048×32, 3 slim residual layers, bf16):

- config 1: extract + decode round trip (``index_quantize`` then
  ``decode_samples``, the residual layers off the fused kernel as in the
  forward-only CLI modes; ``--fused_recon`` ablates), volumes/min;
- config 2: the train step (``make_vqvae_train_step``, ``--loss``),
  optionally with D (``--adversarial [--adaptive] [--grouped_bn]``) and
  the device augmentation chain before it (``--device_augment``: every
  transform fired, the 3-pass resampler unless ``--gather_augment``);
  ``--remat`` and ``--fused_res`` toggle checkpointing and the fused
  residual kernel.

Flags as JAX's (``--batch=N --loss=mse --levels=4 --shape='(D,H,W)'
--train --recon``), plus ``--device`` (a CUDA ordinal, or ``cpu``).  On
the card every rate is printed with the card's name and power limit
(``nvidia-smi``).

    python -m synthanatomy_tpu_torch.tools.bench_vqvae [--batch=3 --adversarial --device_augment]
"""

from __future__ import annotations

import subprocess
import sys
import time
from contextlib import nullcontext
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["main"]

SCHED = {"lr": 3e-4, "d_lr": 5e-4, "decay": 0.5, "commitment_cost": 0.25, "gdl_factor": 0.0,
         "epoch": 0}


def card_tag(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    host's name on the CPU)."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        out = f"{torch.cuda.get_device_name(device)}, power limit not read"
    return out


def _device(kw) -> torch.device:
    dev = kw.get("device", 0)
    if str(dev) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device=cpu to run on the CPU")
    return torch.device("cuda", int(dev))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    from synthanatomy_tpu_torch.cli import parse_argv
    from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE
    from synthanatomy_tpu_torch.train.vqvae_steps import (
        create_vqvae_train_state,
        make_vqvae_train_step,
    )

    _, kw = parse_argv(sys.argv[1:] if argv is None else argv)
    device = _device(kw)
    batch = int(kw.get("batch", 1))
    loss = kw.get("loss", "mse")
    levels = int(kw.get("levels", 4))
    shape = tuple(kw.get("shape", (160, 224, 160)))
    train = bool(kw.get("train", True))
    recon = bool(kw.get("recon", True))
    adversarial = bool(kw.get("adversarial", False))
    adaptive = bool(kw.get("adaptive", False))
    grouped_bn = bool(kw.get("grouped_bn", False))
    dev_aug = bool(kw.get("device_augment", False))
    tag_card = card_tag(device)
    results: Dict[str, float] = {}

    model = BaselineVQVAE(
        n_levels=levels, downsample_parameters=((4, 2, 1, 1),) * levels,
        upsample_parameters=((4, 2, 1, 0, 1),) * levels, n_embed=2048, embed_dim=32,
        n_channels=256, n_res_channels=256, n_res_layers=3, dtype=torch.bfloat16,
        use_remat=bool(kw.get("remat", True)),
        # --fused_res=False ablates the fused residual-layer kernel
        use_fused_residual=None if bool(kw.get("fused_res", True)) else False,
        generator=torch.Generator().manual_seed(0), device=device,
    )

    if recon:
        # config 1: the extraction + decoding round trip, forward only
        x = torch.from_numpy(np.random.default_rng(0).uniform(size=(1, 1) + shape)
                             .astype(np.float32)).to(device)

        def roundtrip():
            idx = model.index_quantize(x)
            out = model.decode_samples(idx)
            # consume the volume on the device: its host copy is not the
            # round trip's cost
            return idx[0], out.float().sum()

        with torch.no_grad(), (model.unfused() if not kw.get("fused_recon") else nullcontext()):
            t0 = time.perf_counter()
            idx, out = roundtrip()
            float(out)
            print(f"[recon] first call {time.perf_counter() - t0:.1f}s")
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                idx, out = roundtrip()
            float(out)
            dt = (time.perf_counter() - t0) / reps
        results["recon_ms"] = dt * 1e3
        print(f"[recon] {shape} extract+decode: {dt * 1e3:.1f} ms/vol → "
              f"{60 / dt:.1f} volumes/min; latent {tuple(idx.shape)}  [{tag_card}]")

    if train:
        # config 2 / 2b: the train step
        d_model = None
        if adversarial:
            from synthanatomy_tpu_torch.models.discriminator import BaselineDiscriminator

            d_model = BaselineDiscriminator(dtype=torch.bfloat16, use_split_bn=grouped_bn,
                                            generator=torch.Generator().manual_seed(1),
                                            device=device)
        state = create_vqvae_train_state(model, 0, learning_rate=3e-4, d_model=d_model,
                                         device=device)
        base = make_vqvae_train_step(model, loss_name=loss, d_model=d_model,
                                     use_adaptive_weight=adaptive, d_grouped_stats=grouped_bn)
        step = base
        if dev_aug:
            from synthanatomy_tpu_torch.data.transforms import VQVAETransform
            from synthanatomy_tpu_torch.ops.augment import augment_batch, shear_shift_bounds

            tf = VQVAETransform(augment=True, augmentation_probability=1.0)
            drawn = [tf.draw_device_params(shape, np.random.default_rng(i))[0]
                     for i in range(batch)]
            aug = {k: np.stack([p[k] for p in drawn]) for k in drawn[0]}
            # the 3-pass resampler unless --gather_augment (the exact gather)
            shifts = (None if kw.get("gather_augment")
                      else shear_shift_bounds(shape, **tf.affine_ranges()))
            print(f"[augment] resampler shifts: {shifts}")

            def step(s, xb, sc, lp=None):
                return base(s, augment_batch(xb[:, 0], aug, shifts)[:, None], sc, lp)

        lpips_params = None
        from synthanatomy_tpu_torch.losses import vqvae as vqvae_losses

        if vqvae_losses.loss_needs_lpips(loss):
            from synthanatomy_tpu_torch.losses.lpips import init_lpips_params

            lpips_params = init_lpips_params(vqvae_losses.lpips_net_for_loss(loss),
                                             generator=torch.Generator().manual_seed(7),
                                             device=device)
        xb = torch.from_numpy(np.random.default_rng(1).uniform(size=(batch, 1) + shape)
                              .astype(np.float32)).to(device)
        t0 = time.perf_counter()
        state, metrics = step(state, xb, SCHED, lpips_params)
        print(f"[train] first call {time.perf_counter() - t0:.1f}s "
              f"loss={float(metrics['Loss-Reconstruction-Total']):.4f}")
        reps = 3
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            state, metrics = step(state, xb, SCHED, lpips_params)
        loss_value = float(metrics["Loss-Reconstruction-Total"])
        _sync(device)
        dt = (time.perf_counter() - t0) / reps
        tag = "+adv" if adversarial else ""
        tag += "+adaptive" if adaptive else ""
        tag += "+groupedBN" if grouped_bn else ""
        tag += "+devaug" if dev_aug else ""
        results["train_ms"] = dt * 1e3
        results["train_loss"] = loss_value
        print(f"[train{tag}] batch={batch} loss={loss}: {dt * 1e3:.0f} ms/step → "
              f"{batch / dt:.2f} volumes/s  [{tag_card}]")
    return results


if __name__ == "__main__":
    main()

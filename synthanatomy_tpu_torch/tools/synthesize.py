"""One-command brain synthesis.

Port of ``tools/synthesize.py``: loads a trained Performer prior and
VQ-VAE from their experiment directories
(``{project}/{experiment}/performer`` and ``.../baseline_vqvae``) and
generates NIfTI volumes through ``pipeline.make_synthesizer``: the
sampled grids stay on the device between the stages, in place of the
two-step ``run_transformer --mode=inference`` →
``run_vqvae --mode=decoding`` flow.  Writes ``synth_NNNN.nii.gz`` (and
``synth_NNNN_latents.npy`` with ``--save_latents``) and logs volumes/min.

    python -m synthanatomy_tpu_torch.tools.synthesize run \\
      --project_directory=/experiments --experiment_name=brain \\
      --latent_shape='(10,14,10)' --num_volumes=8 --batch_size=8 \\
      --vocab_size=2048 --n_embd=512 --n_layers=24 --n_head=16 \\
      --local_attn_heads=8 --local_window_size=420 --use_rezero=True \\
      --spatial_position_emb=absolute \\
      --no_levels=4 --no_channels=256 \\
      --num_embeddings='(2048,)' --embedding_dim='(32,)' \\
      --output_directory=/experiments/brain/synthesis

Runs on the card (``--device=N`` picks ``cuda:N``); ``--device=cpu``
runs on the host.  Without a card and without ``--device=cpu`` it raises.
"""

from __future__ import annotations

import os
import time
from typing import Union

import numpy as np
import torch

from synthanatomy_tpu_torch.cli import dispatch

__all__ = ["run"]


def run(
    project_directory: str = "",
    experiment_name: str = "",
    output_directory: str = "",
    latent_shape=(10, 14, 10),
    num_volumes: int = 8,
    batch_size: int = 8,
    temperature: float = 1.0,
    top_k=None,
    sample: bool = True,
    seed: int = 2,
    ordering_type: str = "raster_scan",
    evaluation_checkpoint: str = "recent",
    save_latents: bool = True,
    # conditioned priors (reference performer.py:252-264): one token
    # index per conditioning variable, e.g. --conditioning_values='(2,0)',
    # applied to every generated volume; needs the
    # --conditioning_num_tokens=... the prior was trained with
    conditioning_values=None,
    device: Union[int, str] = 0,
    # network flags of both stages (TransformerConfig and VQVAEConfig)
    **network_flags,
):
    from synthanatomy_tpu_torch.config import TransformerConfig, VQVAEConfig
    from synthanatomy_tpu_torch.data.nifti import save_nifti
    from synthanatomy_tpu_torch.pipeline import make_synthesizer
    from synthanatomy_tpu_torch.runners.transformer import build_ordering, build_performer
    from synthanatomy_tpu_torch.runners.vqvae import build_vqvae
    from synthanatomy_tpu_torch.train import checkpoints as C
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state
    from synthanatomy_tpu_torch.train.vqvae_steps import create_vqvae_train_state
    from synthanatomy_tpu_torch.utils.general import run_device, setup_logger

    logger = setup_logger("synthesize")
    t_flags = {k: v for k, v in network_flags.items()
               if k in TransformerConfig.__dataclass_fields__}
    v_flags = {k: v for k, v in network_flags.items() if k in VQVAEConfig.__dataclass_fields__}
    t_cfg = TransformerConfig(
        ordering_type=ordering_type, temperature=temperature, top_k=top_k,
        sample=sample, seed=seed, mode="inference", device=device, **t_flags,
    )
    v_cfg = VQVAEConfig(mode="decoding", adversarial_component=False, device=device, **v_flags)
    dev = run_device(t_cfg)

    latent_shape = tuple(int(s) for s in latent_shape)
    ordering = build_ordering(t_cfg, latent_shape)
    performer = build_performer(t_cfg, ordering, latent_shape, device=dev,
                                generator=torch.Generator().manual_seed(seed))
    vqvae = build_vqvae(v_cfg, device=dev, generator=torch.Generator().manual_seed(seed + 1))

    t_ck, _ = C.check_for_checkpoints(
        os.path.join(project_directory, experiment_name, t_cfg.network, "checkpoints"),
        mode="inference", evaluation_checkpoint=evaluation_checkpoint,
    )
    v_ck, _ = C.check_for_checkpoints(
        os.path.join(project_directory, experiment_name, v_cfg.network, "checkpoints"),
        mode="decoding", evaluation_checkpoint=evaluation_checkpoint,
    )
    C.load_checkpoint(t_ck, create_transformer_train_state(performer, seed), models_only=True)
    C.load_checkpoint(v_ck, create_vqvae_train_state(vqvae, seed + 1, device=dev),
                      models_only=True)
    performer.eval()
    logger.info(f"Loaded prior {t_ck} and vqvae {v_ck}")

    conds = None
    if t_cfg.conditioning_num_tokens and conditioning_values is None:
        # a conditioned prior never saw the raw BOS embedding in training
        # (bos_replacement overwrites it every step): sampling it
        # unconditioned would be out of distribution
        raise ValueError(
            "the prior was trained with conditioning_num_tokens="
            f"{t_cfg.conditioning_num_tokens!r}; pass "
            "--conditioning_values=(v0,...) to sample from it"
        )
    if conditioning_values is not None:
        vals = conditioning_values
        if isinstance(vals, (int, float)):
            vals = (vals,)
        n_tok = t_cfg.conditioning_num_tokens or ()
        if len(vals) != len(n_tok):
            raise ValueError(
                f"conditioning_values has {len(vals)} entries but the "
                f"prior was built with conditioning_num_tokens={n_tok!r}"
            )
        conds = [torch.full((batch_size,), int(v), dtype=torch.int32, device=dev)
                 for v in vals]
        logger.info(f"conditioning on token indices {tuple(vals)}")

    synth = make_synthesizer(
        performer, vqvae, ordering, batch=batch_size,
        temperature=temperature, top_k=top_k, do_sample=sample,
        with_conditionings=conds is not None,
    )
    os.makedirs(output_directory or ".", exist_ok=True)
    written = []
    generator = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    # decoding is forward-only: the residual layers run unfused, as the
    # stage-1 CLI's decoding does
    with vqvae.unfused():
        for b in range(-(-num_volumes // batch_size)):
            volumes, grids = synth(generator, conds)
            volumes = volumes.float().cpu().numpy()
            grids = grids.cpu().numpy().astype(np.uint16)
            for i in range(volumes.shape[0]):
                idx = b * batch_size + i
                if idx >= num_volumes:
                    break
                out = os.path.join(output_directory, f"synth_{idx:04d}.nii.gz")
                save_nifti(out, volumes[i, 0])
                written.append(out)
                if save_latents:
                    np.save(os.path.join(output_directory, f"synth_{idx:04d}_latents.npy"),
                            grids[i])
    dt = time.perf_counter() - t0
    logger.info(
        f"Wrote {len(written)} volumes in {dt:.1f}s "
        f"({len(written) * 60 / dt:.1f} volumes/min)"
    )
    return written


if __name__ == "__main__":
    dispatch({"run": run})

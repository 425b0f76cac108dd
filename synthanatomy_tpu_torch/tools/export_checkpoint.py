"""Export a model of the port as a reference-layout torch state dict
(``.pt``): the inverse of the converters.

Port of ``tools/export_checkpoint.py``.  The source is a checkpoint the
port's CLIs wrote (``checkpoint_epoch=N``, one ``torch.save`` file, where
JAX reads an orbax directory) or a converter ``.npz`` of either package.
The tool builds the CLI's network from the flags (the runner's
``build_vqvae`` / ``build_performer`` on the CPU), loads the source into
it and writes ``interop.export_vqvae_state_dict`` /
``export_discriminator_state_dict`` / ``export_performer_state_dict``,
which the reference codebase ``torch.load``s (module naming of its
``BaselineVQVAE``, ``BaselineDiscriminator`` and performer-pytorch):

  python -m synthanatomy_tpu_torch.tools.export_checkpoint vqvae \\
      /exp/ukb/baseline_vqvae/checkpoints/checkpoint_epoch=100 vqvae.pt \\
      --no_levels=4 --no_channels=256 --num_embeddings='(2048,)' --embedding_dim='(32,)'
  python -m synthanatomy_tpu_torch.tools.export_checkpoint performer \\
      /exp/ukb/performer/checkpoints/checkpoint_epoch=50 performer.pt \\
      --vocab_size=2048 --n_embd=512 --n_layers=24 --n_head=16 \\
      --local_attn_heads=8 --local_window_size=420 --latent_shape='(10,14,10)'

The network flags are the CLIs' (``VQVAEConfig`` / ``TransformerConfig``
fields, plus ``--latent_shape`` for the prior), because a port checkpoint
holds state dicts and no tree to read the topology from; JAX's
``--n_levels``, ``--n_res_layers`` and ``--depth`` are taken as
``--no_levels``, ``--no_res_layers`` and ``--n_layers``.  The prior's form
(ReZero, spatial tables, conditioning, nb_features) is read from the
source, as ``import_checkpoint`` does.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Sequence

import torch

from synthanatomy_tpu_torch.tools.import_checkpoint import (
    config_flags,
    parse_flags,
    performer_form,
)

__all__ = ["export_model", "main"]

_JAX_NAMES = {"n_levels": "no_levels", "n_res_layers": "no_res_layers", "depth": "n_layers"}


def _source(src: str):
    """(kind of source, its arrays): ``"npz"`` and the flat converter map,
    or ``"checkpoint"`` and the port checkpoint's dict."""
    if src.endswith(".npz"):
        from synthanatomy_tpu_torch.tools.convert_checkpoint import load_npz_tree

        return "npz", load_npz_tree(src)
    try:
        return "checkpoint", torch.load(src, map_location="cpu", weights_only=True)
    except (OSError, RuntimeError, ValueError) as e:
        raise SystemExit(f"{src} is neither a .npz nor a port checkpoint ({e})") from None


def export_model(kind: str, src: str, **flags) -> Dict[str, torch.Tensor]:
    """The reference state dict of the ``kind`` network (``vqvae``,
    ``discriminator`` or ``performer``) held by ``src``."""
    from synthanatomy_tpu_torch import interop

    flags = {_JAX_NAMES.get(k, k): v for k, v in flags.items()}
    flags["device"] = "cpu"
    what, data = _source(src)
    gen = torch.Generator().manual_seed(0)

    if kind in ("vqvae", "discriminator"):
        from synthanatomy_tpu_torch.config import VQVAEConfig
        from synthanatomy_tpu_torch.runners import vqvae as runner

        cfg = VQVAEConfig(**config_flags(VQVAEConfig, flags))
        if kind == "vqvae":
            model = runner.build_vqvae(cfg, device="cpu", generator=gen)
            sd = (interop.vqvae_state_dict_from_jax(data["params"], data["vq"], cfg.no_levels,
                                                    cfg.no_res_layers)
                  if what == "npz" else data["model"])
            model.load_state_dict(sd, strict=True)
            return interop.export_vqvae_state_dict(model)
        model = runner._build_discriminator(cfg, device="cpu", generator=gen)
        if what == "npz":
            sd = interop.discriminator_state_dict_from_jax(data["params"], data["batch_stats"])
        elif data.get("d_model") is None:
            raise SystemExit(f"{src} carries no discriminator state (trained with "
                             "adversarial_component=False?)")
        else:
            sd = data["d_model"]
        model.load_state_dict(sd, strict=True)
        return interop.export_discriminator_state_dict(model)

    if kind == "performer":
        from synthanatomy_tpu_torch.config import TransformerConfig
        from synthanatomy_tpu_torch.runners import transformer as runner
        from synthanatomy_tpu_torch.tools.convert_checkpoint import flatten_tree

        latent_shape = tuple(flags.pop("latent_shape", (10, 14, 10)))
        if what == "npz":
            arrays = flatten_tree(data)
        else:
            arrays = data["model"]
        cfg_kwargs = config_flags(TransformerConfig, flags)
        for k, v in performer_form(arrays).items():
            cfg_kwargs.setdefault(k, v)
        cfg = TransformerConfig(mode="inference", **cfg_kwargs)
        model = runner.build_performer(cfg, runner.build_ordering(cfg, latent_shape),
                                       latent_shape, device="cpu", generator=gen)
        sd = (interop.performer_state_dict_from_jax(data["params"], data.get("favor", {}),
                                                    cfg.n_layers)
              if what == "npz" else data["model"])
        model.load_state_dict(sd, strict=True)
        return interop.export_performer_state_dict(model)
    raise SystemExit(f"unknown kind {kind}")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3:
        raise SystemExit("usage: export_checkpoint.py {vqvae|discriminator|performer} "
                         "<checkpoint-or-npz> out.pt [network flags]")
    kind, src, dst = argv[:3]
    sd = export_model(kind, src, **parse_flags(argv[3:]))
    torch.save(sd, dst)
    print(f"wrote {dst} ({len(sd)} tensors)")
    return sd


if __name__ == "__main__":
    main()

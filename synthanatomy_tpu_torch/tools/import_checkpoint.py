"""Turn converted reference weights (an ``.npz`` from
``convert_checkpoint`` / ``convert_performer_checkpoint``, of either
package) into a runnable experiment checkpoint of the port.

Port of ``tools/import_checkpoint.py``.  The reference ships its released
models as ``checkpoint_epoch=0.pt`` inside an experiment tree (reference
README.md:28).  This tool builds the CLI's own restore target (the
runner's ``build_vqvae`` / ``build_performer`` and
``create_*_train_state``, on the CPU), loads the network from the npz
(``interop.*_state_dict_from_jax``, every array used, shapes checked) and
writes ``checkpoint_epoch=0`` under ``{project}/{experiment}/{network}/
checkpoints`` in the port's format (one ``torch.save`` file, where JAX
writes an orbax directory).  The port's CLIs then drive the model:

  python -m synthanatomy_tpu_torch.tools.convert_checkpoint vqvae vqvae_ukb.pt v.npz \\
      --n_levels=4 --n_res_layers=3
  python -m synthanatomy_tpu_torch.tools.import_checkpoint vqvae v.npz \\
      --project_directory=/exp --experiment_name=ukb \\
      --no_levels=4 --no_channels=256 --num_embeddings='(2048,)' --embedding_dim='(32,)'
  python -m synthanatomy_tpu_torch.run_vqvae run --mode=extracting \\
      --project_directory=/exp --experiment_name=ukb ... (the same network flags)

  python -m synthanatomy_tpu_torch.tools.convert_performer_checkpoint perf.pt t.npz
  python -m synthanatomy_tpu_torch.tools.import_checkpoint performer t.npz \\
      --project_directory=/exp --experiment_name=ukb --vocab_size=2048 --n_embd=512 \\
      --n_layers=24 --n_head=16 --local_attn_heads=8 --local_window_size=420 \\
      --latent_shape='(10,14,10)'
  python -m synthanatomy_tpu_torch.run_transformer run --mode=inference ... (same flags)

The prior's form (ReZero, learned spatial tables, conditioning vocabulary
sizes, nb_features) is read from the npz, so the flags give only its
shape and topology.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["import_vqvae", "import_performer", "performer_form", "config_flags", "main"]


def config_flags(cls, flags: Dict[str, Any]) -> Dict[str, Any]:
    """The flags that are fields of the config dataclass ``cls``."""
    return {k: v for k, v in flags.items() if k in cls.__dataclass_fields__}


def performer_form(arrays: Dict[str, Any]) -> Dict[str, Any]:
    """The prior's form from its arrays, named as in a converter npz
    (``params/block_0/g_attn``) or as in the port's state dict
    (``blocks.0.g_attn``): TransformerConfig fields for ReZero, learned
    spatial tables, conditioning vocabulary sizes and nb_features."""
    import re

    form: Dict[str, Any] = {"use_rezero": any(re.search(r"[./]g_attn$", k) for k in arrays)}
    if any(re.match(r"(params/spatial_emb_\d+/|spatial_embs\.\d+\.)", k) for k in arrays):
        form["spatial_position_emb"] = "absolute"
    cond = {}
    for k, v in arrays.items():
        m = re.match(r"(?:params/conditioning_emb_|conditioning_embs\.)(\d+)[./]", k)
        if m:
            cond[int(m.group(1))] = int(np.shape(v)[0])
    if cond:
        form["conditioning_num_tokens"] = tuple(cond[i] for i in sorted(cond))
    for k, v in arrays.items():
        if re.search(r"(^favor/.*/projection|\.attn\.projection)$", k):
            form["nb_features"] = int(np.shape(v)[0])
            break
    return form


def _load_exactly(model: torch.nn.Module, sd: Dict[str, torch.Tensor], n_arrays: int, src: str):
    """``load_state_dict`` with every array of the npz used."""
    if len(sd) != n_arrays:
        raise SystemExit(f"{src} has {n_arrays} arrays but {len(sd)} map onto the model: "
                         "check the topology flags")
    try:
        model.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise SystemExit(f"{src} does not fit the model ({e}): check the topology flags") \
            from None


def _save(project, name, network, state) -> str:
    from synthanatomy_tpu_torch.train import checkpoints as C

    ckdir = os.path.join(project, name, network, "checkpoints")
    os.makedirs(ckdir, exist_ok=True)
    return C.save_checkpoint(ckdir, state, 0)


def _flat_and_tree(src: str):
    from synthanatomy_tpu_torch.tools.convert_checkpoint import unflatten_tree

    with np.load(src) as z:
        flat = {k: np.asarray(z[k]) for k in z.files}
    return flat, unflatten_tree(flat)


def import_vqvae(src: str, **flags) -> str:
    from synthanatomy_tpu_torch.config import VQVAEConfig
    from synthanatomy_tpu_torch.interop import vqvae_state_dict_from_jax
    from synthanatomy_tpu_torch.runners.vqvae import build_vqvae
    from synthanatomy_tpu_torch.train.vqvae_steps import create_vqvae_train_state

    project = flags.pop("project_directory")
    name = flags.pop("experiment_name")
    flags.pop("input_size", None)  # JAX's flax init shape; the port needs none
    cfg = VQVAEConfig(mode="decoding", adversarial_component=False,
                      **config_flags(VQVAEConfig, dict(flags, device="cpu")))
    model = build_vqvae(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    state = create_vqvae_train_state(model, 0, device="cpu")
    flat, tree = _flat_and_tree(src)
    sd = vqvae_state_dict_from_jax(tree["params"], tree["vq"], cfg.no_levels, cfg.no_res_layers)
    _load_exactly(model, sd, len(flat), src)
    path = _save(project, name, cfg.network, state)
    print(f"wrote {path} ({len(flat)} arrays)")
    return path


def import_performer(src: str, **flags) -> str:
    from synthanatomy_tpu_torch.config import TransformerConfig
    from synthanatomy_tpu_torch.interop import performer_state_dict_from_jax
    from synthanatomy_tpu_torch.runners.transformer import build_ordering, build_performer
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    project = flags.pop("project_directory")
    name = flags.pop("experiment_name")
    latent_shape = tuple(flags.pop("latent_shape", (10, 14, 10)))
    flat, tree = _flat_and_tree(src)
    form = performer_form(flat)
    cfg_kwargs = config_flags(TransformerConfig, dict(flags, device="cpu"))
    for k, v in form.items():  # the flags win where they are given
        cfg_kwargs.setdefault(k, v)
    cfg = TransformerConfig(mode="inference", **cfg_kwargs)
    model = build_performer(cfg, build_ordering(cfg, latent_shape), latent_shape, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    state = create_transformer_train_state(model, 0)
    sd = performer_state_dict_from_jax(tree["params"], tree.get("favor", {}), cfg.n_layers)
    _load_exactly(model, sd, len(flat), src)
    path = _save(project, name, cfg.network, state)
    print(f"wrote {path} ({len(flat)} arrays; rezero={form['use_rezero']} "
          f"spatial={'spatial_position_emb' in form} "
          f"cond={form.get('conditioning_num_tokens', ())} "
          f"nb_features={form.get('nb_features')})")
    return path


def parse_flags(tokens: Sequence[str]) -> Dict[str, Any]:
    """``--name=value`` tokens (Python literals) → a dict; a bare
    ``--name`` is True."""
    from synthanatomy_tpu_torch.cli import parse_value

    flags = {}
    for tok in tokens:
        if not tok.startswith("--"):
            raise SystemExit(f"unknown argument {tok!r}")
        k, _, v = tok[2:].partition("=")
        flags[k] = parse_value(v) if v else True
    return flags


def main(argv: Optional[Sequence[str]] = None) -> str:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        raise SystemExit("usage: import_checkpoint.py {vqvae|performer} in.npz "
                         "--project_directory=... --experiment_name=... [topology flags]")
    kind, src = argv[:2]
    flags = parse_flags(argv[2:])
    if "project_directory" not in flags or "experiment_name" not in flags:
        raise SystemExit("--project_directory and --experiment_name required")
    if kind == "vqvae":
        return import_vqvae(src, **flags)
    if kind == "performer":
        return import_performer(src, **flags)
    raise SystemExit(f"unknown kind {kind!r}")


if __name__ == "__main__":
    main()

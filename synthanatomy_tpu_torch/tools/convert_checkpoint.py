"""Convert released reference checkpoints to the converters' ``.npz``
layout.

Port of ``tools/convert_checkpoint.py``.  The reference releases
pretrained ``.pt`` checkpoints whose state dicts follow the module naming
of ``BaselineVQVAE`` (reference src/networks/vqvae/baseline.py:213-299)
and ``BaselineDiscriminator`` (src/networks/discriminator/baseline.py:
41-84).  This tool writes them as the JAX package's converter does: flat
``/``-joined flax names, DHWIO convolution kernels, so that a file from
either package's converter is interchangeable.  The port reads such a
file with ``interop.*_state_dict_from_jax`` (``tools/import_checkpoint``):

- ``Conv3d``          (O, I, D, H, W) → DHWIO
- ``ConvTranspose3d`` (I, O, D, H, W) → DHWIO (kernels stored in forward
  orientation)
- EMA codebook buffers ``impl.embedding.weight`` / ``impl.N`` /
  ``impl.embed_avg`` → ``vq/level_0/{codebook,cluster_size,embed_avg}``
- BatchNorm weight/bias/running stats → scale/bias + batch_stats

Usage:
  python -m synthanatomy_tpu_torch.tools.convert_checkpoint vqvae in.pt out.npz \\
      [--n_levels=N --n_res_layers=M --use_subpixel_conv=1]
  python -m synthanatomy_tpu_torch.tools.convert_checkpoint discriminator in.pt out.npz
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "convert_vqvae_state_dict",
    "convert_discriminator_state_dict",
    "load_torch_state_dict",
    "flatten_tree",
    "unflatten_tree",
    "load_npz_tree",
]


def _conv_w(w: np.ndarray) -> np.ndarray:
    """torch Conv3d (O, I, D, H, W) → DHWIO."""
    return np.transpose(w, (2, 3, 4, 1, 0))


def _convT_w(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose3d (I, O, D, H, W) → DHWIO."""
    return np.transpose(w, (2, 3, 4, 0, 1))


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pt`` checkpoint as numpy, loaded on the CPU: a raw state dict
    or the MONAI CheckpointSaver layout ({'network': ..., 'optimizer':
    ...}, reference run_vqvae.py:312-326)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "network" in obj:
        obj = obj["network"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "numpy")}


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays → ``{"a/b/c": array}``, keys in sorted
    order at every level (the order of JAX's tree flattening)."""
    flat: Dict[str, np.ndarray] = {}
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            flat.update(flatten_tree(tree[key], f"{path}/"))
        else:
            flat[path] = np.asarray(tree[key])
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The inverse of :func:`flatten_tree`."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def load_npz_tree(path: str) -> Dict[str, Any]:
    """A converter ``.npz`` as its nested tree."""
    with np.load(path) as z:
        return unflatten_tree({k: np.asarray(z[k]) for k in z.files})


def convert_vqvae_state_dict(
    sd: Dict[str, np.ndarray], *, n_levels: int, n_res_layers: int,
    use_subpixel_conv: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference BaselineVQVAE state dict → (params, vq) trees.

    Reference module indices (baseline.py:213-299):
      encoder.0: [Conv, ReLU, Seq(res…)] × levels + final Conv
      decoder.0: [Conv_in] + per level [Seq(res…), Upsample(, ReLU)]
      quantizer.0.impl: embedding.weight / N / embed_avg
    ResidualLayer Sequential indices: 0 = 3³ conv, 3 = 1³ conv.  The VQ
    state is a dict ``{"level_0": {codebook, cluster_size, embed_avg}}``
    (JAX: a ``VQState``; both flatten to the same keys).
    """
    params: Dict[str, Any] = {}

    def conv_entry(prefix: str) -> Dict[str, np.ndarray]:
        entry = {"kernel": _conv_w(sd[f"{prefix}.weight"])}
        if f"{prefix}.bias" in sd:
            entry["bias"] = sd[f"{prefix}.bias"]
        return entry

    def res_entry(prefix: str) -> Dict[str, Any]:
        return {"TorchConv3d_0": conv_entry(f"{prefix}.0"),
                "TorchConv3d_1": conv_entry(f"{prefix}.3")}

    for i in range(n_levels):
        params[f"encoder_conv_{i}"] = conv_entry(f"encoder.0.{3 * i}")
        for j in range(n_res_layers):
            params[f"encoder_res_{i}_{j}"] = res_entry(f"encoder.0.{3 * i + 2}.{j}")
    params["encoder_out_conv"] = conv_entry(f"encoder.0.{3 * n_levels}")

    params["decoder_in_conv"] = conv_entry("decoder.0.0")
    for i in range(n_levels):
        base = 1 + 3 * i
        for j in range(n_res_layers):
            params[f"decoder_res_{i}_{j}"] = res_entry(f"decoder.0.{base}.{j}")
        up_idx = base + 1
        if i == n_levels - 1 and use_subpixel_conv:
            params["decoder_subpixel"] = {
                "kernel": _conv_w(sd[f"decoder.0.{up_idx}.conv_block.weight"]),
                "bias": sd[f"decoder.0.{up_idx}.conv_block.bias"],
            }
        else:
            entry = {"kernel": _convT_w(sd[f"decoder.0.{up_idx}.weight"])}
            if f"decoder.0.{up_idx}.bias" in sd:
                entry["bias"] = sd[f"decoder.0.{up_idx}.bias"]
            params[f"decoder_up_{i}"] = entry

    vq = {"level_0": {
        "codebook": np.asarray(sd["quantizer.0.impl.embedding.weight"], np.float32),
        "cluster_size": np.asarray(sd["quantizer.0.impl.N"], np.float32),
        "embed_avg": np.asarray(sd["quantizer.0.impl.embed_avg"], np.float32),
    }}
    return params, vq


def convert_discriminator_state_dict(
    sd: Dict[str, np.ndarray], *, n_layers: int = 3
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference BaselineDiscriminator state dict → (params, batch_stats).
    ``main`` indices (discriminator/baseline.py:41-84): conv, lrelu, then
    per 1..n_layers-1 [conv, bn, lrelu], then [conv, bn, lrelu], final
    conv."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}

    def conv(prefix, name):
        entry = {"kernel": _conv_w(sd[f"{prefix}.weight"])}
        if f"{prefix}.bias" in sd:
            entry["bias"] = sd[f"{prefix}.bias"]
        params[name] = entry

    def bn(prefix, name):
        params[name] = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
        batch_stats[name] = {"mean": sd[f"{prefix}.running_mean"],
                             "var": sd[f"{prefix}.running_var"]}

    conv("main.0", "conv_0")
    idx = 2
    for n in range(1, n_layers):
        conv(f"main.{idx}", f"conv_{n}")
        bn(f"main.{idx + 1}", f"norm_{n}")
        idx += 3
    conv(f"main.{idx}", f"conv_{n_layers}")
    bn(f"main.{idx + 1}", f"norm_{n_layers}")
    idx += 3
    conv(f"main.{idx}", "conv_out")
    return params, batch_stats


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3:
        raise SystemExit("usage: convert_checkpoint.py {vqvae|discriminator} in.pt out.npz "
                         "[--n_levels=N --n_res_layers=M]")
    kind, src, dst = argv[:3]
    kwargs = {}
    for tok in argv[3:]:
        if tok.startswith("--"):
            k, v = tok[2:].split("=")
            kwargs[k] = int(v) if v.isdigit() else v
    sd = load_torch_state_dict(src)
    if kind == "vqvae":
        params, vq = convert_vqvae_state_dict(
            sd, n_levels=int(kwargs.get("n_levels", 3)),
            n_res_layers=int(kwargs.get("n_res_layers", 3)),
            use_subpixel_conv=bool(kwargs.get("use_subpixel_conv", False)))
        tree = {"params": params, "vq": vq}
    elif kind == "discriminator":
        params, bs = convert_discriminator_state_dict(sd)
        tree = {"params": params, "batch_stats": bs}
    else:
        raise SystemExit(f"unknown kind {kind}")
    np.savez(dst, **flatten_tree(tree))
    print(f"wrote {dst}")


if __name__ == "__main__":
    main()

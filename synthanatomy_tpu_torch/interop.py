"""Carry trained weights from the JAX package into the port.

``performer_from_jax``, ``vqvae_from_jax``, ``discriminator_from_jax`` and
``vq_layer_from_jax`` take the JAX variables as numpy trees (``jax.device_get`` of the flax
variables) and return port modules loaded with ``strict=True``, on the
card unless ``device`` says otherwise; ``lpips_from_jax`` carries an
LPIPS parameter tree.  The transposes (the port's own copies of those
``synthanatomy_tpu/interop.py`` validated against torch layouts):

- Dense kernel (in, out) → Linear weight (out, in);
- Conv kernel DHWIO → Conv3d weight (O, I, D, H, W);
- ConvTranspose kernel, forward-oriented DHWIO → ConvTranspose3d
  weight (I, O, D, H, W).

The other direction, for the end-of-training release artifact
``model_state_dict_epoch={N}.pt`` (reference run_vqvae.py:389-392):
``export_vqvae_state_dict`` and ``export_discriminator_state_dict`` read
the port's modules and return the reference's state-dict layout
(``encoder.0.*``, ``decoder.0.*``, ``quantizer.0.impl.*``; ``main.*``),
and ``export_performer_state_dict`` the performer-pytorch layout
(``performer.net.layers.*``), as JAX's ``synthanatomy_tpu/interop.py``
exports do; the port's weights are already in torch's layouts, so only
the names change.
``save_raw_state_dict`` writes one with ``torch.save``.

No JAX is imported: the VQ state is read through its ``.codebook``
attribute (a ``VQState``) or as a plain dict, the LPIPS tree through
its ``.net`` / ``.lin`` / ``.kind`` attributes or as a dict.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from synthanatomy_tpu_torch.losses.lpips import lpips_params_from_numpy
from synthanatomy_tpu_torch.models.discriminator import BaselineDiscriminator
from synthanatomy_tpu_torch.models.performer import Performer
from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE

__all__ = ["discriminator_from_jax", "discriminator_state_dict_from_jax",
           "export_discriminator_state_dict", "export_performer_state_dict",
           "export_vqvae_state_dict", "lpips_from_jax", "performer_from_jax",
           "performer_state_dict_from_jax", "save_raw_state_dict", "vq_layer_from_jax",
           "vqvae_from_jax", "vqvae_state_dict_from_jax"]


def _conv_w_inv(w) -> np.ndarray:
    """DHWIO → torch Conv3d (O, I, D, H, W)."""
    return np.transpose(np.asarray(w), (4, 3, 0, 1, 2))


def _convT_w_inv(w) -> np.ndarray:
    """DHWIO (forward orientation) → torch ConvTranspose3d (I, O, D, H, W)."""
    return np.transpose(np.asarray(w), (3, 4, 0, 1, 2))


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _lin(sd, prefix, entry):
    sd[f"{prefix}.weight"] = _t(np.asarray(entry["kernel"]).T)
    if "bias" in entry:
        sd[f"{prefix}.bias"] = _t(entry["bias"])


def performer_from_jax(
    params: Dict[str, Any], favor: Dict[str, Any], depth: int, **config
) -> Performer:
    """Flax ``Performer`` variables → loaded port ``Performer``.

    ``config`` holds the port constructor's remaining arguments (heads,
    dim_head, local heads and window, ReZero, ScaleNorm, GLU, position
    and spatial embeddings, ordering, conditioning); vocabulary and width
    are read from the embedding shapes, and the sequence length from the
    learned positional table or, where the model has none (fixed, axial
    and rotary embeddings), from ``config["max_seq_len"]``."""
    num_tokens, dim = np.asarray(params["token_emb"]["embedding"]).shape
    if "abs_pos_emb" in params:
        max_seq_len = np.asarray(params["abs_pos_emb"]["embedding"]).shape[0]
        if config.get("conditioning_type") == "prepending":
            max_seq_len -= len(config["conditioning_num_tokens"])
        config.pop("max_seq_len", None)
    else:
        max_seq_len = config.pop("max_seq_len")
    if "axial_emb_0" in params:
        config.setdefault("axial_position_shape", (np.asarray(params["axial_emb_0"]).shape[0],
                                                   np.asarray(params["axial_emb_1"]).shape[1]))
    config.setdefault("device", "cuda")
    model = Performer(num_tokens, max_seq_len, dim, depth, **config)
    model.load_state_dict(performer_state_dict_from_jax(params, favor, depth), strict=True)
    return model


def performer_state_dict_from_jax(params: Dict[str, Any], favor: Dict[str, Any],
                                  depth: int) -> Dict[str, torch.Tensor]:
    """Flax ``Performer`` variables → the port ``Performer``'s state dict
    (one tensor per array; f32)."""
    sd = {
        "token_emb.weight": _t(params["token_emb"]["embedding"]),
        "final_norm.weight": _t(params["final_norm"]["scale"]),
        "final_norm.bias": _t(params["final_norm"]["bias"]),
    }
    if "abs_pos_emb" in params:
        sd["abs_pos_emb.weight"] = _t(params["abs_pos_emb"]["embedding"])
    for key in ("axial_emb_0", "axial_emb_1"):
        if key in params:
            sd[key] = _t(params[key])
    for key in params:
        m = re.match(r"(spatial|conditioning)_emb_(\d+)$", key)
        if m:
            sd[f"{m.group(1)}_embs.{m.group(2)}.weight"] = _t(params[key]["embedding"])
    if "to_out" in params:
        _lin(sd, "to_out", params["to_out"])
    for i in range(depth):
        blk = params[f"block_{i}"]
        p = f"blocks.{i}"
        for name in ("to_q", "to_k", "to_v", "to_out"):
            _lin(sd, f"{p}.attn.{name}", blk["attn"][name])
        _lin(sd, f"{p}.ff.w1", blk["ff"]["w1"])
        _lin(sd, f"{p}.ff.w2", blk["ff"]["w2"])
        if "g_attn" in blk:
            sd[f"{p}.g_attn"] = _t(blk["g_attn"]).reshape(1)
            sd[f"{p}.g_ff"] = _t(blk["g_ff"]).reshape(1)
        else:
            for norm in ("norm_attn", "norm_ff"):
                if "g" in blk[norm]:  # ScaleNorm
                    sd[f"{p}.{norm}.g"] = _t(blk[norm]["g"]).reshape(1)
                else:
                    sd[f"{p}.{norm}.weight"] = _t(blk[norm]["scale"])
                    sd[f"{p}.{norm}.bias"] = _t(blk[norm]["bias"])
        if f"block_{i}" in favor:
            sd[f"{p}.attn.projection"] = _t(favor[f"block_{i}"]["attn"]["projection"])
    return sd


def vqvae_from_jax(
    params: Dict[str, Any], vq: Dict[str, Any], n_levels: int, n_res_layers: int,
    **config,
) -> BaselineVQVAE:
    """Flax ``BaselineVQVAE`` variables (``params``, ``vq``) → loaded port
    ``BaselineVQVAE``.  ``config`` holds the remaining constructor
    arguments (down/upsample parameters, dtype, sub-pixel, remat, fused
    residual, device, ...); codebook size, embedding width and channel
    counts are read from the shapes.  Weights stay f32, as flax keeps
    them; the model computes in ``dtype``."""
    get = _state_getter(vq["level_0"])
    n_embed, embed_dim = np.asarray(get("codebook")).shape
    n_channels = np.asarray(params["decoder_in_conv"]["kernel"]).shape[-1]
    n_res_channels = np.asarray(params["decoder_res_0_0"]["TorchConv3d_0"]["kernel"]).shape[-1]
    dtype = config.pop("dtype", torch.bfloat16)
    config.setdefault("device", "cuda")
    model = BaselineVQVAE(
        n_levels=n_levels, n_embed=n_embed, embed_dim=embed_dim,
        n_channels=n_channels, n_res_channels=n_res_channels,
        n_res_layers=n_res_layers, dtype=dtype, **config,
    )
    model.load_state_dict(vqvae_state_dict_from_jax(params, vq, n_levels, n_res_layers),
                          strict=True)
    return model


def _state_getter(state):
    """Reads a VQ state given as a ``VQState`` or as a dict."""
    return (lambda k: getattr(state, k)) if hasattr(state, "codebook") else state.__getitem__


def vqvae_state_dict_from_jax(params: Dict[str, Any], vq: Dict[str, Any], n_levels: int,
                              n_res_layers: int) -> Dict[str, torch.Tensor]:
    """Flax ``BaselineVQVAE`` variables → the port ``BaselineVQVAE``'s
    state dict (one tensor per array; f32).  The last up-sampler is the
    sub-pixel convolution where ``params`` holds ``decoder_subpixel``."""
    get = _state_getter(vq["level_0"])
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix, entry, transposed=False):
        w = entry["kernel"]
        sd[f"{prefix}.weight"] = _t(_convT_w_inv(w) if transposed else _conv_w_inv(w))
        sd[f"{prefix}.bias"] = _t(entry["bias"])

    def res(prefix, entry):
        conv(f"{prefix}.conv1", entry["TorchConv3d_0"])
        conv(f"{prefix}.conv2", entry["TorchConv3d_1"])

    for i in range(n_levels):
        conv(f"encoder_convs.{i}", params[f"encoder_conv_{i}"])
        for j in range(n_res_layers):
            res(f"encoder_res.{i}.{j}", params[f"encoder_res_{i}_{j}"])
        for j in range(n_res_layers):
            res(f"decoder_res.{i}.{j}", params[f"decoder_res_{i}_{j}"])
        if i == n_levels - 1 and "decoder_subpixel" in params:
            conv(f"decoder_ups.{i}", params["decoder_subpixel"])
        else:
            conv(f"decoder_ups.{i}", params[f"decoder_up_{i}"], transposed=True)
    conv("encoder_out_conv", params["encoder_out_conv"])
    conv("decoder_in_conv", params["decoder_in_conv"])
    for k in ("codebook", "cluster_size", "embed_avg"):
        sd[f"vq.{k}"] = _t(get(k))
    return sd


def vq_layer_from_jax(variables: Dict[str, Any], **config):
    """Flax ``VectorQuantizerEMA`` variables (``{"vq": {"ema": VQState}}``,
    the state as a ``VQState`` or a dict) → loaded port
    ``models.vq_layer.VectorQuantizerEMA``.  ``config`` holds the
    remaining constructor arguments (commitment cost, decay, epsilon,
    ``use_pallas``, device); codebook size and width are read from the
    shapes."""
    from synthanatomy_tpu_torch.models.vq_layer import VectorQuantizerEMA

    get = _state_getter(variables["vq"]["ema"])
    num_embeddings, embedding_dim = np.asarray(get("codebook")).shape
    config.setdefault("device", "cuda")
    layer = VectorQuantizerEMA(num_embeddings, embedding_dim, **config)
    layer.load_state_dict({f"ema.{k}": _t(get(k)) for k in ("codebook", "cluster_size",
                                                              "embed_avg")}, strict=True)
    return layer


def discriminator_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any],
                           **config) -> BaselineDiscriminator:
    """Flax ``BaselineDiscriminator`` variables (``params``,
    ``batch_stats``) → loaded port ``BaselineDiscriminator``.  ``config``
    holds ``dtype``, ``use_split_bn`` and ``device``; channel counts and
    depth are read from the tree."""
    k0 = np.asarray(params["conv_0"]["kernel"])
    n_layers = sum(1 for k in params if k.startswith("norm_"))
    config.setdefault("device", "cuda")
    model = BaselineDiscriminator(input_nc=k0.shape[3], ndf=k0.shape[4], n_layers=n_layers,
                                  **config)
    model.load_state_dict(discriminator_state_dict_from_jax(params, batch_stats), strict=True)
    return model


def discriminator_state_dict_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """Flax ``BaselineDiscriminator`` variables → the port
    ``BaselineDiscriminator``'s state dict (f32)."""
    n_layers = sum(1 for k in params if k.startswith("norm_"))
    sd: Dict[str, torch.Tensor] = {}
    for name in ["conv_0", *(f"conv_{n}" for n in range(1, n_layers + 1)), "conv_out"]:
        sd[f"{name}.weight"] = _t(_conv_w_inv(params[name]["kernel"]))
        if "bias" in params[name]:
            sd[f"{name}.bias"] = _t(params[name]["bias"])
    for n in range(1, n_layers + 1):
        for k in ("scale", "bias"):
            sd[f"norm_{n}.{k}"] = _t(params[f"norm_{n}"][k])
        for k in ("mean", "var"):
            sd[f"norm_{n}.{k}"] = _t(batch_stats[f"norm_{n}"][k])
    return sd


def lpips_from_jax(params, device="cuda") -> Dict[str, Any]:
    """A JAX ``LPIPSParams`` (or its dict form) → the port's LPIPS tree."""
    if isinstance(params, dict):
        net, lin, kind = params["net"], params["lin"], params.get("kind", "alex")
    else:
        net, lin, kind = params.net, params.lin, params.kind
    return lpips_params_from_numpy({"net": net, "lin": lin}, kind, device)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).contiguous()


def _put_conv(sd, prefix, conv):
    sd[f"{prefix}.weight"] = _f32(conv.weight)
    if conv.bias is not None:
        sd[f"{prefix}.bias"] = _f32(conv.bias)


def export_vqvae_state_dict(model: BaselineVQVAE) -> Dict[str, torch.Tensor]:
    """Port ``BaselineVQVAE`` → reference BaselineVQVAE state dict
    (module naming of reference src/networks/vqvae/baseline.py:213-299;
    JAX: ``synthanatomy_tpu/interop.py::export_vqvae_state_dict``)."""
    sd: Dict[str, torch.Tensor] = {}
    n_levels = model.n_levels

    def put(prefix, conv):
        _put_conv(sd, prefix, conv)

    def put_res(prefix, layer):
        put(f"{prefix}.0", layer.conv1)
        put(f"{prefix}.3", layer.conv2)

    for i in range(n_levels):
        put(f"encoder.0.{3 * i}", model.encoder_convs[i])
        for j, layer in enumerate(model.encoder_res[i]):
            put_res(f"encoder.0.{3 * i + 2}.{j}", layer)
    put(f"encoder.0.{3 * n_levels}", model.encoder_out_conv)

    put("decoder.0.0", model.decoder_in_conv)
    for i in range(n_levels):
        base = 1 + 3 * i
        for j, layer in enumerate(model.decoder_res[i]):
            put_res(f"decoder.0.{base}.{j}", layer)
        if i == n_levels - 1 and model.use_subpixel_conv:
            put(f"decoder.0.{base + 1}.conv_block", model.decoder_ups[i])
        else:
            put(f"decoder.0.{base + 1}", model.decoder_ups[i])

    sd["quantizer.0.impl.embedding.weight"] = _f32(model.vq.codebook)
    sd["quantizer.0.impl.N"] = _f32(model.vq.cluster_size)
    sd["quantizer.0.impl.embed_avg"] = _f32(model.vq.embed_avg)
    return sd


def export_discriminator_state_dict(model: BaselineDiscriminator) -> Dict[str, torch.Tensor]:
    """Port ``BaselineDiscriminator`` → reference state dict
    (src/networks/discriminator/baseline.py:41-84)."""
    sd: Dict[str, torch.Tensor] = {}

    def put_conv(prefix, conv):
        _put_conv(sd, prefix, conv)

    def put_bn(prefix, bn):
        sd[f"{prefix}.weight"] = _f32(bn.scale)
        sd[f"{prefix}.bias"] = _f32(bn.bias)
        sd[f"{prefix}.running_mean"] = _f32(bn.mean)
        sd[f"{prefix}.running_var"] = _f32(bn.var)

    put_conv("main.0", model.conv_0)
    idx = 2
    for n in range(1, model.n_layers + 1):
        put_conv(f"main.{idx}", getattr(model, f"conv_{n}"))
        put_bn(f"main.{idx + 1}", getattr(model, f"norm_{n}"))
        idx += 3
    put_conv(f"main.{idx}", model.conv_out)
    return sd


def export_performer_state_dict(model: Performer) -> Dict[str, torch.Tensor]:
    """Port ``Performer`` → performer-pytorch state dict with the
    reference wrapper nesting (JAX:
    ``synthanatomy_tpu/interop.py::export_performer_state_dict``):
    pre-LayerNorm blocks as ``.0.fn.norm`` + ``.0.fn.fn.`` attention and
    ``.1.fn.fn.fn.`` Chunk-wrapped FF; ReZero blocks with the wrapper's
    ``g`` gain (a 0-d tensor) in place of the norm at the same nesting
    position; each FAVOR layer's projection buffer as
    ``fast_attention.projection_matrix``, which performer-pytorch
    registers persistently.  ScaleNorm blocks have no reference form and
    raise ``NotImplementedError``."""
    sd: Dict[str, torch.Tensor] = {"token_emb.weight": _f32(model.token_emb.weight)}

    def lin(prefix, layer):
        sd[f"{prefix}.weight"] = _f32(layer.weight)
        if layer.bias is not None:
            sd[f"{prefix}.bias"] = _f32(layer.bias)

    def norm(prefix, ln):
        sd[f"{prefix}.norm.weight"] = _f32(ln.weight)
        sd[f"{prefix}.norm.bias"] = _f32(ln.bias)

    if hasattr(model, "abs_pos_emb"):
        sd["pos_emb.emb.weight"] = _f32(model.abs_pos_emb.weight)
    # JAX walks its parameter names in sorted order: the conditioning
    # tables come before the spatial ones
    for i, emb in enumerate(getattr(model, "conditioning_embs", ())):
        sd[f"conditioning_emb.{i}.weight"] = _f32(emb.weight)
    for i, emb in enumerate(getattr(model, "spatial_embs", ())):
        sd[f"spatial_position_emb.{i}.emb.weight"] = _f32(emb.weight)

    for i, blk in enumerate(model.blocks):
        if not blk.use_rezero and not isinstance(blk.norm_attn, torch.nn.LayerNorm):
            raise NotImplementedError(
                "export supports pre-LayerNorm and ReZero blocks only "
                "(ScaleNorm has no reference-checkpoint form)")
        p = f"performer.net.layers.{i}"
        if blk.use_rezero:
            sd[f"{p}.0.fn.g"] = _f32(blk.g_attn).reshape(())
        else:
            norm(f"{p}.0.fn", blk.norm_attn)
        for name in ("to_q", "to_k", "to_v", "to_out"):
            lin(f"{p}.0.fn.fn.{name}", getattr(blk.attn, name))
        if getattr(blk.attn, "projection", None) is not None:
            sd[f"{p}.0.fn.fn.fast_attention.projection_matrix"] = _f32(blk.attn.projection)
        if blk.use_rezero:
            sd[f"{p}.1.fn.g"] = _f32(blk.g_ff).reshape(())
        else:
            norm(f"{p}.1.fn", blk.norm_ff)
        lin(f"{p}.1.fn.fn.fn.w1", blk.ff.w1)
        lin(f"{p}.1.fn.fn.fn.w2", blk.ff.w2)

    sd["norm.weight"] = _f32(model.final_norm.weight)
    sd["norm.bias"] = _f32(model.final_norm.bias)
    if not model.tie_embed:
        lin("to_out", model.to_out)
    return sd


def save_raw_state_dict(path: str, sd: Dict[str, torch.Tensor]) -> str:
    """Write the reference's one-file release artifact ``{path}.pt``,
    a state dict the reference codebase ``torch.load``s directly."""
    out = f"{path}.pt"
    torch.save(sd, out)
    return out

"""Stage-1 network: the 3D VQ-VAE, NCDHW.

Port of ``synthanatomy_tpu/models/vqvae.py`` (``BaselineVQVAE``):
``encode``, ``quantize``, ``decode``, ``index_quantize``,
``decode_samples`` and ``forward`` (JAX's ``__call__``), with the EMA
codebook as buffers of ``self.vq`` (ops/vq.py).  Convolutions run as
``F.conv3d`` / ``F.conv_transpose3d`` (cuDNN on the card) in ``dtype``,
with weights kept in f32 and cast per call, and each bias added after
its convolution in ``dtype``, as JAX's ``TorchConv3d`` rounds.  The slim
residual layer takes the fused kernel (ops/res_stack.py) where JAX takes
its Pallas kernel: ``use_fused=None`` fuses on the card in remat
training at ≥ ``_FUSED_MIN_VOXELS`` voxels (``SYNTH_FUSED_MIN_VOXELS``
overrides), with no active dropout; True/False force the route.  A
fused layer hands the kernels their layout (``kernel_layout``:
channels-last volumes on the tensor-core tile route), and what follows
it runs on that layout.  ``use_remat`` checkpoints each residual layer
(``torch.utils.checkpoint``, non-reentrant), as JAX's ``nn.remat`` does.
``use_pallas_vq`` routes the nearest-codeword search as JAX's does:
None (and True) take ``ops.vq.nearest_codeword``, the kernel on a CUDA
tensor; False forces its plain version on any device.

Layout is NCDHW (PyTorch's), against the reference's NDHWC; tests
permute when they compare.  The codebook stays f32.  TF32: the module
sets no global flag; at f32 cuDNN uses TF32 while
``torch.backends.cudnn.allow_tf32`` is True (PyTorch's default), so a
caller that wants f32 agreement with the reference turns it off, as
``chip_smoke.py`` does.

Random draws (dropout) come from an explicit ``torch.Generator``; under
remat each layer's mask is drawn from a seed taken outside the
checkpoint, so the recompute draws the same mask.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from synthanatomy_tpu_torch.ops import vq as vq_ops
from synthanatomy_tpu_torch.ops.res_stack import (
    fused_residual_layer,
    kernel_layout,
    supports_fused_residual,
)
from synthanatomy_tpu_torch.ops.vq import VQState, embed_indices

__all__ = ["BaselineVQVAE", "ResidualLayer", "SubpixelUpsample3d", "TorchConv3d",
           "TorchConvTranspose3d"]

# the fused residual layer's auto gate (JAX's models/vqvae.py:55)
_FUSED_MIN_VOXELS = int(os.environ.get("SYNTH_FUSED_MIN_VOXELS", 500_000))


def _add_bias(y, bias):
    return y if bias is None else y + bias.to(y.dtype)[:, None, None, None]


class TorchConv3d(nn.Conv3d):
    """Conv3d with torch (k, s, p, dil) semantics: f32 weights, computed
    in ``dtype``, bias added after the convolution in ``dtype``."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, dilation=1, bias=True,
                 *, dtype=torch.bfloat16, device="cuda"):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding,
                         dilation=dilation, bias=bias, dtype=torch.float32, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv3d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
                     self.dilation)
        return _add_bias(y, self.bias)


class TorchConvTranspose3d(nn.ConvTranspose3d):
    """ConvTranspose3d with torch (k, s, p, out_p, dil) semantics; as
    :class:`TorchConv3d`."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, output_padding=0,
                 dilation=1, *, dtype=torch.bfloat16, device="cuda"):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding,
                         output_padding=output_padding, dilation=dilation,
                         dtype=torch.float32, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose3d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
                               self.output_padding, 1, self.dilation)
        return _add_bias(y, self.bias)


class SubpixelUpsample3d(TorchConv3d):
    """3×3×3 conv to ``features·scale³`` channels, then depth-to-space
    (JAX's ``ops/conv3d.py::subpixel_upsample3d``: output channel
    (i, j, k, c) goes to voxel offset (i, j, k) of channel c)."""

    def __init__(self, cin, features, scale, *, dtype=torch.bfloat16, device="cuda"):
        super().__init__(cin, features * scale ** 3, 3, padding=1, dtype=dtype, device=device)
        self.features, self.scale = features, scale

    def forward(self, x):
        h = super().forward(x)
        n, _, d, hh, w = h.shape
        r, c = self.scale, self.features
        h = h.reshape(n, r, r, r, c, d, hh, w).permute(0, 4, 5, 1, 6, 2, 7, 3)
        return h.reshape(n, c, d * r, hh * r, w * r)


def _dropout(h, rate, seed):
    """JAX's ``nn.Dropout``: keep with probability 1 − rate, scale kept
    values by 1/(1 − rate); the mask comes from ``seed``."""
    gen = torch.Generator(device=h.device).manual_seed(seed)
    keep = torch.rand(h.shape, generator=gen, device=h.device) >= rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros((), dtype=h.dtype, device=h.device))


class ResidualLayer(nn.Module):
    """Conv3d(3³, pad 1) → ReLU → Dropout → Conv3d(1³, or 3³ when not
    slim), then relu(x + ·); the fused kernel where the gate passes (see
    the module docstring)."""

    def __init__(self, channels, res_channels, dropout=0.0, slim=True, *,
                 dtype=torch.bfloat16, use_fused: Optional[bool] = None, device="cuda"):
        super().__init__()
        self.channels, self.res_channels = channels, res_channels
        self.dropout, self.slim, self.use_fused = dropout, slim, use_fused
        self.dtype = dtype
        self.conv1 = TorchConv3d(channels, res_channels, 3, padding=1, dtype=dtype, device=device)
        self.conv2 = TorchConv3d(res_channels, channels, 1 if slim else 3,
                                 padding=0 if slim else 1, dtype=dtype, device=device)

    def fused(self, x, deterministic: bool) -> bool:
        """Whether this call takes the fused kernel (JAX's routing)."""
        fused = self.use_fused if self.use_fused is not None else x.is_cuda
        if self.use_fused is None:
            fused = fused and x.shape[2] * x.shape[3] * x.shape[4] >= _FUSED_MIN_VOXELS
        no_dropout = self.dropout == 0.0 or deterministic
        return bool(fused and self.slim and no_dropout and x.shape[1] == self.channels
                    and supports_fused_residual(x.shape, self.res_channels))

    def forward(self, x, *, deterministic: bool = True, seed: Optional[int] = None):
        if self.fused(x, deterministic):
            # in the kernels' layout (channels-last on the tile route): y
            # keeps it, so a stack of fused layers converts its input once
            x = kernel_layout(x.to(self.dtype), self.res_channels)
            return fused_residual_layer(x, self.conv1.weight, self.conv1.bias,
                                        self.conv2.weight, self.conv2.bias)
        h = torch.relu(self.conv1(x))
        if self.dropout > 0.0 and not deterministic:
            if seed is None:
                raise ValueError("active dropout needs a generator")
            h = _dropout(h, self.dropout, seed)
        return torch.relu(x + self.conv2(h))


class BaselineVQVAE(nn.Module):
    """See module docstring.  Volumes are (B, 1, D, H, W)."""

    def __init__(
        self,
        n_levels: int = 3,
        downsample_parameters: Tuple[Tuple[int, int, int, int], ...] = ((4, 2, 1, 1),) * 3,
        upsample_parameters: Tuple[Tuple[int, int, int, int, int], ...] = ((4, 2, 1, 0, 1),) * 3,
        n_embed: int = 256,
        embed_dim: int = 256,
        n_channels: int = 144,
        n_res_channels: int = 144,
        n_res_layers: int = 3,
        dropout: float = 0.0,
        use_slim_residual: bool = True,
        use_subpixel_conv: bool = False,
        embedding_init: str = "normal",
        dtype: torch.dtype = torch.bfloat16,
        use_fused_residual: Optional[bool] = None,
        use_remat: bool = False,
        use_pallas_vq: Optional[bool] = None,
        *,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        self.n_levels = n_levels
        self.n_embed = n_embed
        self.embed_dim = embed_dim
        self.use_subpixel_conv = use_subpixel_conv
        self.use_remat = use_remat
        self.use_pallas_vq = use_pallas_vq
        self.dtype = dtype
        # auto fuses only the rematerialized training form (JAX's policy)
        if use_fused_residual is None:
            layer_fused = None if use_remat else False
        else:
            layer_fused = use_fused_residual
        kw = dict(dtype=dtype, device=device)

        def res_stack(ch, res_ch):
            return nn.ModuleList([ResidualLayer(ch, res_ch, dropout, use_slim_residual,
                                                use_fused=layer_fused, **kw)
                                  for _ in range(n_res_layers)])

        enc_convs, enc_res = [], []
        cin = 1
        for i in range(n_levels):
            k, s, p, dil = downsample_parameters[i]
            ch = n_channels // (1 if i == n_levels - 1 else 2)  # C deepest, C/2 above
            enc_convs.append(TorchConv3d(cin, ch, k, s, p, dil, **kw))
            enc_res.append(res_stack(ch, n_res_channels // (1 if i == n_levels - 1 else 2)))
            cin = ch
        self.encoder_convs = nn.ModuleList(enc_convs)
        self.encoder_res = nn.ModuleList(enc_res)
        self.encoder_out_conv = TorchConv3d(cin, embed_dim, 3, padding=1, **kw)

        self.decoder_in_conv = TorchConv3d(embed_dim, n_channels, 3, padding=1, **kw)
        dec_res, dec_ups = [], []
        for i in range(n_levels):
            ch = n_channels // (1 if i == 0 else 2)
            dec_res.append(res_stack(ch, n_res_channels // (1 if i == 0 else 2)))
            last = i == n_levels - 1
            k, s, p, op, dil = upsample_parameters[i]
            out_ch = 1 if last else n_channels // 2
            if last and use_subpixel_conv:
                dec_ups.append(SubpixelUpsample3d(ch, out_ch, s, **kw))
            else:
                dec_ups.append(TorchConvTranspose3d(ch, out_ch, k, s, p, op, dil, **kw))
        self.decoder_res = nn.ModuleList(dec_res)
        self.decoder_ups = nn.ModuleList(dec_ups)
        self.vq = VQState(n_embed, embed_dim, embedding_init, generator=generator,
                          device=device)
        self.diagnostics: Dict[str, torch.Tensor] = {}
        if generator is not None:
            self._init_convs(generator)

    @torch.no_grad()
    def _init_convs(self, gen: torch.Generator) -> None:
        """Seeded torch-default conv init: U(±1/√fan_in), zero bias."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
                w = mod.weight
                bound = w[0].numel() ** -0.5  # torch's fan_in for both kinds
                w.copy_((torch.rand(w.shape, generator=gen) * 2 - 1) * bound)
                mod.bias.zero_()

    def _res(self, layer: ResidualLayer, x, deterministic: bool, generator):
        seed = None
        if layer.dropout > 0.0 and not deterministic and generator is not None:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        if self.use_remat and torch.is_grad_enabled():
            return checkpoint(lambda t: layer(t, deterministic=deterministic, seed=seed), x,
                              use_reentrant=False)
        return layer(x, deterministic=deterministic, seed=seed)

    def encode(self, images, *, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """volumes (B, 1, D, H, W) → [latents (B, embed_dim, d, h, w)] in ``dtype``."""
        x = images.to(self.dtype)
        for i in range(self.n_levels):
            x = torch.relu(self.encoder_convs[i](x))
            for res in self.encoder_res[i]:
                x = self._res(res, x, deterministic, generator)
        return [self.encoder_out_conv(x)]

    def quantize(self, encodings: List[torch.Tensor], *, decay=0.5, commitment_cost=0.25,
                 training: bool = False, process_group=None):
        """→ ``([quantized (B, C, d, h, w)], [commitment loss], [indices
        (B, d, h, w)])``; updates the EMA codebook when ``training``, from
        the statistics of every rank of ``process_group`` (JAX's
        ``axis_name``), which the perplexity also covers."""
        z = encodings[0].permute(0, 2, 3, 4, 1)  # the VQ works channels-last
        q, loss, idx, _ = vq_ops.quantize_ema(self.vq, z, decay=decay,
                                              commitment_cost=commitment_cost,
                                              training=training,
                                              plain=self.use_pallas_vq is False,
                                              process_group=process_group)
        self.diagnostics["perplexity"] = vq_ops.perplexity(idx, self.n_embed, process_group)
        return [q.permute(0, 4, 1, 2, 3).to(self.dtype)], [loss], [idx]

    def decode(self, quantizations: List[torch.Tensor], *, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[codes (B, C, d, h, w)] → volumes (B, 1, D, H, W); no output
        activation.  Outside ``deterministic`` the last layer's input is
        kept in ``diagnostics["last_layer_input"]`` for the adaptive
        adversarial weight."""
        x = self.decoder_in_conv(quantizations[0].to(self.dtype))
        for i in range(self.n_levels):
            for res in self.decoder_res[i]:
                x = self._res(res, x, deterministic, generator)
            if i == self.n_levels - 1 and not deterministic:
                self.diagnostics["last_layer_input"] = x
            x = self.decoder_ups[i](x)
            if i != self.n_levels - 1:
                x = torch.relu(x)
        return x

    def index_quantize(self, images) -> List[torch.Tensor]:
        """encode → nearest-codeword indices [(B, d, h, w) int32] (the
        extraction path)."""
        enc = self.encode(images, deterministic=True)[0]
        flat = enc.float().permute(0, 2, 3, 4, 1).reshape(-1, self.embed_dim)
        search = (vq_ops.nearest_codeword_plain if self.use_pallas_vq is False
                  else vq_ops.nearest_codeword)
        idx = search(flat, self.vq.codebook)
        return [idx.reshape(enc.shape[0], *enc.shape[2:])]

    def decode_samples(self, embedding_indices: List[torch.Tensor]) -> torch.Tensor:
        """[indices (B, d, h, w)] → embed → decode."""
        codes = embed_indices(self.vq, embedding_indices[0])  # (B, d, h, w, C) f32
        return self.decode([codes.permute(0, 4, 1, 2, 3).to(self.dtype)])

    def forward(self, images, *, decay=0.5, commitment_cost=0.25, training: bool = False,
                generator: Optional[torch.Generator] = None,
                process_group=None) -> Dict[str, List[torch.Tensor]]:
        enc = self.encode(images, deterministic=not training, generator=generator)
        q, losses, _ = self.quantize(enc, decay=decay, commitment_cost=commitment_cost,
                                     training=training,
                                     process_group=process_group if training else None)
        recon = self.decode(q, deterministic=not training, generator=generator)
        return {"reconstruction": [recon], "quantization_losses": losses}

    @contextlib.contextmanager
    def unfused(self):
        """Run the residual layers off the fused kernel inside the block
        (JAX's ``model.clone(use_fused_residual=False)`` for the
        forward-only evaluator, whose parameters are the same)."""
        layers = [m for m in self.modules() if isinstance(m, ResidualLayer)]
        saved = [layer.use_fused for layer in layers]
        for layer in layers:
            layer.use_fused = False
        try:
            yield self
        finally:
            for layer, flag in zip(layers, saved):
                layer.use_fused = flag

    def last_layer_name(self) -> str:
        """JAX's name of the final decoder submodule, whose kernel the
        adaptive adversarial weight differentiates (``last_layer`` is the
        module)."""
        if self.use_subpixel_conv:
            return "decoder_subpixel"
        return f"decoder_up_{self.n_levels - 1}"

    def last_layer(self) -> nn.Module:
        return self.decoder_ups[self.n_levels - 1]

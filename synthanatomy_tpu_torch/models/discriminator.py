"""3D PatchGAN discriminator, NCDHW.

Port of ``synthanatomy_tpu/models/discriminator.py``: Conv3d(k4, s2, p1)
→ LeakyReLU(0.2), ``n_layers − 1`` stride-2 blocks doubling the filters
(capped at 8·ndf) with batch norm, a stride-1 block, and a 1-channel
patch map.  DCGAN init: conv kernels N(0, 0.02), zero biases, batch-norm
scales N(1, 0.02).  Convolutions compute in ``dtype`` (bf16 by default)
from f32 weights; batch norm computes its statistics in f32, keeps f32
running statistics (``mean``, ``var``) and updates them in place with
flax's momentum 0.9 and biased variance, where PyTorch's ``BatchNorm3d``
would use the unbiased one.  ``stat_groups=2`` (with
``use_split_bn``) normalises each half of the batch by its own
statistics and updates the running ones half by half, as two forwards
would.  With a ``process_group`` (data parallelism) each group's moments
are those of the global batch, as GSPMD gives JAX: the f32 per-group
sums, sums of squares and counts are summed over the ranks (an
all-reduce that autograd differentiates), so every rank normalises alike
and keeps the same running statistics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from synthanatomy_tpu_torch.models.vqvae import TorchConv3d
from synthanatomy_tpu_torch.parallel.distributed import all_reduce_sum

__all__ = ["BaselineDiscriminator", "SplitBatchNorm"]


class _DCGANConv3d(TorchConv3d):
    """TorchConv3d whose seeded init is DCGAN's N(0, 0.02) kernel, zero bias."""

    @torch.no_grad()
    def dcgan_init(self, gen: torch.Generator) -> None:
        self.weight.copy_(torch.randn(self.weight.shape, generator=gen) * 0.02)
        if self.bias is not None:
            self.bias.zero_()


class SplitBatchNorm(nn.Module):
    """Batch norm with f32 statistics per batch group (``groups=1``:
    plain batch norm, as flax's ``nn.BatchNorm``).  Parameters ``scale``,
    ``bias``; buffers ``mean``, ``var`` (JAX's ``batch_stats``)."""

    def __init__(self, channels: int, *, momentum: float = 0.9, epsilon: float = 1e-5,
                 dtype=torch.bfloat16, split: bool = False, device="cuda"):
        super().__init__()
        self.momentum, self.epsilon, self.dtype, self.split = momentum, epsilon, dtype, split
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x, *, training: bool, groups: int = 1, process_group=None):
        shp = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if not training:
            inv = torch.rsqrt(self.var + self.epsilon)
            return ((xf - self.mean.reshape(shp)) * (inv * self.scale).reshape(shp)
                    + self.bias.reshape(shp)).to(self.dtype)
        b = x.shape[0]
        if b % groups:
            raise ValueError(f"batch {b} does not split into {groups} groups")
        xg = xf.reshape(groups, b // groups, *x.shape[1:])
        axes = (1,) + tuple(range(3, xg.dim()))  # batch + spatial of each group
        if process_group is None:
            mean = xg.mean(axes)  # (groups, C)
            var = torch.square(xg).mean(axes) - torch.square(mean)
        else:  # the global batch's moments, group by group
            c = x.shape[1]
            n = torch.full((groups, 1), float(xg[0, :, 0].numel()), device=x.device)
            sums = all_reduce_sum(torch.cat([xg.sum(axes), torch.square(xg).sum(axes), n], 1),
                                  process_group)
            mean = sums[:, :c] / sums[:, 2 * c:]
            var = sums[:, c:2 * c] / sums[:, 2 * c:] - torch.square(mean)
        if not self.split:  # flax clips the fast variance at zero
            var = var.clamp_min(0.0)
        inv = torch.rsqrt(var + self.epsilon)
        gshp = (groups, 1, -1) + (1,) * (x.dim() - 2)
        if self.split:
            y = (xg - mean.reshape(gshp)) * inv.reshape(gshp) * self.scale.reshape(gshp[1:])
        else:
            y = (xg - mean.reshape(gshp)) * (inv * self.scale).reshape(gshp)
        y = y + self.bias.reshape(gshp[1:])
        with torch.no_grad():
            m = self.momentum
            for g in range(groups):  # sequential, in group order
                self.mean.copy_(m * self.mean + (1 - m) * mean[g])
                self.var.copy_(m * self.var + (1 - m) * var[g])
        return y.reshape(x.shape).to(self.dtype)


class BaselineDiscriminator(nn.Module):
    """x (B, input_nc, D, H, W) → patch logits (B, 1, D', H', W')."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3,
                 dtype=torch.bfloat16, use_split_bn: bool = False, *,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        self.n_layers, self.use_split_bn = n_layers, use_split_bn
        kw = dict(dtype=dtype, device=device)
        self.conv_0 = _DCGANConv3d(input_nc, ndf, 4, 2, 1, **kw)
        cin = ndf
        for n in range(1, n_layers + 1):
            cout = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv_{n}", _DCGANConv3d(cin, cout, 4, stride, 1, bias=False, **kw))
            self.add_module(f"norm_{n}", SplitBatchNorm(cout, dtype=dtype, split=use_split_bn,
                                                        device=device))
            cin = cout
        self.conv_out = _DCGANConv3d(cin, 1, 4, 1, 1, **kw)
        if generator is not None:
            with torch.no_grad():
                for mod in self.modules():
                    if isinstance(mod, _DCGANConv3d):
                        mod.dcgan_init(generator)
                    elif isinstance(mod, SplitBatchNorm):
                        mod.scale.copy_(1.0 + 0.02 * torch.randn(mod.scale.shape,
                                                                  generator=generator))

    def forward(self, x, *, training: bool = False, stat_groups: int = 1,
                process_group=None):
        """``stat_groups > 1`` (needs ``use_split_bn``) computes train-mode
        statistics per batch group: the one-pass fake + real variant.
        ``process_group``: train-mode statistics over every rank's batch."""
        if stat_groups > 1 and not self.use_split_bn:
            raise ValueError("stat_groups>1 requires use_split_bn=True")
        groups = stat_groups if training else 1
        h = F.leaky_relu(self.conv_0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{n}")(h)
            h = F.leaky_relu(getattr(self, f"norm_{n}")(h, training=training, groups=groups,
                                                         process_group=process_group), 0.2)
        h = self.conv_out(h)
        if 0 in h.shape:
            raise ValueError(f"discriminator patch map is empty ({tuple(h.shape)}): input "
                             f"spatial dims {tuple(x.shape[2:])} are too small for "
                             f"{self.n_layers} stride-2 k4 levels")
        return h

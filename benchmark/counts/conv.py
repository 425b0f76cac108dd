"""3D convolutions counted from shapes: 2·Cin·Cout·k³ operations an
output voxel (a transposed convolution: an input voxel), each input,
weight and output read or written once."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple


def conv3d(b: int, cin: int, cout: int, k: int, out_vox: int, in_vox: int, elem: int = 2):
    flops = 2 * b * cin * cout * k ** 3 * out_vox
    return flops, elem * (b * cin * in_vox + cin * cout * k ** 3 + b * cout * out_vox)


def conv_transpose3d(b, cin, cout, k, in_vox, out_vox, elem: int = 2):
    flops = 2 * b * cin * cout * k ** 3 * in_vox
    return flops, elem * (b * cin * in_vox + cin * cout * k ** 3 + b * cout * out_vox)


def _up(n: int, k: int, s: int, p: int, op: int, dil: int) -> int:
    return (n - 1) * s - 2 * p + dil * (k - 1) + op + 1


def vqvae_decoder_layers(cfg: dict, latent: Sequence[int]) -> List[Tuple[str, tuple]]:
    """The decoder's convolutions, in order, for codes on the ``latent``
    grid: ("conv", (cin, cout, k, out_vox, in_vox)) or ("convT", (cin,
    cout, k, in_vox, out_vox)).  Levels as the VQ-VAE lays them out: C
    channels at the deepest level, C/2 above (residual channels alike);
    slim residual layers, 3³ then 1³."""
    c, n = cfg["no_channels"], cfg["no_levels"]
    r = cfg.get("no_res_channels", c)
    dims = list(latent)
    vox = math.prod(dims)
    layers = [("conv", (cfg["embedding_dim"][0], c, 3, vox, vox))]
    for i in range(n):
        ch = c if i == 0 else c // 2
        rc = r if i == 0 else r // 2
        for _ in range(cfg["no_res_layers"]):
            layers.append(("conv", (ch, rc, 3, vox, vox)))
            layers.append(("conv", (rc, ch, 1, vox, vox)))
        k, s, p, op, dil = cfg["upsample_parameters"][i]
        out = 1 if i == n - 1 else c // 2
        dims = [_up(d, k, s, p, op, dil) for d in dims]
        layers.append(("convT", (ch, out, k, vox, math.prod(dims))))
        vox = math.prod(dims)
    return layers


def vqvae_decode(cfg: dict, latent: Sequence[int], batch: int, elem: int = 2):
    """(flops, bytes) of decoding ``batch`` code grids, the codebook rows
    read once."""
    flops = nbytes = 0
    for kind, a in vqvae_decoder_layers(cfg, latent):
        fn = conv3d if kind == "conv" else conv_transpose3d
        f, by = fn(batch, *a, elem=elem)
        flops += f
        nbytes += by
    nbytes += 4 * batch * math.prod(latent) * cfg["embedding_dim"][0]
    return flops, nbytes


def residual_layer(b: int, c: int, r: int, vox: int, elem: int = 2):
    """(flops, bytes) of one slim residual layer's forward,
    relu(x + conv1³(relu(conv3³(x)))), on ``b`` volumes of ``vox`` voxels:
    x read once, the output written once, the two kernels' weights read."""
    flops = 2 * b * vox * (c * r * 27 + r * c)
    return flops, elem * (2 * b * c * vox + c * r * 28)


def decoder_level_voxels(cfg: dict, latent: Sequence[int]) -> List[Tuple[int, int, int]]:
    """(channels, residual channels, voxels) of each decoder level's
    residual layers."""
    out = []
    for kind, a in vqvae_decoder_layers(cfg, latent):
        if kind == "conv" and a[2] == 3 and a[0] != cfg["embedding_dim"][0]:
            out.append((a[0], a[1], a[3]))
    return out[::cfg["no_res_layers"]]

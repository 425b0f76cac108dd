"""LPIPS (Learned Perceptual Image Patch Similarity), NCHW.

Port of ``synthanatomy_tpu/losses/lpips.py``: the AlexNet ('alex') and
SqueezeNet ('squeeze') feature extractors, the LPIPS linear heads and
``lpips_distance``, over a plain parameter tree:

    {"kind": "alex" | "squeeze",
     "net": {name: {"w": (cout, cin, kh, kw), "b": (cout,)}, ...}
            (squeeze: {"fireN": {"squeeze" | "expand1" | "expand3": {...}}}),
     "lin": {"lin<i>": {"w": (C_i,)}}}

``init_lpips_params`` draws fixed random features (no pretrained weights
are fetched), as the JAX package does here; ``load_lpips_npz`` reads the
JAX package's ``.npz`` layout (HWIO kernels, flat 'a/b/c' keys);
``interop.lpips_from_jax`` carries a JAX parameter tree over.
Features run in the input's dtype, normalisation and aggregation in f32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "ALEX_CHANNELS",
    "SQUEEZE_CHANNELS",
    "init_lpips_params",
    "load_lpips_npz",
    "lpips_distance",
    "lpips_params_from_numpy",
]

ALEX_CHANNELS = (64, 192, 384, 256, 256)
SQUEEZE_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
_ALEX_SPECS = (("conv1", 11, 3, 64), ("conv2", 5, 64, 192), ("conv3", 3, 192, 384),
               ("conv4", 3, 384, 256), ("conv5", 3, 256, 256))
_FIRE_SPECS = (("fire1", 64, 16, 64), ("fire2", 128, 16, 64), ("fire3", 128, 32, 128),
               ("fire4", 256, 32, 128), ("fire5", 256, 48, 192), ("fire6", 384, 48, 192),
               ("fire7", 384, 64, 256), ("fire8", 512, 64, 256))

# lpips ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _conv_init(gen, k, cin, cout, device):
    bound = 1.0 / math.sqrt(k * k * cin)  # torch Conv2d default: U(±1/√fan_in)
    w = (torch.rand(cout, cin, k, k, generator=gen) * 2 - 1) * bound
    b = (torch.rand(cout, generator=gen) * 2 - 1) * bound
    return {"w": w.to(device), "b": b.to(device)}


def init_lpips_params(net: str = "alex", *, generator: Optional[torch.Generator] = None,
                      device="cuda") -> Dict[str, Any]:
    """Fixed random LPIPS parameters for ``net`` ∈ {'alex', 'squeeze'}."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params: Dict[str, Any] = {"kind": net, "net": {}, "lin": {}}
    if net == "alex":
        for name, k, cin, cout in _ALEX_SPECS:
            params["net"][name] = _conv_init(gen, k, cin, cout, device)
        chans = ALEX_CHANNELS
    elif net == "squeeze":
        params["net"]["conv1"] = _conv_init(gen, 3, 3, 64, device)
        for name, cin, sq, ex in _FIRE_SPECS:
            params["net"][name] = {
                "squeeze": _conv_init(gen, 1, cin, sq, device),
                "expand1": _conv_init(gen, 1, sq, ex, device),
                "expand3": _conv_init(gen, 3, sq, ex, device),
            }
        chans = SQUEEZE_CHANNELS
    else:
        raise ValueError(f"unknown lpips net {net!r}")
    for i, c in enumerate(chans):  # non-negative heads, as the shipped weights
        w = ((torch.rand(c, generator=gen) * 2 - 1) * 0.1).abs()
        params["lin"][f"lin{i}"] = {"w": w.to(device)}
    return params


def lpips_params_from_numpy(tree: Dict[str, Any], kind: str, device="cuda") -> Dict[str, Any]:
    """A JAX-layout numpy tree ({"net": ..., "lin": ...}: HWIO kernels,
    lin heads (1, 1, C, 1)) → the port's tree."""

    def conv(entry):
        if "w" in entry:
            w = np.transpose(np.asarray(entry["w"], np.float32), (3, 2, 0, 1))
            return {"w": torch.tensor(w, device=device),
                    "b": torch.tensor(np.asarray(entry["b"], np.float32), device=device)}
        return {k: conv(v) for k, v in entry.items()}

    lin = {k: {"w": torch.tensor(np.asarray(v["w"], np.float32).reshape(-1), device=device)}
           for k, v in tree["lin"].items()}
    return {"kind": kind, "net": {k: conv(v) for k, v in tree["net"].items()}, "lin": lin}


def load_lpips_npz(path: str, device="cuda") -> Dict[str, Any]:
    """Parameters saved by the JAX package as flat 'a/b/c' keys in an npz."""
    tree: Dict[str, Any] = {}
    kind = "alex"
    for k, v in np.load(path).items():
        if k == "kind":
            kind = str(v)
            continue
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return lpips_params_from_numpy(tree, kind, device)


def _conv2d(x, p, stride=1, padding=0):
    y = F.conv2d(x, p["w"].to(x.dtype), None, stride, padding)
    return y + p["b"].to(x.dtype)[:, None, None]


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


def _alex_features(net, x) -> List[torch.Tensor]:
    taps = []
    h = torch.relu(_conv2d(x, net["conv1"], 4, 2))
    taps.append(h)
    h = torch.relu(_conv2d(_maxpool(h), net["conv2"], padding=2))
    taps.append(h)
    h = torch.relu(_conv2d(_maxpool(h), net["conv3"], padding=1))
    taps.append(h)
    h = torch.relu(_conv2d(h, net["conv4"], padding=1))
    taps.append(h)
    h = torch.relu(_conv2d(h, net["conv5"], padding=1))
    taps.append(h)
    return taps


def _fire(p, x):
    s = torch.relu(_conv2d(x, p["squeeze"]))
    return torch.cat([torch.relu(_conv2d(s, p["expand1"])),
                      torch.relu(_conv2d(s, p["expand3"], padding=1))], dim=1)


def _squeeze_features(net, x) -> List[torch.Tensor]:
    taps = []
    h = torch.relu(_conv2d(x, net["conv1"], 2))
    taps.append(h)
    h = _fire(net["fire2"], _fire(net["fire1"], _maxpool(h)))
    taps.append(h)
    h = _fire(net["fire4"], _fire(net["fire3"], _maxpool(h)))
    taps.append(h)
    h = _fire(net["fire5"], _maxpool(h))
    taps.append(h)
    for name in ("fire6", "fire7", "fire8"):
        h = _fire(net[name], h)
        taps.append(h)
    return taps


def _normalize_tensor(feat, eps=1e-10):
    f = feat.float()
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


def lpips_distance(params: Dict[str, Any], x: torch.Tensor, y: torch.Tensor, *,
                   normalize: bool = True) -> torch.Tensor:
    """LPIPS distance per batch element.  x, y: (N, C, H, W) with C ∈ {1,
    3}, in [0, 1] when ``normalize`` (else in [-1, 1]) → (N,) f32."""
    if x.shape[2] < 16 or x.shape[3] < 16:
        raise ValueError(f"LPIPS needs spatial dims >= 16, got {tuple(x.shape[2:])}: the "
                         "backbone pooling would produce empty feature maps (NaN).")
    if normalize:
        x, y = 2.0 * x - 1.0, 2.0 * y - 1.0
    if x.shape[1] == 1:
        x, y = x.expand(-1, 3, -1, -1), y.expand(-1, 3, -1, -1)
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)[:, None, None]
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)[:, None, None]
    x, y = (x - shift) / scale, (y - shift) / scale
    feats = _alex_features if params["kind"] == "alex" else _squeeze_features
    total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for i, (a, b) in enumerate(zip(feats(params["net"], x), feats(params["net"], y))):
        d = torch.square(_normalize_tensor(a) - _normalize_tensor(b))  # (N, C, H, W)
        w = params["lin"][f"lin{i}"]["w"].float()
        total = total + torch.einsum("nchw,c->nhw", d, w).mean(dim=(1, 2))
    return total

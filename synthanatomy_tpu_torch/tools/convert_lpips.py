"""Convert official LPIPS weights (the pip ``lpips`` package and
torchvision) to the ``.npz`` layout that
``synthanatomy_tpu_torch.losses.lpips.load_lpips_npz`` reads (and the
JAX package's ``load_lpips_npz``: port of ``tools/convert_lpips.py``,
writing the same file).

Inputs (torch state dicts, loaded on the CPU):
- the backbone's features: torchvision ``alexnet`` / ``squeezenet1_1``
  (``features.*`` conv weights), and
- the LPIPS linear heads: the pip package's ``lpips/weights/v0.1/
  {alex,squeeze}.pth`` (keys ``lin{i}.model.1.weight``).

Conv2d (O, I, H, W) → HWIO.

Usage:
  python -m synthanatomy_tpu_torch.tools.convert_lpips alex alexnet.pth lpips_alex.pth out.npz
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["convert_lpips"]


def _w(t):
    return np.transpose(np.asarray(t), (2, 3, 1, 0))  # OIHW → HWIO


def convert_lpips(
    net: str,
    backbone_sd: Dict[str, np.ndarray],
    lin_sd: Dict[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {"kind": np.asarray(net)}

    def conv(dst, src):
        flat[f"net/{dst}/w"] = _w(backbone_sd[f"{src}.weight"])
        flat[f"net/{dst}/b"] = np.asarray(backbone_sd[f"{src}.bias"])

    if net == "alex":
        # torchvision alexnet feature indices: 0, 3, 6, 8, 10
        for dst, idx in (
            ("conv1", 0), ("conv2", 3), ("conv3", 6), ("conv4", 8), ("conv5", 10),
        ):
            conv(dst, f"features.{idx}")
        n_lin = 5
    elif net == "squeeze":
        # torchvision squeezenet1_1: conv at features.0; fire modules at
        # 3,4,6,7,9,10,11,12
        conv("conv1", "features.0")
        fire_idx = (3, 4, 6, 7, 9, 10, 11, 12)
        for i, fi in enumerate(fire_idx, start=1):
            for part, tname in (
                ("squeeze", "squeeze"),
                ("expand1", "expand1x1"),
                ("expand3", "expand3x3"),
            ):
                flat[f"net/fire{i}/{part}/w"] = _w(
                    backbone_sd[f"features.{fi}.{tname}.weight"]
                )
                flat[f"net/fire{i}/{part}/b"] = np.asarray(
                    backbone_sd[f"features.{fi}.{tname}.bias"]
                )
        n_lin = 7
    else:
        raise ValueError(f"unknown net {net!r}")

    for i in range(n_lin):
        key = f"lin{i}.model.1.weight"
        if key not in lin_sd:
            key = f"lins.{i}.model.1.weight"
        flat[f"lin/lin{i}/w"] = _w(lin_sd[key])
    return flat


def _numpy_state_dict(path: str) -> Dict[str, np.ndarray]:
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "numpy")}


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 4:
        raise SystemExit("usage: convert_lpips.py {alex|squeeze} backbone.pth lin.pth out.npz")
    net, backbone_path, lin_path, out = argv
    np.savez(out, **convert_lpips(net, _numpy_state_dict(backbone_path),
                                  _numpy_state_dict(lin_path)))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

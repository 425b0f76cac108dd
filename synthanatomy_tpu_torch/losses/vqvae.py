"""Stage-1 reconstruction losses (f32), on NCDHW volumes (B, 1, D, H, W).

Port of ``synthanatomy_tpu/losses/vqvae.py``: the ten losses, each
taking the network output (``{"reconstruction": [x],
"quantization_losses": [l]}``) and the target, adding the commitment
losses, and returning ``(total, summaries)`` under the reference's
scalar names; ``get_vqvae_loss``, ``loss_needs_lpips`` and
``lpips_net_for_loss``.  FFTs run over dims (1, 2, 3, 4), the size-1
channel included, as JAX's run over (D, H, W, C).

The 2.5D perceptual losses drop slices at random: where JAX draws a
permutation from a key, the port draws one from the ``rng``
``torch.Generator`` (``_slice_permutation``); ``rng=None`` keeps every
slice, in both packages.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from synthanatomy_tpu_torch.losses.lpips import lpips_distance

__all__ = [
    "VQVAE_LOSS_NAMES",
    "baseline_loss",
    "baur_loss",
    "get_vqvae_loss",
    "hartley_loss",
    "hartley_perceptual_loss",
    "jukebox_loss",
    "jukebox_perceptual_loss",
    "loss_needs_lpips",
    "lpips_net_for_loss",
    "mse_loss",
    "perceptual_loss",
    "spectral_loss",
    "wavegan_loss",
]

Summaries = Dict[str, torch.Tensor]
LossResult = Tuple[torch.Tensor, Summaries]

VQVAE_LOSS_NAMES = ("baur", "mse", "spectral", "hartley", "jukebox", "wavegan", "perceptual",
                    "jukebox_perceptual", "hartley_perceptual", "baseline")

_FFT_DIMS = (1, 2, 3, 4)
_SPATIAL = (2, 3, 4)  # D, H, W of NCDHW


def _unpack(network_output, y):
    y_pred = network_output["reconstruction"][0].float()
    q_losses = [torch.as_tensor(q, dtype=torch.float32) for q in
                network_output["quantization_losses"]]
    return y_pred, y.float(), q_losses


def _add_q_losses(loss, q_losses, summaries):
    for idx, q in enumerate(q_losses):
        summaries[f"Loss-MSE-VQ{idx}_Commitment_Cost"] = q
        loss = loss + q
    return loss


def _f32(v, like):
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _mse(a, b):
    return torch.mean(torch.square(a - b))


def _fft_amplitude(x):
    return torch.fft.fftn(x, dim=_FFT_DIMS, norm="ortho").abs()


def _fht(x):
    f = torch.fft.fftn(x, dim=_FFT_DIMS, norm="ortho")
    return f.real - f.imag


def _pixel(loss, y_pred, y, s, include):
    if include:
        l2 = _mse(y_pred, y)
        s["Loss-MSE-Reconstruction"] = l2
        loss = loss + l2
    return loss


def mse_loss(network_output, y) -> LossResult:
    y_pred, y, q_losses = _unpack(network_output, y)
    s: Summaries = {}
    loss = _mse(y_pred, y)
    s["Loss-MSE-Reconstruction"] = loss
    return _add_q_losses(loss, q_losses, s), s


def baur_loss(network_output, y, *, gdl_factor=0.0) -> LossResult:
    """L1 + L2 + image-gradient-difference loss (forward differences on
    the interior voxels) with a scheduled ``gdl_factor``."""
    y_pred, y, q_losses = _unpack(network_output, y)
    s: Summaries = {}
    l1 = torch.mean(torch.abs(y_pred - y))
    s["Loss-MAE-Reconstruction"] = l1
    l2 = _mse(y_pred, y)
    s["Loss-MSE-Reconstruction"] = l2

    def grad_mag(v, dim):
        n = v.shape[dim]
        shifted = torch.cat([torch.zeros_like(v.narrow(dim, 0, 1)), v.narrow(dim, 0, n - 1)], dim)
        return torch.abs(shifted - v)[:, :, 1:-1, 1:-1, 1:-1]

    gdl_elem = None
    for dim in _SPATIAL:
        term = torch.abs(grad_mag(y, dim) - grad_mag(y_pred, dim))
        gdl_elem = term if gdl_elem is None else gdl_elem + term
    gdl = torch.mean(gdl_elem) * gdl_factor
    s["Loss-GDL-Reconstruction"] = gdl
    s["Auxiliary-GDL_Factor"] = _f32(gdl_factor, y)
    return _add_q_losses(l1 + l2 + gdl, q_losses, s), s


def spectral_loss(network_output, y, *, fft_factor=1.0, include_pixel_loss=True) -> LossResult:
    """½·MSE of FFT amplitudes + the phase term mean(½|1 − exp|Δφ||²)."""
    y_pred, y, q_losses = _unpack(network_output, y)
    s: Summaries = {}
    fy = torch.fft.fftn(y, dim=_FFT_DIMS, norm="ortho")
    fp = torch.fft.fftn(y_pred, dim=_FFT_DIMS, norm="ortho")
    amplitude_loss = 0.5 * _mse(fp.abs(), fy.abs())
    s["Loss-Amplitude-Reconstruction"] = amplitude_loss
    dphi = torch.atan2(fp.imag, fp.real) - torch.atan2(fy.imag, fy.real)
    phase_loss = torch.mean(0.5 * torch.abs((1 - torch.exp(torch.abs(dphi))) ** 2))
    s["Loss-Phase-Reconstruction"] = phase_loss
    fft_loss = (amplitude_loss + phase_loss) * fft_factor
    s["Loss-Spectral-Reconstruction"] = fft_loss
    s["Auxiliary-FFT_Factor"] = _f32(fft_factor, y)
    loss = _pixel(fft_loss, y_pred, y, s, include_pixel_loss)
    return _add_q_losses(loss, q_losses, s), s


@functools.lru_cache(maxsize=8)
def _hartley_weight(shape: Tuple[int, int, int]) -> np.ndarray:
    """exp of the normalised squared distance from the DC-centred grid,
    min-max normalised + 1e-4."""
    mx, my, mz = shape

    def f(x, y, z):
        return ((np.abs(mx / 2 - x) / (mx / 2)) ** 2 + (np.abs(my / 2 - y) / (my / 2)) ** 2
                + (np.abs(mz / 2 - z) / (mz / 2)) ** 2)

    w = np.exp(np.fromfunction(f, shape, dtype=np.float64))
    w = w - w.min()
    w = w / w.max()
    return (w + 1e-4).astype(np.float32)


def _hartley_term(y_pred, y, fht_factor, prioritise_high_frequency):
    hy, hp = _fht(y), _fht(y_pred)
    if prioritise_high_frequency:
        w = torch.as_tensor(_hartley_weight(tuple(int(d) for d in y.shape[2:5])),
                            device=y.device)
        hy, hp = hy * w, hp * w
    return 0.5 * _mse(hp, hy) * fht_factor


def hartley_loss(network_output, y, *, fht_factor=1.0, include_pixel_loss=True,
                 prioritise_high_frequency=True) -> LossResult:
    """½·MSE of the Hartley transform, optionally high-frequency weighted."""
    y_pred, y, q_losses = _unpack(network_output, y)
    s: Summaries = {}
    hart = _hartley_term(y_pred, y, fht_factor, prioritise_high_frequency)
    s["Loss-Hartley-Reconstruction"] = hart
    s["Auxiliary-Hartley_Factor"] = _f32(fht_factor, y)
    loss = _pixel(hart, y_pred, y, s, include_pixel_loss)
    return _add_q_losses(loss, q_losses, s), s


def _jukebox_term(y_pred, y, fft_factor):
    return _mse(_fft_amplitude(y_pred), _fft_amplitude(y)) * fft_factor


def jukebox_loss(network_output, y, *, fft_factor=1.0, include_pixel_loss=True) -> LossResult:
    """MSE of FFT amplitudes (Jukebox L_spec)."""
    y_pred, y, q_losses = _unpack(network_output, y)
    s: Summaries = {}
    spec = _jukebox_term(y_pred, y, fft_factor)
    s["Loss-Spectral-Reconstruction"] = spec
    s["Auxiliary-FFT_Factor"] = _f32(fft_factor, y)
    loss = _pixel(spec, y_pred, y, s, include_pixel_loss)
    return _add_q_losses(loss, q_losses, s), s


def wavegan_loss(network_output, y, *, fft_factor=1.0, include_pixel_loss=True) -> LossResult:
    """Spectral convergence + log-magnitude L1."""
    y_pred, y, q_losses = _unpack(network_output, y)
    s: Summaries = {}
    amp_y, amp_p = _fft_amplitude(y), _fft_amplitude(y_pred)
    l_sc = torch.linalg.norm((amp_y - amp_p).reshape(-1)) / torch.linalg.norm(amp_y.reshape(-1))
    s["Loss-Spectral_Convergence-Reconstruction"] = l_sc
    l_mag = torch.mean(torch.abs(torch.log(amp_y) - torch.log(amp_p)))
    s["Loss-Log_Magnitude-Reconstruction"] = l_mag
    spec = (l_sc + l_mag) * fft_factor
    s["Loss-Spectral-Reconstruction"] = spec
    s["Auxiliary-FFT_Factor"] = _f32(fft_factor, y)
    loss = _pixel(spec, y_pred, y, s, include_pixel_loss)
    return _add_q_losses(loss, q_losses, s), s


# ---------------------------------------------------------------------------
# 2.5D perceptual machinery
# ---------------------------------------------------------------------------


def _batchify(v: torch.Tensor, dim: int) -> torch.Tensor:
    """(B, C, D, H, W) → (B·v.shape[dim], C, ·, ·): one spatial dim
    becomes batch, the other two keep their order."""
    rest = [d for d in _SPATIAL if d != dim]
    vt = v.permute(0, dim, 1, *rest)
    return vt.reshape(-1, *vt.shape[2:])


def _slice_permutation(n: int, rng: torch.Generator, device) -> torch.Tensor:
    return torch.randperm(n, generator=rng, device=rng.device).to(device)


def _fake_3d_lpips(lpips_params, y, y_pred, dim, *, keep, rng, normalize=True):
    ys, ps = _batchify(y, dim), _batchify(y_pred, dim)
    n = ys.shape[0]
    k = keep(n)
    if rng is not None and k < n:
        idx = _slice_permutation(n, rng, ys.device)[:k]
        ys, ps = ys[idx], ps[idx]
    return torch.mean(lpips_distance(lpips_params, ys, ps, normalize=normalize))


def _perceptual_terms(lpips_params, y, y_pred, rng, keep_ratio, perceptual_factor, s):
    loss = torch.zeros((), device=y.device)
    for i, dim in enumerate(_SPATIAL):
        p = _fake_3d_lpips(lpips_params, y, y_pred, dim, rng=rng,
                           keep=lambda n: max(1, int(n * keep_ratio))) * perceptual_factor
        s[f"Loss-Perceptual_{i}-Reconstruction"] = p
        loss = loss + p
    s["Auxiliary-Perceptual_Factor"] = _f32(perceptual_factor, y)
    return loss


def perceptual_loss(network_output, y, *, lpips_params, rng: Optional[torch.Generator] = None,
                    keep_ratio=0.5, perceptual_factor=0.001,
                    include_pixel_loss=True) -> LossResult:
    """2.5D LPIPS over the three axes with random slice drop."""
    y_pred, y, q_losses = _unpack(network_output, y)
    s: Summaries = {}
    loss = _perceptual_terms(lpips_params, y, y_pred, rng, keep_ratio, perceptual_factor, s)
    loss = _pixel(loss, y_pred, y, s, include_pixel_loss)
    return _add_q_losses(loss, q_losses, s), s


def jukebox_perceptual_loss(network_output, y, *, lpips_params,
                            rng: Optional[torch.Generator] = None, keep_ratio=0.5,
                            fft_factor=1.0, perceptual_factor=0.001,
                            include_pixel_loss=True) -> LossResult:
    """Jukebox spectral + 2.5D LPIPS + MSE: the paper default."""
    y_pred, y, q_losses = _unpack(network_output, y)
    s: Summaries = {}
    spec = _jukebox_term(y_pred, y, fft_factor)
    s["Loss-Spectral-Reconstruction"] = spec
    s["Auxiliary-FFT_Factor"] = _f32(fft_factor, y)
    loss = spec + _perceptual_terms(lpips_params, y, y_pred, rng, keep_ratio,
                                    perceptual_factor, s)
    loss = _pixel(loss, y_pred, y, s, include_pixel_loss)
    return _add_q_losses(loss, q_losses, s), s


def hartley_perceptual_loss(network_output, y, *, lpips_params,
                            rng: Optional[torch.Generator] = None, keep_ratio=0.5,
                            fht_factor=1.0, perceptual_factor=0.001, include_pixel_loss=True,
                            prioritise_high_frequency=True) -> LossResult:
    """Hartley spectral + 2.5D LPIPS + MSE."""
    y_pred, y, q_losses = _unpack(network_output, y)
    s: Summaries = {}
    hart = _hartley_term(y_pred, y, fht_factor, prioritise_high_frequency)
    s["Loss-Hartley-Reconstruction"] = hart
    s["Auxiliary-Hartley_Factor"] = _f32(fht_factor, y)
    loss = hart + _perceptual_terms(lpips_params, y, y_pred, rng, keep_ratio,
                                    perceptual_factor, s)
    loss = _pixel(loss, y_pred, y, s, include_pixel_loss)
    return _add_q_losses(loss, q_losses, s), s


def baseline_loss(network_output, y, *, lpips_params, rng: Optional[torch.Generator] = None,
                  n_slices=512, pixel_factor=1.0, fft_factor=1.0,
                  perceptual_factor=0.002) -> LossResult:
    """L1 + FFT-abs MSE on (t+1)/2 over every axis + SqueezeNet LPIPS
    over up to 512 random slices per axis (inputs read as [-1, 1])."""
    y_pred, y, q_losses = _unpack(network_output, y)
    s: Summaries = {}
    l1 = torch.mean(torch.abs(y - y_pred)) * pixel_factor
    s["Loss-MAE-Reconstruction"] = l1

    def fft_abs(t):
        return torch.fft.fftn((t + 1.0) / 2.0, norm="ortho").abs()

    spec = _mse(fft_abs(y), fft_abs(y_pred)) * fft_factor
    s["Loss-Jukebox-Reconstruction"] = spec
    p_total = torch.zeros((), device=y.device)
    # sagittal (D), axial (W), coronal (H)
    for name, dim in (("Sagittal", 2), ("Axial", 4), ("Coronal", 3)):
        p = _fake_3d_lpips(lpips_params, y, y_pred, dim, rng=rng,
                           keep=lambda n: min(n, n_slices), normalize=False)
        s[f"Loss-Perceptual_{name}-Reconstruction"] = p
        p_total = p_total + p
    p_total = p_total * perceptual_factor
    s["Loss-Perceptual-Reconstruction"] = p_total
    return _add_q_losses(l1 + spec + p_total, q_losses, s), s


_TABLE = {
    "mse": mse_loss, "baur": baur_loss, "spectral": spectral_loss, "hartley": hartley_loss,
    "jukebox": jukebox_loss, "wavegan": wavegan_loss, "perceptual": perceptual_loss,
    "jukebox_perceptual": jukebox_perceptual_loss,
    "hartley_perceptual": hartley_perceptual_loss, "baseline": baseline_loss,
}


def get_vqvae_loss(name: str) -> Callable[..., LossResult]:
    """The loss for a registry name; LPIPS losses take ``lpips_params``
    (and optionally ``rng``)."""
    if name not in _TABLE:
        raise ValueError(f"Loss function unknown. Was given {name} but choices are "
                         f"{list(_TABLE)}.")
    return _TABLE[name]


def loss_needs_lpips(name: str) -> bool:
    return name in ("perceptual", "jukebox_perceptual", "hartley_perceptual", "baseline")


def lpips_net_for_loss(name: str) -> str:
    return "squeeze" if name == "baseline" else "alex"

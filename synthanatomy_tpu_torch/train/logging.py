"""TensorBoard logging + output savers.

The port's own copy of ``synthanatomy_tpu/train/logging.py``.  The
trace CSV is written by the ``csv`` module, byte for byte what
``pandas.DataFrame(rows).to_csv(path, index=False)`` writes; without
tensorboardX (the card's machine has none) :class:`TBLogger` is a no-op.

Rebuild of the reference handler set (src/handlers/general.py:174-590,
src/handlers/vqvae.py): ``TensorBoardHandler``'s medical-imaging
summary types — scalars, per-anatomical-plane mid-slice 2D images
(axial/coronal/sagittal with rot90), 3D GIF videos — plus the
``NpySaver`` per-sample ``.npy`` writer keyed by the source filename
and the ``TransformTraceLoggerHandler`` CSV artifact.

Three writers (train / val_eval / train_eval) like run_vqvae.py:204,
270, 300.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["TBLogger", "save_npy_outputs", "write_transform_trace_csv", "mid_slices"]

_PLANES = {
    # channels-last (D, H, W): slice axis + rot90 presentation like the
    # reference (handlers/general.py:288-320)
    "axial": 2,
    "coronal": 1,
    "saggital": 0,  # reference spelling kept for flag parity
    "sagittal": 0,
}


def mid_slices(volume: np.ndarray, planes: Sequence[str]) -> Dict[str, np.ndarray]:
    """volume (D, H, W) → {plane: 2D image} mid-slices, rot90'd for
    display."""
    v = np.asarray(volume)
    if v.ndim == 4:
        v = v[..., 0]
    out = {}
    for plane in planes:
        axis = _PLANES[plane.lower()]
        idx = v.shape[axis] // 2
        sl = np.take(v, idx, axis=axis)
        out[plane] = np.rot90(sl)
    return out


class TBLogger:
    """Thin tensorboardX wrapper; becomes a no-op when rank != 0 or
    tensorboardX is unavailable (rank-0-only logging, run_vqvae.py:157)."""

    def __init__(self, logdir: Optional[str], enabled: bool = True):
        self.writer = None
        if enabled and logdir is not None:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(logdir)
            except Exception:
                self.writer = None

    def scalars(self, summaries: Dict[str, Any], step: int, prefix: str = ""):
        if self.writer is None:
            return
        for k, v in summaries.items():
            try:
                self.writer.add_scalar(prefix + k, float(np.asarray(v)), step)
            except (TypeError, ValueError):
                pass

    def volume_images(
        self,
        tag: str,
        volume: np.ndarray,
        step: int,
        planes: Sequence[str] = ("axial", "coronal", "saggital"),
    ):
        """Mid-slice 2D images per anatomical plane (clamped [0,1])."""
        if self.writer is None:
            return
        for plane, img in mid_slices(volume, planes).items():
            img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
            self.writer.add_image(f"{tag}/{plane}", img[None], step)

    def volume_gif(self, tag: str, volume: np.ndarray, step: int, fps: int = 8):
        """3D volume as a video sweeping axial slices
        (handlers/general.py:321-347 ``add_video`` equivalent)."""
        if self.writer is None:
            return
        v = np.asarray(volume)
        if v.ndim == 4:
            v = v[..., 0]
        frames = np.clip(v, 0.0, 1.0)  # (D, H, W)
        vid = (frames[None, :, None] * 255).astype(np.uint8)  # (1, T, 1, H, W)
        try:
            self.writer.add_video(tag, vid, step, fps=fps)
        except Exception:
            pass

    # ---- remaining reference summary types (handlers/general.py:
    # 280 histograms, 364-375 figures/audio/text).  The reference
    # pipeline itself only emits scalars/images/GIFs; these slots exist
    # so user handler code porting over finds the full surface.

    def histograms(self, summaries: Dict[str, Any], step: int, prefix: str = ""):
        if self.writer is None:
            return
        for k, v in summaries.items():
            try:
                self.writer.add_histogram(prefix + k, np.asarray(v), step)
            except (TypeError, ValueError):
                pass

    def figures(self, summaries: Dict[str, Any], step: int):
        """matplotlib figures (general.py:364-365)."""
        if self.writer is None:
            return
        for k, fig in summaries.items():
            try:
                self.writer.add_figure(k, fig, step)
            except Exception:
                pass

    def audios(
        self, summaries: Dict[str, Any], step: int, sample_rate: int = 44100
    ):
        """(1, N) waveforms in [-1, 1] (general.py:367-371)."""
        if self.writer is None:
            return
        for k, snd in summaries.items():
            try:
                self.writer.add_audio(
                    k, np.asarray(snd), step, sample_rate=sample_rate
                )
            except Exception:
                pass

    def texts(self, summaries: Dict[str, Any], step: int):
        if self.writer is None:
            return
        for k, s in summaries.items():
            try:
                self.writer.add_text(k, str(s), step)
            except Exception:
                pass

    def close(self):
        if self.writer is not None:
            self.writer.close()


def save_npy_outputs(
    outputs_directory: str,
    arrays: Iterable[np.ndarray],
    source_paths: Iterable[str],
    *,
    postfix: str = "quantization_i",
    dtype=np.uint16,
    augmentation_ids: Optional[Sequence[int]] = None,
) -> List[str]:
    """Per-sample ``.npy`` writer keyed by the source file name — the
    reference ``NpySaver`` contract (handlers/general.py:491-590):
    ``{outputs}/{basename}_{postfix}.npy``, uint16 for codebook indices
    (run_vqvae.py:484-498)."""
    os.makedirs(outputs_directory, exist_ok=True)
    written = []
    for i, (arr, src) in enumerate(zip(arrays, source_paths)):
        base = os.path.basename(src)
        for ext in (".nii.gz", ".nii", ".npy"):
            if base.endswith(ext):
                base = base[: -len(ext)]
                break
        if augmentation_ids is not None and augmentation_ids[i]:
            base = f"{base}_aug{augmentation_ids[i]}"
        path = os.path.join(outputs_directory, f"{base}_{postfix}.npy")
        np.save(path, np.asarray(arr).astype(dtype))
        written.append(path)
    return written


def write_transform_trace_csv(
    logs_directory: str,
    traces: Sequence[Dict[str, bool]],
    paths: Sequence[str],
    *,
    rank: int = 0,
) -> Optional[str]:
    """Rank-suffixed applied-augmentation CSV at run end
    (TransformTraceLoggerHandler, src/handlers/vqvae.py:177-235)."""
    rows = []
    for trace, path in zip(traces, paths):
        if trace is None:
            continue
        rows.append({"path": path, **trace})
    if not rows:
        return None
    out = os.path.join(
        logs_directory, f"transformations_trace_logs_{rank}.csv"
    )
    write_csv(out, rows)
    return out


def _csv_cell(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return str(v)


def write_csv(path: str, rows: Sequence[Dict[str, Any]],
              columns: Optional[Sequence[str]] = None) -> None:
    """Rows of dicts as pandas' ``DataFrame(rows).to_csv(path,
    index=False)`` writes them: columns (by default) in order of first
    appearance, a missing or NaN cell empty, minimal quoting, ``\n``
    line ends."""
    if columns is None:
        columns = {}
        for row in rows:
            columns.update(dict.fromkeys(row))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for row in rows:
            w.writerow([_csv_cell(row.get(c)) for c in columns])

"""Subject discovery + host data pipeline.

The port's own copy of ``synthanatomy_tpu/data/datasets.py``, with the
csv and tsv tables read by the ``csv`` module in place of pandas (the
card's machine has none); :func:`read_table` types each column as
pandas' reader does (int, else float, else str; its NA strings read as
missing).

Rebuild of the reference's ``get_data_flow``
(src/utils/vqvae.py:55-496, src/utils/transformer.py:27-236):

- subject discovery from directories / CSV / TSV with a ``path``
  column (vqvae.py:126-181), `.nii.gz` for train/extract, per-level
  `.npy` for decode, augmentation-replicated subjects for
  ``no_augmented_extractions``;
- transformer latents from `.npy` plus conditioning CSV/TSV joined on
  the ``subject`` column with NaN/missing-row dropping
  (transformer.py:106-141) and vocab sizes from ``nunique()``;
- a threaded prefetching loader replacing DataLoader worker processes
  (numpy arrays only cross the thread boundary; the runner stages them
  to the device), at most ``prefetch`` batches ahead of the consumer,
  with deterministic per-epoch shuffling and per-host sharding along
  the data axis (the ``DistributedSampler`` equivalent —
  even-divisible for training, tail-padded for eval).
"""

from __future__ import annotations

import csv
import math
import os
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from synthanatomy_tpu_torch.data.nifti import load_nifti
from synthanatomy_tpu_torch.data.transforms import VQVAETransform

__all__ = [
    "discover_subjects",
    "discover_decoding_subjects",
    "load_conditionings",
    "VolumeDataset",
    "LatentDataset",
    "PrefetchLoader",
    "read_table",
]

# the strings pandas' read_csv takes for a missing value by default
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def _typed_column(cells: List[str]) -> List[Any]:
    """One column's cells as pandas types them: all ints, else all
    floats, else strings; a missing cell is NaN (None in a str column)."""
    present = [c for c in cells if c not in _NA_STRINGS]
    for cast in (int, float):
        try:
            vals = [cast(c) for c in present]
        except ValueError:
            continue
        if cast is int and len(present) < len(cells):
            cast = float  # NaN makes the column float, as in pandas
        it = iter(vals)
        return [cast(next(it)) if c not in _NA_STRINGS else math.nan for c in cells]
    return [c if c not in _NA_STRINGS else None for c in cells]


def read_table(path: str, sep: Optional[str] = None) -> Tuple[List[str], Dict[str, List[Any]]]:
    """A csv (``sep=","``) or tsv table → (column names, {name: typed
    values}); blank lines are skipped, as pandas skips them.  ``sep``
    defaults from the extension."""
    if sep is None:
        sep = "\t" if path.endswith(".tsv") else ","
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    header, body = rows[0], rows[1:]
    cols = {}
    for j, name in enumerate(header):
        cols[name] = _typed_column([r[j] if j < len(r) else "" for r in body])
    return header, cols


def is_missing(value) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def _list_paths(paths: Union[str, Sequence[str]]) -> List[List[str]]:
    if isinstance(paths, str):
        paths = [paths]
    files: List[List[str]] = []
    for path in paths:
        if os.path.isdir(path):
            files.append(
                sorted(os.path.join(path, f) for f in os.listdir(path))
            )
        elif os.path.isfile(path) and path.endswith(".csv"):
            files.append(read_table(path, ",")[1]["path"])
        elif os.path.isfile(path) and path.endswith(".tsv"):
            files.append(read_table(path, "\t")[1]["path"])
        else:
            raise ValueError(
                "Path is neither a folder (to source all the files inside) or "
                f"a csv/tsv with file paths inside: {path}"
            )
    return files


def discover_subjects(
    paths: Union[str, Sequence[str]],
    *,
    mode: str = "training",
    no_augmented_extractions: int = 0,
    extension: str = ".nii.gz",
) -> List[Dict[str, Any]]:
    """NIfTI subject dicts (reference get_subjects, vqvae.py:126-181)."""
    files = _list_paths(paths)
    subjects: List[Dict[str, Any]] = []
    for f in files[0]:
        if not f.endswith(extension):
            raise ValueError(f"Path given is not a {extension} file, but {f}")
        if no_augmented_extractions != 0 and mode == "extracting":
            for aug_id in range(no_augmented_extractions):
                subjects.append({"MRI": f, "augmentation_id": aug_id})
        else:
            subjects.append({"MRI": f})
    return subjects


def discover_decoding_subjects(
    paths: Union[str, Sequence[str]], num_levels: int = 1
) -> List[Dict[str, str]]:
    files = _list_paths(paths)
    subjects = []
    if len(files) > 1:
        groups = zip(*files)
    else:
        groups = [[f] for f in files[0]]
    for group in groups:
        subject = {}
        for idx, q in enumerate(group):
            if not q.endswith(".npy"):
                raise ValueError(f"Path given is not a .npy file, but {q}")
            subject[f"quantization_{idx}"] = q
        subjects.append(subject)
    return subjects


def load_conditionings(
    conditioning_path: str,
    conditionings: Sequence[str],
    subject_names: Sequence[str],
    *,
    logger=None,
) -> Tuple[Dict[str, List[float]], Tuple[int, ...], List[int]]:
    """Join the conditioning table on 'subject' (reference
    src/utils/transformer.py:106-141).  Returns (per-column values
    aligned to kept subjects, vocab sizes via nunique, kept indices)."""
    _, table = read_table(conditioning_path)
    if "subject" not in table:
        raise ValueError("conditioning file must have a 'subject' column")
    rows = {}
    for r, name in enumerate(table["subject"]):
        rows.setdefault(name, r)

    kept_idx: List[int] = []
    values: Dict[str, List[float]] = {c: [] for c in conditionings}
    dropped = 0
    for i, name in enumerate(subject_names):
        r = rows.get(name)
        if r is None or any(is_missing(table[c][r]) for c in conditionings):
            dropped += 1
            continue
        kept_idx.append(i)
        for c in conditionings:
            values[c].append(table[c][r])
    if dropped and logger is not None:
        logger.warning(
            f"{dropped} subjects dropped for missing/NaN conditioning rows"
        )
    vocab_sizes = tuple(len(set(values[c])) for c in conditionings)
    return values, vocab_sizes, kept_idx


class VolumeDataset:
    """NIfTI volumes through the VQVAE transform chain.

    Uses the native C++ loader (fused gzip inflate + dtype→f32,
    synthanatomy_tpu_torch.native) when the toolchain is available, falling
    back to the pure-Python reader; canonical RAS reorientation is
    applied either way.
    """

    def __init__(
        self,
        subjects: Sequence[Dict[str, Any]],
        transform: VQVAETransform,
        *,
        load_nii_canonical: bool = True,
        seed: int = 0,
        use_native: bool = True,
        device_augment: bool = False,
    ):
        self.subjects = list(subjects)
        self.transform = transform
        self.canonical = load_nii_canonical
        self.seed = seed
        self.device_augment = (
            device_augment and transform.supports_device_augment()
        )
        self._native = None
        if use_native:
            try:
                from synthanatomy_tpu_torch.native import (
                    load_nifti_native,
                    native_available,
                )

                if native_available():
                    self._native = load_nifti_native
            except Exception:
                self._native = None

    def __len__(self):
        return len(self.subjects)

    def _load(self, path: str):
        from synthanatomy_tpu_torch.data.nifti import NiftiImage, closest_canonical

        # fuse min-max normalization AND canonical reorientation into
        # the native decode's gather pass (flips/permutes/crops/pads
        # are normalization-invariant, so order is free)
        fuse_norm = self._native is not None and getattr(
            self.transform, "normalize", False
        )
        if self._native is not None:
            vol, affine = self._native(
                path, normalize=fuse_norm, canonical=self.canonical
            )
            return NiftiImage(vol, affine), fuse_norm
        img = load_nifti(path, as_closest_canonical=False)
        if self.canonical:
            img = closest_canonical(img)
        return img, fuse_norm

    def get(self, index: int, epoch: int = 0) -> Dict[str, Any]:
        subj = self.subjects[index]
        img, pre_normalized = self._load(subj["MRI"])
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, index])
        )
        sample: Dict[str, Any] = {
            "path": subj["MRI"],
            "affine": img.affine,
            "augmentation_id": subj.get("augmentation_id", 0),
        }
        if self.device_augment:
            # host does the deterministic part only; the randomized
            # chain runs on-device from these pre-drawn params
            # (ops/augment.py) — same rng stream, same trace
            vol, _ = self.transform(
                img.data, rng, pre_normalized=pre_normalized,
                defer_augment=True,
            )
            params, trace = self.transform.draw_device_params(vol.shape, rng)
            sample["augment"] = params
        else:
            vol, trace = self.transform(
                img.data, rng, pre_normalized=pre_normalized
            )
        sample["MRI"] = vol[..., None]  # channels-last
        sample["trace"] = trace
        return sample


class LatentDataset:
    """Stage-2 `.npy` latent index grids (+ optional conditionings)."""

    def __init__(
        self,
        subjects: Sequence[Dict[str, str]],
        *,
        conditioning_values: Optional[Dict[str, List[float]]] = None,
        conditioning_names: Sequence[str] = (),
    ):
        self.subjects = list(subjects)
        self.cond_values = conditioning_values
        self.cond_names = list(conditioning_names)
        # map raw conditioning values to token ids
        self._vocab: Dict[str, Dict[float, int]] = {}
        if conditioning_values:
            for c in self.cond_names:
                uniq = sorted(set(conditioning_values[c]))
                self._vocab[c] = {v: i for i, v in enumerate(uniq)}

    def __len__(self):
        return len(self.subjects)

    @property
    def conditioning_num_tokens(self) -> Tuple[int, ...]:
        return tuple(len(self._vocab[c]) for c in self.cond_names)

    def get(self, index: int, epoch: int = 0) -> Dict[str, Any]:
        subj = self.subjects[index]
        key = "quantization_0" if "quantization_0" in subj else "MRI"
        latents = np.load(subj[key]).astype(np.int32)
        out: Dict[str, Any] = {"latents": latents, "path": subj[key]}
        if self.cond_values is not None:
            out["conditionings"] = [
                np.asarray(
                    self._vocab[c][self.cond_values[c][index]], np.int32
                )
                for c in self.cond_names
            ]
        return out


class PrefetchLoader:
    """Threaded batching loader with per-host sharding.

    shard_id/num_shards split the subject list like DistributedSampler
    (vqvae.py:406-408): training drops the non-divisible tail (even
    batches per shard); otherwise the subjects are dealt round-robin,
    each once (a shard may hold one fewer).  JAX's loader pads that case
    by wrapping, which scores a subject twice; the port's evaluation
    weights each rank by its real samples instead.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        shard_id: int = 0,
        num_shards: int = 1,
        seed: int = 0,
        collate_keys: Sequence[str] = ("MRI",),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.collate_keys = collate_keys

    def _indices(self, epoch: int) -> List[int]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(idx)
        if self.num_shards > 1:
            if self.drop_last:
                per = n // self.num_shards
                idx = idx[self.shard_id * per : (self.shard_id + 1) * per]
            else:
                idx = idx[self.shard_id :: self.num_shards]
        return idx.tolist()

    def __len__(self):
        n = len(self._indices(0))
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _collate(self, batch_idx: List[int], epoch: int) -> Dict[str, Any]:
        samples = [self.dataset.get(i, epoch) for i in batch_idx]
        collated: Dict[str, Any] = {}
        for k in self.collate_keys:
            collated[k] = np.stack([s[k] for s in samples])
        if "augment" in samples[0]:
            collated["augment"] = {
                k: np.stack([s["augment"][k] for s in samples])
                for k in samples[0]["augment"]
            }
        if "conditionings" in samples[0]:
            n_conds = len(samples[0]["conditionings"])
            collated["conditionings"] = [
                np.stack([s["conditionings"][c] for s in samples])
                for c in range(n_conds)
            ]
        collated["paths"] = [s.get("path") for s in samples]
        collated["traces"] = [s.get("trace") for s in samples]
        collated["affines"] = [s.get("affine") for s in samples]
        collated["augmentation_ids"] = [s.get("augmentation_id", 0) for s in samples]
        return collated

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        """The epoch's batches in order.  At most ``prefetch`` batches are
        taken ahead of the consumer (loading or loaded, not yet yielded):
        a worker takes the next batch only when a slot is free, and the
        consumer frees one as it takes a batch.  Closing the generator
        (or a worker's error reaching the consumer) stops the workers;
        each finishes the batch it is loading and exits."""
        indices = self._indices(epoch)
        if self.drop_last:
            indices = indices[: (len(indices) // self.batch_size) * self.batch_size]
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        slots = max(1, self.prefetch)
        cond = threading.Condition()
        results: Dict[int, Any] = {}
        progress = {"taken": 0, "consumed": 0, "stop": False}

        def worker():
            while True:
                with cond:
                    while (not progress["stop"]
                           and progress["taken"] - progress["consumed"] >= slots):
                        cond.wait()
                    if progress["stop"] or progress["taken"] == len(batches):
                        return
                    bi = progress["taken"]
                    progress["taken"] += 1
                try:
                    item: Any = self._collate(batches[bi], epoch)
                except BaseException as e:  # propagate to the consumer
                    item = e
                with cond:
                    results[bi] = item
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(min(self.num_workers, slots))
        ]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with cond:
                    while bi not in results:
                        cond.wait()
                    item = results.pop(bi)
                    progress["consumed"] += 1
                    cond.notify_all()
                if isinstance(item, BaseException):
                    raise item  # worker failure surfaces at the consumer
                yield item
        finally:
            with cond:
                progress["stop"] = True
                cond.notify_all()
            for t in threads:
                t.join()

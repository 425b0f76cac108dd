"""Host data-pipeline benchmark: NIfTI decode → transform chain → batch,
the native C++ reader against the Python one, in volumes/s.

Port of ``tools/bench_dataloader.py``, through the port's
``PrefetchLoader`` and ``VolumeDataset``.  Three cases: the native reader
with the host augmentation, the Python reader with it, and the native
reader with the device augmentation's parameters only (the randomized
chain then runs on the device, ``ops/augment.py``).  Writes ``--n``
float32 volumes of ``--shape`` into a temporary directory first; each
case warms the file cache with one epoch and times the next.

    python -m synthanatomy_tpu_torch.tools.bench_dataloader [--n=8 --shape='(160,224,160)']
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    from synthanatomy_tpu_torch.cli import parse_argv
    from synthanatomy_tpu_torch.data.datasets import (
        PrefetchLoader,
        VolumeDataset,
        discover_subjects,
    )
    from synthanatomy_tpu_torch.data.nifti import save_nifti
    from synthanatomy_tpu_torch.data.transforms import VQVAETransform
    from synthanatomy_tpu_torch.native import native_available

    _, kw = parse_argv(sys.argv[1:] if argv is None else argv)
    n = int(kw.get("n", 8))
    shape = tuple(kw.get("shape", (160, 224, 160)))
    workers = int(kw.get("workers", os.cpu_count() or 1))
    rates: Dict[str, float] = {}

    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(0)
        print(f"writing {n} volumes of {shape}...", flush=True)
        for i in range(n):
            save_nifti(os.path.join(d, f"s{i}.nii.gz"),
                       rng.uniform(0, 1000, shape).astype(np.float32))

        tf = VQVAETransform(augment=True,
                            augmentation_probability=float(kw.get("augment_p", 0.2)))
        cases = [
            (True, False, "native C++"),
            (False, False, "pure python"),
            # the host loads and normalises only; the randomized chain runs
            # on the device before the step (--device_augmentation)
            (True, True, "native C++ + device-augment"),
        ]
        for use_native, dev_aug, tag in cases:
            if use_native and not native_available():
                print(f"{tag}: the native loader is unavailable (no g++/zlib); skipped")
                continue
            ds = VolumeDataset(discover_subjects(d), tf, use_native=use_native,
                               device_augment=dev_aug)
            loader = PrefetchLoader(ds, batch_size=2, num_workers=workers, shuffle=False,
                                    drop_last=False)
            # warm the file cache with a whole epoch: a half-drained epoch's
            # workers would contend with the timed one
            for _ in loader.epoch(0):
                pass
            t0 = time.perf_counter()
            count = 0
            for batch in loader.epoch(1):
                count += batch["MRI"].shape[0]
            dt = time.perf_counter() - t0
            rates[tag] = count / dt
            print(f"{tag:12s}: {count / dt:6.2f} volumes/s ({dt / count * 1e3:.0f} ms/volume, "
                  f"{workers} workers)", flush=True)
    return rates


if __name__ == "__main__":
    main()

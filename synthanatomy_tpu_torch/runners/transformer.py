"""Stage-2 orchestration helpers.

Port of ``prepare_batch`` from ``synthanatomy_tpu/runners/transformer.py``
(numpy).  The runner itself (data loading, checkpoints, logging, the CLI
switch) is not ported yet (ROADMAP §1, "Runners and CLIs").
"""

from __future__ import annotations

import numpy as np

__all__ = ["prepare_batch"]


def prepare_batch(latents: np.ndarray, ordering, vocab_size: int):
    """(B, H, W, D) int grids → (inputs, targets) (B, L) int32 with the
    BOS token (``vocab_size``) left-padded and a next-token shift."""
    b = latents.shape[0]
    flat = latents.reshape(b, -1)
    seq = flat[:, ordering.get_sequence_ordering()]
    bos = np.full((b, 1), vocab_size, seq.dtype)
    padded = np.concatenate([bos, seq], axis=1)
    return padded[:, :-1].astype(np.int32), padded[:, 1:].astype(np.int32)

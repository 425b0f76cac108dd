"""Checkpointing + experiment directory layout.

The port's counterpart of ``synthanatomy_tpu/train/checkpoints.py``:
the layout, discovery and auto-resume logic are copied; serialization is
``torch.save`` / ``torch.load`` of one file per checkpoint in place of
orbax's directories, under the same names.

Rebuild of the reference's MONAI CheckpointSaver/CheckpointLoader wiring
and auto-resume semantics (SURVEY.md §5.4; reference
src/utils/general.py:75-282, run_vqvae.py:312-361):

- directory layout ``{project}/{experiment}/{network}/{checkpoints,
  logs, outputs, caching}`` (general.py:225-282);
- naming contract ``checkpoint_epoch={N}`` (one ``torch.save`` file,
  no extension, as JAX names its orbax directories) and
  ``checkpoint_key_metric={score}`` for the best-metric saver; ``n_saved=1`` pruning for the periodic saver;
- auto-resume: if the checkpoint dir is non-empty and
  ``starting_epoch == 0``, resume from the latest epoch
  (``starting_epoch=-1`` resolution, general.py:93-107, 259-269);
- ``evaluation_checkpoint ∈ {recent, best}`` selection at inference
  (general.py:141-166).

A stage-1 checkpoint holds G (with its EMA codebook buffers), D, both
Adam states, the step and the state of the run's ``torch.Generator``.  A
prior's (``train/transformer_steps.TransformerTrainState``) holds the
Performer (its FAVOR projection buffers included), its Adam state, the
step, the dropout and redraw generators and the steps since the last
redraw, so a resumed run redraws on the uninterrupted run's schedule.

Data parallelism: every rank calls the savers; rank 0 writes (after
gathering a ZeRO-1 optimizer's shards to itself, a collective) and a
barrier follows, so every rank may read the file next.  The file is the
one-device file whatever the job's ranks or ZeRO-1: it holds rank 0's
generator, and it loads into one device or into a DP or ZeRO-1 state
(each rank keeps its shard of the optimizer's state).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from synthanatomy_tpu_torch.parallel.distributed import barrier, default_group, group_info
from synthanatomy_tpu_torch.parallel.sharding_rules import full_state_dict

__all__ = [
    "create_folder_structure",
    "check_for_checkpoints",
    "save_checkpoint",
    "load_checkpoint",
    "save_best_checkpoint",
    "prune_old_checkpoints",
]

_EPOCH_RE = re.compile(r"checkpoint_epoch=(\d+)$")
_BEST_RE = re.compile(r"checkpoint_key_metric=(-?[\d.]+)$")


def create_folder_structure(
    project_directory: str,
    experiment_name: str,
    network: str,
    *,
    starting_epoch: int = 0,
    logger: Optional[logging.Logger] = None,
) -> Tuple[Dict[str, str], int]:
    """Create the experiment tree; returns (directories, starting_epoch)
    where starting_epoch flips to -1 when checkpoints already exist
    (the auto-resume trigger)."""
    experiment_directory = os.path.join(
        project_directory, experiment_name, network
    )
    dirs = {
        "experiment_directory": experiment_directory,
        "checkpoint_directory": os.path.join(experiment_directory, "checkpoints"),
        "logs_directory": os.path.join(experiment_directory, "logs"),
        "outputs_directory": os.path.join(experiment_directory, "outputs"),
        "cache_dir": os.path.join(experiment_directory, "caching"),
    }
    for d in dirs.values():
        Path(d).mkdir(parents=True, exist_ok=True)

    if starting_epoch == 0 and os.listdir(dirs["checkpoint_directory"]):
        starting_epoch = -1
        if logger:
            logger.warning("The experiment already exists. Checkpoints were found at:")
            logger.warning(dirs["checkpoint_directory"])
            logger.warning("The starting epoch has been modified from 0 to -1.")
    return dirs, starting_epoch


def _epoch_checkpoints(checkpoint_directory: str) -> Dict[int, str]:
    out = {}
    if not os.path.isdir(checkpoint_directory):
        return out
    for name in os.listdir(checkpoint_directory):
        m = _EPOCH_RE.match(name)
        if m:
            out[int(m.group(1))] = os.path.join(checkpoint_directory, name)
    return out


def check_for_checkpoints(
    checkpoint_directory: str,
    *,
    mode: str = "training",
    starting_epoch: int = 0,
    evaluation_checkpoint: str = "recent",
    logger: Optional[logging.Logger] = None,
) -> Tuple[Optional[str], int]:
    """Resolve the checkpoint path per the reference rules.  Returns
    (path or None, resolved starting_epoch)."""
    cps = _epoch_checkpoints(checkpoint_directory)
    if mode == "training":
        if starting_epoch == -1:
            if not cps:
                raise FileNotFoundError(
                    f"auto-resume requested but no checkpoints in "
                    f"{checkpoint_directory}"
                )
            starting_epoch = max(cps)
        if starting_epoch > 0:
            path = cps.get(starting_epoch)
            if path is None:
                raise FileNotFoundError(
                    f"Checkpoint for epoch {starting_epoch} not found in "
                    f"{checkpoint_directory}"
                )
            if logger:
                logger.info(f"Resume from checkpoint: {path}")
            return path, starting_epoch
        return None, starting_epoch

    # evaluation modes
    if starting_epoch > 0:
        path = cps.get(starting_epoch)
        if path is None:
            raise FileNotFoundError(
                f"Checkpoint for epoch {starting_epoch} not found"
            )
        return path, starting_epoch
    if evaluation_checkpoint == "recent":
        if not cps:
            raise FileNotFoundError(f"no checkpoints in {checkpoint_directory}")
        ep = max(cps)
        return cps[ep], ep
    if evaluation_checkpoint == "best":
        best = [
            os.path.join(checkpoint_directory, n)
            for n in os.listdir(checkpoint_directory)
            if _BEST_RE.match(n)
        ]
        if len(best) != 1:
            raise FileNotFoundError(
                f"Should only be one best metric checkpoint, found {best}"
            )
        return best[0], starting_epoch
    raise ValueError(
        f"evaluation_checkpoint must be 'recent' or 'best', got "
        f"{evaluation_checkpoint!r}"
    )


def _state_dict(state: Any) -> Optional[Dict[str, Any]]:
    if state is None:  # a TP or PP rank other than 0: it holds no whole model, rank 0 writes
        return None
    if hasattr(state, "optimizer"):  # the prior's TransformerTrainState
        return {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": full_state_dict(state.optimizer),
            "generator": state.generator.get_state(),
            "redraw_generator": state.redraw_generator.get_state(),
            "steps_since_redraw": int(state.steps_since_redraw),
        }
    d_model = getattr(state, "d_model", None)
    d_opt = getattr(state, "d_opt", None)
    return {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "g_opt": full_state_dict(state.g_opt),
        "d_model": d_model.state_dict() if d_model is not None else None,
        "d_opt": full_state_dict(d_opt) if d_opt is not None else None,
        "generator": state.generator.get_state(),
    }


def _on_rank0(write) -> None:
    """``write()`` on rank 0 only, then a barrier (no-op on one device)."""
    group = default_group()
    if group_info(group)[0] == 0:
        write()
    barrier(group)


def _write(path: str, state: Any, then=None) -> str:
    """``torch.save`` to a private name, then rename: a run stopped
    mid-write leaves no half checkpoint under the discovered name.  Rank
    0 writes (and runs ``then``), the others wait for it; they may pass
    None for ``state`` (a TP or PP rank, which holds only its share)."""
    sd = _state_dict(state)  # every rank: ZeRO-1 gathers to rank 0

    def write():
        tmp = f"{path}.tmp"
        torch.save(sd, tmp)
        _remove(path)
        os.replace(tmp, path)
        if then is not None:
            then()

    _on_rank0(write)
    return path


def _remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        os.remove(path)


def save_checkpoint(checkpoint_directory: str, state: Any, epoch: int) -> str:
    """Write ``checkpoint_epoch={epoch}``, pruning older epoch
    checkpoints to n_saved=1 (run_vqvae.py:346-352)."""
    return _write(os.path.join(checkpoint_directory, f"checkpoint_epoch={epoch}"), state,
                  lambda: prune_old_checkpoints(checkpoint_directory, keep_epoch=epoch))


def prune_old_checkpoints(checkpoint_directory: str, keep_epoch: int) -> None:
    for ep, path in _epoch_checkpoints(checkpoint_directory).items():
        if ep != keep_epoch:
            _remove(path)


def save_best_checkpoint(
    checkpoint_directory: str, state: Any, metric_value: float
) -> str:
    """Best-key-metric saver (run_vqvae.py:354-361): keeps exactly one
    ``checkpoint_key_metric={value}`` checkpoint."""
    def remove_best():
        for name in os.listdir(checkpoint_directory):
            if _BEST_RE.match(name):
                _remove(os.path.join(checkpoint_directory, name))

    _on_rank0(remove_best)
    return _write(
        os.path.join(checkpoint_directory, f"checkpoint_key_metric={metric_value:.4f}"),
        state,
    )


def load_checkpoint(path: str, state: Any, *, models_only: bool = False) -> Any:
    """Restore a checkpoint written by :func:`save_checkpoint` into
    ``state`` in place and return it.  ``models_only`` loads the models
    only (the reference's ``to_load`` exclusion, run_vqvae.py:330-336:
    a training checkpoint read for inference): G and D for stage 1, where
    D is loaded if both the checkpoint and ``state`` hold one; the
    Performer for the prior."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    if "optimizer" in ckpt:  # the prior's state
        if not models_only:
            state.optimizer.load_state_dict(ckpt["optimizer"])
            state.step = int(ckpt["step"])
            state.generator.set_state(ckpt["generator"])
            state.redraw_generator.set_state(ckpt["redraw_generator"])
            state.steps_since_redraw = int(ckpt["steps_since_redraw"])
        return state
    d_model = getattr(state, "d_model", None)
    if d_model is not None and ckpt["d_model"] is not None:
        d_model.load_state_dict(ckpt["d_model"])
    if models_only:
        return state
    state.g_opt.load_state_dict(ckpt["g_opt"])
    if getattr(state, "d_opt", None) is not None and ckpt["d_opt"] is not None:
        state.d_opt.load_state_dict(ckpt["d_opt"])
    state.step = int(ckpt["step"])
    state.generator.set_state(ckpt["generator"])
    return state

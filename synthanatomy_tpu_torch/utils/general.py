"""Shared experiment utilities.

The port's counterpart of ``synthanatomy_tpu/utils/general.py``: the
device is logged by its CUDA name, the run's seed (``seed + rank``)
takes the place of JAX's root key, and the conditioning tables are read
and written without pandas (``data.datasets.read_table``,
``train.logging.write_csv``).

Rebuild of reference ``src/utils/general.py``: logging setup, config
dump, determinism, network-size logging, conditioning preprocessing
helpers.  Folder structure / checkpoint discovery live in
``synthanatomy_tpu_torch.train.checkpoints``; LR rules of thumb in
``synthanatomy_tpu_torch.train.schedulers``.
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Optional, Tuple

import numpy as np
import torch

from synthanatomy_tpu_torch.data.datasets import is_missing, read_table
from synthanatomy_tpu_torch.train.logging import write_csv

__all__ = [
    "setup_logger",
    "log_basic_info",
    "log_network_size",
    "basic_initialization",
    "run_device",
    "quantize_conditionings",
    "uniform_sampling",
    "PreemptionGuard",
]


def setup_logger(name: str, rank: int = 0, logs_directory: Optional[str] = None) -> logging.Logger:
    """Rank-aware console (+file) logger (ignite setup_logger
    equivalent, reference general.py:327)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    logger.handlers.clear()
    fmt = logging.Formatter(
        f"%(asctime)s [rank {rank}] %(name)s %(levelname)s: %(message)s"
    )
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logs_directory:
        fh = logging.FileHandler(f"{logs_directory}/{name}.log")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def log_basic_info(config: Any, logger: logging.Logger) -> None:
    import dataclasses

    logger.info("Configuration:")
    d = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else dict(config)
    for k, v in d.items():
        logger.info(f"\t{k}: {v}")
    if torch.cuda.is_available():
        logger.info(f"CUDA devices: {torch.cuda.device_count()} "
                    f"({torch.cuda.get_device_name(0)})")
    else:
        logger.info("CUDA devices: none")


def log_network_size(module: torch.nn.Module, logger: logging.Logger,
                     name: str = "network") -> None:
    """Counts the parameters of ``module``; the EMA codebook is buffers
    and stays out, as JAX counts ``g_params`` without its ``vq``
    collection."""
    n = sum(p.numel() for p in module.parameters())
    logger.info(f"Number of parameters in {name}: {n:,}")


def basic_initialization(config, logger_name: str):
    """Logger + determinism + folder structure + checkpoint discovery
    (reference general.py:303-345).  Returns (logger, dirs,
    checkpoint_path, starting_epoch, seed): ``seed`` is ``config.seed +
    config.rank``, which seeds the run's ``torch.Generator``s."""
    from synthanatomy_tpu_torch.train.checkpoints import (
        check_for_checkpoints,
        create_folder_structure,
    )

    logger = setup_logger(logger_name, rank=config.rank)
    log_basic_info(config, logger)

    dirs, starting_epoch = create_folder_structure(
        config.project_directory,
        config.experiment_name,
        config.network,
        starting_epoch=config.starting_epoch,
        logger=logger,
    )
    checkpoint_path, starting_epoch = check_for_checkpoints(
        dirs["checkpoint_directory"],
        mode=config.mode,
        starting_epoch=starting_epoch,
        evaluation_checkpoint=config.evaluation_checkpoint,
        logger=logger,
    )
    # per-rank seeding (reference set_determinism(seed + rank))
    return logger, dirs, checkpoint_path, starting_epoch, config.seed + config.rank


def run_device(config) -> torch.device:
    """A run's device from ``config.device``: ``"cpu"``, or a CUDA ordinal;
    under torchrun (``parallel.distributed.launched``) a card run takes
    ``cuda:LOCAL_RANK`` instead, which must exist.  Raises without a card
    unless the CPU was asked for.  On the card, ``--cuda_benchmark`` and
    ``--deterministic`` set cuDNN's flags, as the reference does."""
    from synthanatomy_tpu_torch.parallel.distributed import launched, local_rank

    if str(config.device) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device=cpu to run on the CPU")
    index = int(config.device)
    if launched():
        index = local_rank()
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {index} has no card: this host has "
                               f"{torch.cuda.device_count()}")
    torch.backends.cudnn.benchmark = bool(config.cuda_benchmark)
    torch.backends.cudnn.deterministic = bool(config.deterministic)
    return torch.device(f"cuda:{index}")


def _qcut_labels(values, q: int):
    """``pandas.qcut(values, q, labels=False)``: bins at the linear
    quantiles, the first bin closed below; NaN stays NaN."""
    x = np.asarray(values, np.float64)
    edges = np.nanquantile(x, np.linspace(0.0, 1.0, q + 1))
    if len(np.unique(edges)) < len(edges):
        raise ValueError(f"Bin edges must be unique: {edges.tolist()}")
    out = np.searchsorted(edges, x, side="left") - 1.0
    out[x == edges[0]] = 0.0
    out[np.isnan(x)] = np.nan
    return out.tolist()


def quantize_conditionings(
    conditionings_path: str,
    id_column: str,
    chosen_conditionings: Tuple[str, ...],
    chosen_quantiles: Tuple[Optional[int], ...],
    output_path: str,
    output_filename: str,
) -> str:
    """Quantile-bin continuous conditioning columns (reference
    general.py:348-371)."""
    header, table = read_table(conditionings_path, ",")
    keep = [c for c in header if c in set(chosen_conditionings) | {id_column}]
    table = {c: table[c] for c in keep}
    for cc, cq in zip(chosen_conditionings, chosen_quantiles):
        if cq is not None:
            table[cc] = _qcut_labels(table[cc], cq)
    n = len(table[keep[0]]) if keep else 0
    rows = [{c: table[c][r] for c in keep} for r in range(n)]
    rows = [r for r in rows if not any(is_missing(v) for v in r.values())]
    for r in rows:
        for c in chosen_conditionings:
            r[c] = int(r[c])
    out = f"{output_path}/{output_filename}.csv"
    write_csv(out, rows, columns=keep)
    return out


def uniform_sampling(
    conditionings_path: str,
    chosen_conditionings: Tuple[str, ...],
    output_path: str,
) -> str:
    """Uniform class-balanced subsample over conditioning groups
    (reference general.py:374-389): as pandas' ``groupby(...).sample(n,
    random_state=0)``, the groups in sorted key order (rows with a
    missing key dropped) and each group's draw from its own
    ``RandomState(0)``."""
    header, table = read_table(conditionings_path, ",")
    n_rows = len(table[header[0]])
    groups = {}
    for r in range(n_rows):
        key = tuple(table[c][r] for c in chosen_conditionings)
        if not any(is_missing(k) for k in key):
            groups.setdefault(key, []).append(r)
    n = min(len(g) for g in groups.values())
    picked = []
    for key in sorted(groups):
        g = groups[key]
        picked += [g[i] for i in np.random.RandomState(0).choice(len(g), n, replace=False)]
    out = f"{output_path}/uniform_quantized_conditioning.csv"
    write_csv(out, [{c: table[c][r] for c in header} for r in picked])
    return out


class PreemptionGuard:
    """Graceful-preemption checkpointing (beyond the reference, which
    has checkpoint-resume only — SURVEY.md §5.3): installs a SIGTERM
    handler (by default; pass ``signals=(SIGTERM, SIGINT)`` to also
    catch Ctrl-C) that sets a flag instead of killing the process, so
    the training loop can finish the in-flight step, write an emergency
    checkpoint at the next epoch boundary and exit cleanly.  TPU
    preemptions (maintenance events, spot reclaims) deliver SIGTERM
    with a grace window — this turns them into a resumable checkpoint
    instead of a lost epoch.

    Usage::

        guard = PreemptionGuard(logger)
        for epoch in ...:
            ...train...
            if guard.should_stop:
                save_checkpoint(...); break
    """

    def __init__(self, logger=None, signals=None):
        import signal as _signal

        self.should_stop = False
        self._logger = logger
        self._prev = {}
        for sig in signals or (_signal.SIGTERM,):
            try:
                self._prev[sig] = _signal.signal(sig, self._handler)
            except (ValueError, OSError):
                pass  # not the main thread / unsupported platform

    def _handler(self, signum, frame):
        self.should_stop = True
        if self._logger is not None:
            self._logger.warning(
                f"signal {signum} received — checkpointing at the next "
                "epoch boundary and exiting"
            )

    def restore(self):
        import signal as _signal

        for sig, prev in self._prev.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):
                pass

"""Stage-2 orchestration: training / inference (sampling).

Port of ``synthanatomy_tpu/runners/transformer.py`` (the reference's
``training()`` run_transformer.py:47-293 and ``inference()``
:296-402): latent ``.npy`` loaders with the conditioning join, the
latent-grid shape read from one sample, the Ordering, the Performer, CE
training with exponential LR decay in a plain-Python epoch loop with the
reference's checkpoint / eval / logging cadences, and batch sampling
written as ``*_sample.npy`` uint16 (run_transformer.py:390-398).

One device: ``config.device`` is a CUDA ordinal, or ``"cpu"`` (the
tests' way to ask for the host).  A mesh over several devices, ZeRO-1,
sequence and pipeline parallelism are not ported yet (ROADMAP.md §1):
training raises ``NotImplementedError`` for them; inference ignores
``--sp_shards``/``--pp_stages`` with a warning, as JAX does, and never
takes JAX's data-parallel sampler, which needs several devices.  The
attention takes rows 5 and 6's kernels on the card under
``--use_pallas_favor_attn`` / ``--use_pallas_local_attn``; sampling
takes the fused decode step (row 1) wherever it covers the prior.

The FAVOR projections are redrawn inside the train step
(``train/transformer_steps.py``), not in this loop as JAX does, and
the redraw counter travels in the checkpoint.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from synthanatomy_tpu_torch.config import TransformerConfig
from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state
from synthanatomy_tpu_torch.utils.general import run_device

__all__ = ["build_ordering", "build_performer", "prepare_batch", "training", "inference"]

_MULTI_GPU = "ROADMAP.md §1, item 1 (Multi-GPU)"


def _check_supported(config: TransformerConfig) -> None:
    if config.mesh_shape is not None and math.prod(config.mesh_shape) > 1:
        raise NotImplementedError(
            f"--mesh_shape={config.mesh_shape} spans several devices; the port runs on "
            f"one device until {_MULTI_GPU}")
    for flag, value in (("zero1", config.zero1), ("sp_shards", config.sp_shards > 1),
                        ("pp_stages", config.pp_stages > 1)):
        if value:
            raise NotImplementedError(
                f"--{flag}={getattr(config, flag)} shards the prior's training over "
                f"devices; the port runs on one device until {_MULTI_GPU}")


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def build_ordering(config: TransformerConfig, latent_shape):
    from synthanatomy_tpu_torch.models.ordering import Ordering

    return Ordering(
        config.ordering_type,
        3,
        tuple(latent_shape),
        reflected_spatial_dims=config.reflected_spatial_dims or (),
        transpositions_axes=config.transpositions_axes or (),
        rot90_axes=config.rot90_axes or (),
        transformation_order=config.transformation_order,
        seed=config.seed,
    )


def build_performer(config: TransformerConfig, ordering, latent_shape, dtype=None, *,
                    device="cuda", generator=None):
    """The prior of ``config``'s network flags on ``device``, its weights
    drawn from ``generator``.  ``--ff_chunks`` is accepted and has no
    effect, as in JAX (the FF runs unchunked)."""
    from synthanatomy_tpu_torch.models.performer import Performer

    seq_len = int(np.prod(latent_shape)) + 1  # + BOS (run_transformer.py:74)
    return Performer(
        num_tokens=config.vocab_size + 1,  # + BOS token (run_transformer.py:71)
        max_seq_len=seq_len,
        dim=config.n_embd,
        depth=config.n_layers,
        heads=config.n_head,
        dim_head=config.dim_head,
        local_attn_heads=config.local_attn_heads,
        local_window_size=config.local_window_size,
        nb_features=config.nb_features,
        feature_redraw_interval=config.feature_redraw_interval,
        generalized_attention=config.generalized_attention,
        ff_mult=config.ff_mult,
        ff_glu=config.ff_glu,
        reversible=config.reversible,
        remat_attention=config.remat_attention,
        emb_dropout=config.emb_dropout,
        ff_dropout=config.ff_dropout,
        attn_dropout=config.attn_dropout,
        use_rezero=config.use_rezero,
        use_scalenorm=config.use_scalenorm,
        tie_embed=config.tie_embed,
        qkv_bias=config.qkv_bias,
        attn_out_bias=config.attn_out_bias,
        rotary_position_emb=config.position_emb == "rotary",
        fixed_position_emb=config.position_emb == "fixed",
        axial_position_emb=config.position_emb == "axial",
        spatial_position_emb=config.spatial_position_emb,
        spatial_shape=tuple(latent_shape) if config.spatial_position_emb else None,
        ordering=ordering if config.spatial_position_emb else None,
        conditioning_num_tokens=config.conditioning_num_tokens,
        conditioning_type=(
            config.conditioning_type if config.conditioning_num_tokens else "none"
        ),
        # rows 6 and 5 on the card; their plain versions for CPU tensors
        use_pallas_local=config.use_pallas_local_attn,
        use_pallas_favor=config.use_pallas_favor_attn,
        attn_compute_dtype=_dtype(config.attn_compute_dtype),
        dtype=_dtype(config.compute_dtype) if dtype is None else dtype,
        generator=generator,
        device=device,
    )


def prepare_batch(latents: np.ndarray, ordering, vocab_size: int):
    """(B, H, W, D) int grids → (inputs, targets) (B, L) int32 with the
    BOS token (``vocab_size``) left-padded and a next-token shift
    (reference prepare_batch, src/utils/transformer.py:239-282)."""
    b = latents.shape[0]
    flat = latents.reshape(b, -1)
    seq = flat[:, ordering.get_sequence_ordering()]
    bos = np.full((b, 1), vocab_size, seq.dtype)
    padded = np.concatenate([bos, seq], axis=1)
    return padded[:, :-1].astype(np.int32), padded[:, 1:].astype(np.int32)


def _make_datasets(config: TransformerConfig, logger):
    from synthanatomy_tpu_torch.data.datasets import (
        LatentDataset,
        discover_subjects,
        load_conditionings,
    )

    def build(path):
        subjects = discover_subjects(path, extension=".npy")
        cond_values = None
        names = [os.path.basename(s["MRI"]) for s in subjects]
        if config.conditioning_path and config.conditionings:
            cond_values, _, kept = load_conditionings(
                config.conditioning_path, config.conditionings, names, logger=logger
            )
            subjects = [subjects[i] for i in kept]
        return LatentDataset(
            subjects,
            conditioning_values=cond_values,
            conditioning_names=config.conditionings or (),
        )

    train_ds = build(config.training_subjects)
    val_ds = build(config.validation_subjects) if config.validation_subjects else None
    if config.conditionings and train_ds.conditioning_num_tokens:
        object.__setattr__(config, "conditioning_num_tokens", train_ds.conditioning_num_tokens)
    return train_ds, val_ds


def _loader(config: TransformerConfig, dataset, batch_size: int, train: bool):
    from synthanatomy_tpu_torch.data.datasets import PrefetchLoader

    # batches loaded ahead of the step: DataLoader's prefetch_factor is per worker
    return PrefetchLoader(
        dataset, batch_size, shuffle=train, drop_last=train,
        num_workers=config.num_workers, prefetch=config.num_workers * config.prefetch_factor,
        seed=config.seed, collate_keys=("latents",),
    )


def _latent_shape(dataset) -> tuple:
    """The latent grid's shape from one sample (the reference peeks a
    batch; starting an epoch for it would load that epoch twice)."""
    return tuple(int(s) for s in dataset.get(0)["latents"].shape[:3])


def _tensors(batch: Dict[str, Any], ordering, vocab_size: int, device):
    inputs, targets = prepare_batch(batch["latents"], ordering, vocab_size)
    conds = ([torch.as_tensor(np.asarray(c), device=device) for c in batch["conditionings"]]
             if "conditionings" in batch else None)
    return (torch.from_numpy(inputs).to(device), torch.from_numpy(targets).to(device), conds)


def training(config: TransformerConfig) -> Dict[str, Any]:
    from synthanatomy_tpu_torch.interop import export_performer_state_dict, save_raw_state_dict
    from synthanatomy_tpu_torch.train import checkpoints as C
    from synthanatomy_tpu_torch.train import schedulers as S
    from synthanatomy_tpu_torch.train.logging import TBLogger
    from synthanatomy_tpu_torch.train.transformer_steps import (
        make_transformer_eval_step,
        make_transformer_train_step,
    )
    from synthanatomy_tpu_torch.utils.general import (
        PreemptionGuard,
        basic_initialization,
        log_network_size,
    )
    from synthanatomy_tpu_torch.utils.profiling import StepProfiler

    _check_supported(config)
    device = run_device(config)
    logger, dirs, ckpt_path, starting_epoch, seed = basic_initialization(
        config, "transformer-training"
    )
    train_ds, val_ds = _make_datasets(config, logger)
    train_loader = _loader(config, train_ds, config.batch_size, True)
    val_loader = _loader(config, val_ds, config.eval_batch_size, False) if val_ds else None
    epoch_length = len(train_loader)

    latent_shape = _latent_shape(train_ds)
    object.__setattr__(config, "latent_shape", latent_shape)
    logger.info(f"Latent shape: {latent_shape}")

    ordering = build_ordering(config, latent_shape)
    model = build_performer(config, ordering, latent_shape, device=device,
                            generator=torch.Generator().manual_seed(seed))
    state = create_transformer_train_state(model, seed, learning_rate=config.learning_rate)
    log_network_size(state.model, logger, config.network)
    if ckpt_path:
        state = C.load_checkpoint(ckpt_path, state)
        logger.info(f"Restored checkpoint from {ckpt_path}")

    step_fn = make_transformer_train_step(state.model)
    eval_fn = make_transformer_eval_step(state.model)
    tb_train = TBLogger(f"{dirs['logs_directory']}/train", enabled=config.rank == 0)
    tb_val = TBLogger(f"{dirs['logs_directory']}/val_eval", enabled=config.rank == 0)

    gamma = config.gamma
    if gamma == "auto":
        gamma = S.get_gamma(config.learning_rate, config.epochs, epoch_length)

    history: List[Dict[str, float]] = []
    best_metric = np.inf
    profiler = StepProfiler()
    guard = PreemptionGuard(logger)
    global_step = int(state.step)

    for epoch in range(max(starting_epoch, 0), config.epochs):
        t0 = time.time()
        lr = config.learning_rate * float(gamma) ** (epoch * epoch_length)
        epoch_loss, n_it = 0.0, 0
        for batch in train_loader.epoch(epoch):
            inputs, targets, conds = _tensors(batch, ordering, config.vocab_size, device)
            with profiler.step(global_step):
                state, metrics = step_fn(state, inputs, targets, conds, {"lr": lr})
            global_step += 1
            # accumulate on the device: a float() here would sync the host
            # to every step
            epoch_loss = epoch_loss + metrics["Loss"]
            n_it += 1

        epoch_loss = float(epoch_loss) / max(n_it, 1)
        history.append({"Loss": epoch_loss})
        if (epoch + 1) % config.log_every == 0 and config.rank == 0:
            tb_train.scalars({"Loss-CE": epoch_loss, "lr": lr}, epoch + 1)
            logger.info(
                f"epoch {epoch + 1}/{config.epochs} CE={epoch_loss:.4f} "
                f"({time.time() - t0:.1f}s)"
            )

        if (epoch + 1) % config.checkpoint_every == 0 or guard.should_stop:
            C.save_checkpoint(dirs["checkpoint_directory"], state, epoch + 1)
        if guard.should_stop:
            logger.warning(f"preempted: checkpointed at epoch {epoch + 1}")
            break

        if val_loader and (epoch + 1) % config.eval_every == 0:
            vlosses = []
            for batch in val_loader.epoch(epoch):
                inputs, targets, conds = _tensors(batch, ordering, config.vocab_size, device)
                vlosses.append(eval_fn(state, inputs, targets, conds)[1]["Loss"])
            # one host read per evaluation
            val_ce = float(torch.stack(vlosses).mean())
            # the eval CE reaches callers through the history
            if history:
                history[-1]["val_Loss"] = val_ce
            if config.rank == 0:
                tb_val.scalars({"Loss-CE": val_ce}, epoch + 1)
                logger.info(f"eval @ {epoch + 1}: CE={val_ce:.4f}")
            if val_ce < best_metric:
                best_metric = val_ce
                C.save_best_checkpoint(dirs["checkpoint_directory"], state, -val_ce)

    profiler.close()
    guard.restore()
    # after a preemption the loop broke at some epoch E < config.epochs;
    # the final checkpoint_epoch=config.epochs name would make auto-resume
    # treat training as complete
    if not guard.should_stop:
        C.save_checkpoint(dirs["checkpoint_directory"], state, config.epochs)
        if config.rank == 0:
            # the reference's end-of-training raw artifact
            # (run_transformer.py:290-292): a one-file torch state dict
            try:
                sd = export_performer_state_dict(state.model)
            except NotImplementedError as exc:  # ScaleNorm: no reference form
                logger.warning(f"raw state-dict export skipped: {exc}")
            else:
                out = save_raw_state_dict(
                    os.path.join(dirs["checkpoint_directory"],
                                 f"model_state_dict_epoch={config.epochs}"), sd)
                logger.info(f"wrote raw state dict {out}")
    tb_train.close()
    tb_val.close()
    return {"state": state, "history": history, "dirs": dirs, "ordering": ordering}


def inference(config: TransformerConfig) -> Dict[str, Any]:
    """Sampling mode: BOS-seeded batches → latent grids →
    ``*_sample.npy`` uint16 (run_transformer.py:296-402), one per latent
    file of ``--training_subjects`` (whose conditionings a conditioned
    prior samples with)."""
    from synthanatomy_tpu_torch.inferers import TransformerInferenceInferer
    from synthanatomy_tpu_torch.train import checkpoints as C
    from synthanatomy_tpu_torch.utils.general import basic_initialization

    device = run_device(config)
    logger, dirs, ckpt_path, _, seed = basic_initialization(config, "transformer-inference")
    if config.sp_shards > 1 or config.pp_stages > 1:
        logger.warning(
            "--sp_shards/--pp_stages are training-only flags; inference ignores them"
        )
    train_ds, _ = _make_datasets(config, logger)
    loader = _loader(config, train_ds, config.eval_batch_size, False)
    latent_shape = _latent_shape(train_ds)
    ordering = build_ordering(config, latent_shape)
    model = build_performer(config, ordering, latent_shape, device=device,
                            generator=torch.Generator().manual_seed(seed))
    state = create_transformer_train_state(model, seed)
    if ckpt_path:
        C.load_checkpoint(ckpt_path, state, models_only=True)
        logger.info(f"Loaded checkpoint {ckpt_path}")
    model.eval()

    with_conds = config.conditioning_num_tokens is not None
    # the reference inferer object (src/inferer/transformer.py:32-71);
    # "auto" takes the fused decode step wherever it covers the prior
    sampler = TransformerInferenceInferer(
        model, ordering,
        batch=config.eval_batch_size,
        temperature=config.temperature,
        top_k=config.top_k,
        sample=config.sample,
        with_conditionings=with_conds,
        ring_quant=config.use_int8_rings,
    )

    written: List[str] = []
    generator = torch.Generator(device=device).manual_seed(config.seed)
    for batch in loader.epoch(0):
        n_real = batch["latents"].shape[0]
        conds = None
        if with_conds:
            # pad the tail batch to the sampler's batch (extra samples are
            # discarded)
            reps = config.eval_batch_size - n_real
            conds = [torch.as_tensor(np.concatenate([c, np.repeat(c[-1:], reps, axis=0)]),
                                     device=device) for c in batch["conditionings"]]
        grids = sampler(generator, conds).cpu().numpy().astype(np.uint16)
        for b, src in enumerate(batch["paths"][:n_real]):
            base = os.path.basename(src).replace(".npy", "")
            out = f"{dirs['outputs_directory']}/{base}_sample.npy"
            np.save(out, grids[b])
            written.append(out)
    logger.info(f"Wrote {len(written)} samples to {dirs['outputs_directory']}")
    return {"written": written, "dirs": dirs}

"""Stage-2 orchestration: training / inference (sampling).

Port of ``synthanatomy_tpu/runners/transformer.py`` (the reference's
``training()`` run_transformer.py:47-293 and ``inference()``
:296-402): latent ``.npy`` loaders with the conditioning join, the
latent-grid shape read from one sample, the Ordering, the Performer, CE
training with exponential LR decay in a plain-Python epoch loop with the
reference's checkpoint / eval / logging cadences, and batch sampling
written as ``*_sample.npy`` uint16 (run_transformer.py:390-398).

One device: ``config.device`` is a CUDA ordinal, or ``"cpu"`` (the
tests' way to ask for the host).  Several devices (JAX :210-391,
430-520, 749-790): one process per card under torchrun, laid out by
``parallel/mesh.rank_layout`` and trained by the layout's step:

- ``--mesh_shape=(N,)``: the DP step (``make_transformer_train_step_dp``:
  gradients, loss and summaries averaged over the ranks, dropout from
  each rank's generator), ``--zero1`` sharding Adam's state;
- ``--sp_shards=s``: the (data, seq) layout and the SP step
  (``parallel/sequence_parallel.py``; the plain attention forms, as in
  JAX), the model and Adam replicated;
- ``--mesh_shape=(d, m)``: the (data, model) layout and the Megatron TP
  step (``parallel/tensor_parallel.py``: the one-device step on each
  rank's share; rows 5 and 6 on each rank's heads), every prior form, the
  attention and the FF split over the model ranks where their heads and
  hidden width divide (else replicated), with Adam split alike; dropout
  from one stream per data group, so the ranks of a model group draw the
  same masks;
- ``--pp_stages=P``: the (data, pipe) layout and the GPipe step
  (``parallel/pipeline_parallel.py``; the depth in P contiguous stages,
  one a rank, rows 5 and 6 in each stage's layers; the most microbatches
  up to 2P that divide ``--batch_size``, JAX's rule), each rank's Adam
  over its stage.

Under TP and PP a rank's card holds only its share or its stage:
parameters, FAVOR projections, gradients and Adam's moments.  The
canonical model is built on the host (the weights come from a CPU
generator, so they are the ones a build on the card draws), restored
there from a checkpoint, and split or packed onto the card; then only
world rank 0 keeps it, as the host state that checkpoints are gathered
into.  Checkpoints stay canonical: the model or pipe group that holds
rank 0 gathers its shares or stages onto rank 0 alone, one tensor at a
time (the other data groups hold the same after the averaged step),
rank 0 writes, and a resume splits or packs what it reads, so a TP or PP
checkpoint resumes on one device and the other way round.  The
evaluation runs on the share's own forward (TP) or through the pipe,
one microbatch a batch, the CE computed on the last stage and only the
loss sent back (PP).  The returned ``"state"`` is the canonical host
state on rank 0 and the rank's own TP or PP state elsewhere.

Each rank loads its data group's shard of the latents; rank 0 writes
checkpoints and logs, and the evaluation weights each rank's CE by its
real samples.  The projection redraw is equal on every rank.  Inference
ignores the layout flags, as JAX does: it takes the DP sampler
(``models/sampling.make_dp_sampler``) when the job has several ranks and
``--eval_batch_size`` divides over them (each rank samples its rows of
every global batch and rank 0 writes the grids), else rank 0 samples
every batch on its own card; it ignores ``--sp_shards`` and
``--pp_stages`` with a warning.  The attention takes rows 5 and 6's
kernels on the card under ``--use_pallas_favor_attn`` /
``--use_pallas_local_attn``; sampling takes the fused decode step (row
1) wherever it covers the prior.

The FAVOR projections are redrawn inside the train step
(``train/transformer_steps.py``), not in this loop as JAX does, and
the redraw counter travels in the checkpoint.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from synthanatomy_tpu_torch.config import TransformerConfig
from synthanatomy_tpu_torch.parallel.distributed import (
    any_rank,
    barrier,
    default_group,
    fold_in,
    sample_weighted_means,
)
from synthanatomy_tpu_torch.parallel.mesh import build_groups, rank_layout
from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state
from synthanatomy_tpu_torch.utils.general import run_device

__all__ = ["build_ordering", "build_performer", "prepare_batch", "training", "inference"]


def _check_supported(config: TransformerConfig):
    """The training run's rank layout (no groups yet); raises for a layout
    the job cannot hold."""
    layout = rank_layout(config.mesh_shape, config.world_size, config.rank,
                         sp_shards=config.sp_shards, pp_stages=config.pp_stages)
    if layout.inner == "pipe" and config.n_layers % config.pp_stages:
        raise ValueError(f"pp_stages={config.pp_stages} must divide n_layers="
                         f"{config.n_layers} (contiguous equal stages)")
    return layout


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


def _loader(config: TransformerConfig, dataset, batch_size: int, train: bool,
            shard=(0, 1)):
    """Shard ``shard`` = (index, count) of ``dataset`` (equal shards in
    training, each file once otherwise); (0, 1): all of it."""
    from synthanatomy_tpu_torch.data.datasets import PrefetchLoader

    # batches loaded ahead of the step: DataLoader's prefetch_factor is per worker
    return PrefetchLoader(
        dataset, batch_size, shuffle=train, drop_last=train,
        num_workers=config.num_workers, prefetch=config.num_workers * config.prefetch_factor,
        seed=config.seed, collate_keys=("latents",),
        shard_id=shard[0], num_shards=shard[1],
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
        make_transformer_train_step_dp,
    )
    from synthanatomy_tpu_torch.utils.general import (
        PreemptionGuard,
        basic_initialization,
        log_network_size,
    )
    from synthanatomy_tpu_torch.utils.profiling import StepProfiler

    layout = _check_supported(config)
    device = run_device(config)
    logger, dirs, ckpt_path, starting_epoch, seed = basic_initialization(
        config, "transformer-training"
    )
    layout = build_groups(layout)
    group = layout.group
    sp_mode, tp_mode, pp_mode = (layout.inner == k for k in ("seq", "model", "pipe"))
    # the ranks of an inner (seq, model or pipe) group share their data group's
    # rows; the evaluation reduces over the data group (all ranks under DP)
    shard = (layout.data_index, layout.shape[0])
    eval_group = layout.data_group
    train_ds, val_ds = _make_datasets(config, logger)
    train_loader = _loader(config, train_ds, config.batch_size, True, shard)
    val_loader = (_loader(config, val_ds, config.eval_batch_size, False, shard)
                  if val_ds else None)
    epoch_length = len(train_loader)

    latent_shape = _latent_shape(train_ds)
    object.__setattr__(config, "latent_shape", latent_shape)
    logger.info(f"Latent shape: {latent_shape}")

    ordering = build_ordering(config, latent_shape)
    # the same weights and projections on every rank; dropout from seed + rank,
    # or under a model axis from seed + data index: the ranks of a model group
    # share one stream, so their masks in the replicated stream agree.  Under
    # TP and PP the canonical model stays on the host: each rank's card gets
    # its share or its stage
    split = tp_mode or pp_mode
    model = build_performer(config, ordering, latent_shape, device="cpu" if split else device,
                            generator=torch.Generator().manual_seed(config.seed))
    zero1 = config.zero1 and group is not None and not tp_mode
    stream = layout.data_index if tp_mode else config.rank
    state = create_transformer_train_state(model, config.seed, rank=stream,
                                           learning_rate=config.learning_rate, zero1=zero1,
                                           process_group=group, device=device)
    log_network_size(state.model, logger, config.network)
    if zero1:
        logger.info(f"ZeRO-1: Adam state sharded over {config.world_size} ranks")
    if ckpt_path:
        state = C.load_checkpoint(ckpt_path, state)
        if config.world_size > 1:  # the file holds rank 0's dropout generator
            state.generator.set_state(fold_in(state.generator, stream).get_state())
        logger.info(f"Restored checkpoint from {ckpt_path}")

    want_pallas = config.use_pallas_local_attn or config.use_pallas_favor_attn
    train_state = state
    if sp_mode:
        from synthanatomy_tpu_torch.parallel.sequence_parallel import make_sp_train_step

        if want_pallas:
            logger.info("SP training uses the plain attention paths (the kernel flags apply "
                        "to non-SP training and sampling)")
        step_fn = make_sp_train_step(model, layout.inner_group,
                                     int(np.prod(latent_shape)), data_group=layout.data_group)
        logger.info(f"sequence-parallel step: {layout.shape[1]} seq shards"
                    + (f" x {layout.shape[0]} data shards" if layout.shape[0] > 1 else ""))
    elif tp_mode:
        from synthanatomy_tpu_torch.parallel import tensor_parallel as TP

        if config.zero1:
            logger.info("--zero1 has no effect under tensor parallelism: Adam is split like "
                        "the parameters over the model ranks")
        m = layout.shape[1]
        train_state = TP.shard_tp_state(model, state, layout.inner_group, device=device)
        step_fn = TP.make_tp_train_step(
            train_state.model, data_group=layout.data_group,
            use_pallas_local=config.use_pallas_local_attn,
            use_pallas_favor=config.use_pallas_favor_attn)
        split_attn, split_ff = TP.tp_split(model, m)
        gh = model.heads - model.local_attn_heads
        attn = (f"attention split ({gh // m} FAVOR + {model.local_attn_heads // m} local heads "
                f"a rank)" if split_attn else f"attention replicated ({gh} FAVOR / "
                f"{model.local_attn_heads} local heads do not both divide by {m})")
        ff = (f"FF split ({model.dim * model.ff_mult // m} hidden a rank)" if split_ff
              else f"FF replicated (hidden {model.dim * model.ff_mult} does not divide by {m})")
        logger.info(f"Megatron TP step over {m} model shards"
                    + (f" x {layout.shape[0]} data shards" if layout.shape[0] > 1 else "")
                    + f": {attn}, {ff}; embeddings, norms, gains and head replicated")
    elif pp_mode:
        from synthanatomy_tpu_torch.parallel import pipeline_parallel as PP

        # the most microbatches that divide the batch, at most 2 × stages
        # (the bubble (P-1)/(M+P-1) shrinks with M; smaller microbatches
        # stop paying for their launches): JAX's rule
        n_stages = layout.shape[1]
        n_mb = next(m for m in range(min(config.batch_size, 2 * n_stages), 0, -1)
                    if config.batch_size % m == 0)
        train_state = PP.pack_pp_state(model, state, layout.inner_group, device=device)
        step_fn = PP.make_pp_train_step(train_state.model, layout.inner_group,
                                        data_group=layout.data_group, n_microbatches=n_mb)
        logger.info(f"pipeline-parallel step: {n_stages} stages × {n_mb} microbatches"
                    + (f" × {layout.shape[0]} data shards" if layout.shape[0] > 1 else ""))
    else:
        step_fn = (make_transformer_train_step(state.model) if group is None
                   else make_transformer_train_step_dp(state.model, group))
    if pp_mode:
        # an evaluation batch need not divide into the training microbatches
        pipe_eval = PP.make_pipelined_apply(train_state.model, layout.inner_group,
                                            n_microbatches=1)

        def eval_fn(st, inputs, targets, conds):
            return None, {"Loss": pipe_eval.loss(inputs, targets, conds)}
    else:
        eval_fn = make_transformer_eval_step(train_state.model)
    if split and config.rank != 0:  # rank 0 alone keeps the host state to gather into
        model = state = None
    tb_train = TBLogger(f"{dirs['logs_directory']}/train", enabled=config.rank == 0)
    tb_val = TBLogger(f"{dirs['logs_directory']}/val_eval", enabled=config.rank == 0)

    gathered_at = [None]  # the TP or PP step count the canonical state was gathered at

    def canonical():
        """The canonical state to write: under TP or PP the shares or
        stages of rank 0's model or pipe group gathered onto rank 0's host
        state (a collective of that group, once per step count), None on
        the other ranks; otherwise the state itself."""
        if not split:
            return state
        if layout.data_index == 0 and gathered_at[0] != train_state.step:
            if tp_mode:
                TP.gather_tp_state(model, train_state, state, layout.inner_group,
                                   root_only=True)
            else:
                PP.unpack_pp_state(model, train_state, state, layout.inner_group,
                                   root_only=True)
            gathered_at[0] = train_state.step
        return state

    gamma = config.gamma
    if gamma == "auto":
        gamma = S.get_gamma(config.learning_rate, config.epochs, epoch_length)

    history: List[Dict[str, float]] = []
    best_metric = np.inf
    profiler = StepProfiler(rank=config.rank)
    guard = PreemptionGuard(logger)
    global_step = int(train_state.step)

    for epoch in range(max(starting_epoch, 0), config.epochs):
        t0 = time.time()
        lr = config.learning_rate * float(gamma) ** (epoch * epoch_length)
        epoch_loss, n_it = 0.0, 0
        for batch in train_loader.epoch(epoch):
            inputs, targets, conds = _tensors(batch, ordering, config.vocab_size, device)
            with profiler.step(global_step):
                train_state, metrics = step_fn(train_state, inputs, targets, conds, {"lr": lr})
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

        # a signal may reach the ranks at different steps: all stop, or none
        guard.should_stop = any_rank(guard.should_stop, group, device)
        if (epoch + 1) % config.checkpoint_every == 0 or guard.should_stop:
            C.save_checkpoint(dirs["checkpoint_directory"], canonical(), epoch + 1)
        if guard.should_stop:
            logger.warning(f"preempted: checkpointed at epoch {epoch + 1}")
            break

        if val_loader and (epoch + 1) % config.eval_every == 0:
            vlosses, sizes = [], []
            for batch in val_loader.epoch(epoch):
                inputs, targets, conds = _tensors(batch, ordering, config.vocab_size, device)
                vlosses.append(eval_fn(train_state, inputs, targets, conds)[1]["Loss"])
                sizes.append(inputs.shape[0])
            # one host read per evaluation
            if eval_group is None:
                val_ce = float(torch.stack(vlosses).mean())
            else:  # over the data ranks: each batch's CE weighted by its real samples
                val_ce = sample_weighted_means({"CE": vlosses}, sizes, eval_group, device)["CE"]
            # the eval CE reaches callers through the history
            if history:
                history[-1]["val_Loss"] = val_ce
            if config.rank == 0:
                tb_val.scalars({"Loss-CE": val_ce}, epoch + 1)
                logger.info(f"eval @ {epoch + 1}: CE={val_ce:.4f}")
            if val_ce < best_metric:
                best_metric = val_ce
                C.save_best_checkpoint(dirs["checkpoint_directory"], canonical(), -val_ce)

    profiler.close()
    guard.restore()
    # after a preemption the loop broke at some epoch E < config.epochs;
    # the final checkpoint_epoch=config.epochs name would make auto-resume
    # treat training as complete
    state = canonical()
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
    return {"state": train_state if state is None else state, "history": history, "dirs": dirs,
            "ordering": ordering}


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
            "--sp_shards/--pp_stages are training-only flags; inference ignores them "
            "(sampling scales out data-parallel)"
        )
    # the layout flags are training's: the sampler runs over every rank
    group = default_group()
    # several ranks: the DP sampler on every global batch when the batch
    # divides over them, else rank 0 alone (JAX's one-device sampler)
    dp = config.world_size > 1 and config.eval_batch_size % config.world_size == 0
    train_ds, _ = _make_datasets(config, logger)
    loader = _loader(config, train_ds, config.eval_batch_size, False)
    latent_shape = _latent_shape(train_ds)
    ordering = build_ordering(config, latent_shape)
    model = build_performer(config, ordering, latent_shape, device=device,
                            generator=torch.Generator().manual_seed(config.seed))
    state = create_transformer_train_state(model, config.seed)
    if ckpt_path:
        C.load_checkpoint(ckpt_path, state, models_only=True)
        logger.info(f"Loaded checkpoint {ckpt_path}")
    model.eval()

    with_conds = config.conditioning_num_tokens is not None
    generator = torch.Generator(device=device).manual_seed(config.seed)
    if dp:
        from synthanatomy_tpu_torch.models.sampling import make_dp_sampler

        sampler = make_dp_sampler(
            model, ordering, global_batch=config.eval_batch_size, process_group=group,
            temperature=config.temperature, top_k=config.top_k, do_sample=config.sample,
            with_conditionings=with_conds, ring_quant=config.use_int8_rings,
        )
        logger.info(f"DP sampler over {config.world_size} ranks")
    else:
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
    for batch in loader.epoch(0) if dp or config.rank == 0 else ():
        n_real = batch["latents"].shape[0]
        conds = None
        if with_conds:
            # pad the tail batch to the sampler's batch (extra samples are
            # discarded)
            reps = config.eval_batch_size - n_real
            conds = [torch.as_tensor(np.concatenate([c, np.repeat(c[-1:], reps, axis=0)]),
                                     device=device) for c in batch["conditionings"]]
        grids = sampler(generator, conds)
        if grids is None:  # a DP rank other than 0: rank 0 writes the batch
            continue
        grids = grids.cpu().numpy().astype(np.uint16)
        for b, src in enumerate(batch["paths"][:n_real]):
            base = os.path.basename(src).replace(".npy", "")
            out = f"{dirs['outputs_directory']}/{base}_sample.npy"
            np.save(out, grids[b])
            written.append(out)
    barrier(group)  # every rank's files are written when any rank returns
    logger.info(f"Wrote {len(written)} samples to {dirs['outputs_directory']}")
    return {"written": written, "dirs": dirs}

"""Stage-1 orchestration: training / extracting / decoding.

Port of ``synthanatomy_tpu/runners/vqvae.py`` (the reference's
``training()`` run_vqvae.py:59-392 and ``inference()``
run_vqvae.py:395-535): data loaders, networks, losses and the train
step (``train/vqvae_steps.py``) in a plain-Python epoch loop, with the
reference's checkpoint / eval / logging cadences and output contracts:

- extracting → ``*_quantization_i.npy`` uint16 codebook indices + the
  round-trip ``*_reconstruction.nii.gz`` (run_vqvae.py:468-498);
- decoding → ``*_sample.nii.gz`` from loaded latent grids
  (run_vqvae.py:500-514);
- with adversarial training on, ``*_adversarial_loss.npy``: the
  generator criterion's elementwise map of D's logits, in JAX's
  channels-last layout;
- augmentation trace CSV in extracting mode (run_vqvae.py:446-452).

One device: ``config.device`` is a CUDA ordinal, or ``"cpu"`` (the
tests' way to ask for the host).  Volumes go to the models as NCDHW.
The mesh, its sharding and ZeRO-1 over several devices are not ported
yet (ROADMAP.md §1): they raise ``NotImplementedError``.  With
``--device_augmentation`` the training loader ships the drawn
parameters and ``ops/augment.augment_batch`` applies them on the
device before each step (JAX's resampler rule: the 3-pass form below a
0.5 rad rotation range, else the exact gather).  Forward-only passes
(the evaluator and both inference modes) run the residual layers off
the fused kernel, as JAX does; the nearest-codeword search takes its
kernel on the card unless ``--use_pallas_vq=False``.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from synthanatomy_tpu_torch.config import VQVAEConfig
from synthanatomy_tpu_torch.train.vqvae_steps import create_vqvae_train_state
from synthanatomy_tpu_torch.utils.general import run_device

_MULTI_GPU = "ROADMAP.md §1, item 1 (Multi-GPU)"


def _check_supported(config: VQVAEConfig) -> None:
    if config.mesh_shape is not None and math.prod(config.mesh_shape) > 1:
        raise NotImplementedError(
            f"--mesh_shape={config.mesh_shape} (and --zero1 over it) spans several devices; "
            f"the port runs on one device until {_MULTI_GPU}")


def _dtype(config: VQVAEConfig) -> torch.dtype:
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32


def _volumes(batch: Dict[str, Any], device) -> torch.Tensor:
    """The loader's (B, D, H, W, 1) volumes → (B, 1, D, H, W) on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(batch["MRI"], np.float32))
    return x.permute(0, 4, 1, 2, 3).contiguous().to(device)


def _augmented(x: torch.Tensor, batch: Dict[str, Any], shifts) -> torch.Tensor:
    """The device chain (``ops/augment.augment_batch``) on ``_volumes``'
    output, returned in the same layout (a channels-last view): cuDNN
    keys its engines on the layout, so the step meets the host path's."""
    from synthanatomy_tpu_torch.ops.augment import augment_batch

    return augment_batch(x.permute(0, 2, 3, 4, 1), batch["augment"], shifts).permute(
        0, 4, 1, 2, 3)


def build_vqvae(config: VQVAEConfig, dtype=None, *, device="cuda", generator=None):
    from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE

    return BaselineVQVAE(
        n_levels=config.no_levels,
        downsample_parameters=config.downsample_parameters,
        upsample_parameters=config.upsample_parameters,
        n_embed=config.levels_num_embeddings,
        embed_dim=config.levels_embedding_dim,
        n_channels=config.no_channels,
        n_res_channels=config.no_channels,
        n_res_layers=config.no_res_layers,
        dropout=config.dropout,
        use_slim_residual=config.use_slim_residual,
        use_subpixel_conv=config.use_subpixel_conv,
        embedding_init=config.embedding_init[0],
        dtype=_dtype(config) if dtype is None else dtype,
        # True means "auto" (the kernel on the card, the plain search on
        # the CPU); False forces the plain search everywhere
        use_pallas_vq=None if config.use_pallas_vq else False,
        use_fused_residual=None if config.use_fused_residual else False,
        use_remat=config.use_remat,
        generator=generator,
        device=device,
    )


def _build_discriminator(config: VQVAEConfig, *, device, generator=None):
    from synthanatomy_tpu_torch.models.discriminator import BaselineDiscriminator

    return BaselineDiscriminator(dtype=_dtype(config), use_split_bn=config.grouped_stat_bn,
                                 generator=generator, device=device)


def _make_loaders(config: VQVAEConfig, mode: str):
    """The train loader (and the val and train_eval loaders with
    ``--validation_subjects``) on one device: no sharding."""
    from synthanatomy_tpu_torch.data.datasets import (
        PrefetchLoader,
        VolumeDataset,
        discover_subjects,
    )
    from synthanatomy_tpu_torch.data.transforms import VQVAETransform

    def dataset(subjects_path, augment, patch):
        subjects = discover_subjects(
            subjects_path,
            mode=mode,
            no_augmented_extractions=config.no_augmented_extractions,
        )
        tf = VQVAETransform(
            mode=mode,
            normalize=config.normalize,
            roi=config.roi,
            patch_size=patch,
            augment=augment,
            augmentation_probability=config.augmentation_probability,
            augmentation_strength=config.augmentation_strength,
        )
        return VolumeDataset(
            subjects, tf, load_nii_canonical=config.load_nii_canonical,
            seed=config.seed,
            # on-device augmentation in training only: the inference
            # modes take host-final volumes
            device_augment=config.device_augmentation and augment and mode == "training",
        )

    # batches loaded ahead of the step: DataLoader's prefetch_factor is per worker
    ahead = config.num_workers * config.prefetch_factor
    augment_train = mode == "training" or config.no_augmented_extractions > 0
    train_ds = dataset(config.training_subjects, augment_train, config.patch_size)
    loaders = {
        "train": PrefetchLoader(
            train_ds, config.batch_size, shuffle=mode == "training",
            drop_last=mode == "training", num_workers=config.num_workers,
            prefetch=ahead, seed=config.seed,
        )
    }
    if config.validation_subjects:
        val_ds = dataset(config.validation_subjects, False, config.eval_patch_size)
        loaders["val"] = PrefetchLoader(
            val_ds, config.eval_batch_size, shuffle=False, drop_last=False,
            num_workers=config.num_workers, prefetch=ahead,
            seed=config.seed,
        )
        train_eval_ds = dataset(config.training_subjects, False, config.eval_patch_size)
        loaders["train_eval"] = PrefetchLoader(
            train_eval_ds, config.eval_batch_size, shuffle=False, drop_last=False,
            num_workers=config.num_workers, prefetch=ahead,
            seed=config.seed,
        )
    return loaders


def resolve_lpips_params(config: VQVAEConfig, logger, device="cuda"):
    """Pretrained LPIPS when ``--lpips_weights`` is given (net kind
    validated against the loss), fixed-random features with a loud
    warning otherwise.  Reference behaviour being matched: the
    perceptual losses construct the pip package's pretrained nets
    (src/losses/vqvae/vqvae.py:836-869, 1656)."""
    from synthanatomy_tpu_torch.losses import vqvae as vql
    from synthanatomy_tpu_torch.losses.lpips import init_lpips_params, load_lpips_npz

    if not vql.loss_needs_lpips(config.loss):
        return None
    net = vql.lpips_net_for_loss(config.loss)
    if config.lpips_weights:
        lpips_params = load_lpips_npz(config.lpips_weights, device=device)
        if lpips_params["kind"] != net:
            raise ValueError(
                f"lpips_weights are for {lpips_params['kind']!r} but loss "
                f"{config.loss!r} needs {net!r}"
            )
        logger.info(f"Loaded pretrained LPIPS ({net}) from {config.lpips_weights}")
        return lpips_params
    lpips_params = init_lpips_params(net, generator=torch.Generator().manual_seed(0),
                                     device=device)
    logger.warning(
        "LPIPS is running with FIXED RANDOM features — perceptual loss "
        "values will NOT match the paper's pretrained "
        f"{net}Net LPIPS. Provide --lpips_weights=<path.npz> for exact behaviour."
    )
    return lpips_params


def _scheduled(config: VQVAEConfig, epoch: int, epoch_length: int) -> Dict[str, Any]:
    from synthanatomy_tpu_torch.train import schedulers as S

    gamma = config.gamma
    if gamma == "auto":
        gamma = S.get_gamma(config.learning_rate, config.epochs, epoch_length)
    lr = config.learning_rate * float(gamma) ** (epoch * epoch_length)

    decay = float(config.decay[0])
    if config.decay_warmup in ("step", "linear"):
        mde = config.max_decay_epochs
        if mde == "auto":
            mde = S.get_max_decay_epochs(epoch_length, config.batch_size)
        warmup = S.decay_warmup_step if config.decay_warmup == "step" else S.decay_warmup_linear
        decay = warmup(decay, int(mde), epoch)

    gdl = S.linear(
        initial_value=config.initial_factor_value,
        step_constant=config.initial_factor_steps,
        step_max_value=config.max_factor_steps,
        max_value=config.max_factor_value,
        current_step=epoch,
    )
    return {
        "lr": lr,
        "d_lr": config.discriminator_learning_rate,
        "decay": decay,
        "commitment_cost": float(config.commitment_cost[0]),
        "gdl_factor": gdl,
        "epoch": epoch,
    }


def make_finetune_gate(lo: float, hi: float, patience: int):
    """Device-side adversarial finetune gate (AdversarialFinetuneHandler
    semantics, reference src/handlers/vqvae.py:141-170): count the
    consecutive-steps streak of the D loss inside [lo, hi]; once the
    streak reaches ``patience``, generator training is released.

    The streak counter is a device tensor, so the gate costs no host
    sync a step; the runner reads ``released`` every
    ``gate_check_every`` steps.  The release is STICKY (``released |=
    streak >= patience``): a streak that completes and then breaks
    between two reads is never lost.  Returns ``(counter, released,
    d_loss) -> (counter, released)``."""

    def gate_update(counter, released, d_loss):
        in_range = (d_loss >= lo) & (d_loss <= hi)
        counter = torch.where(in_range, counter + 1, torch.zeros_like(counter))
        return counter, released | (counter >= patience)

    return gate_update


def training(config: VQVAEConfig) -> Dict[str, Any]:
    from synthanatomy_tpu_torch.metrics import get_ms_ssim_window, mae, ms_ssim_3d, mse
    from synthanatomy_tpu_torch.train import checkpoints as C
    from synthanatomy_tpu_torch.train.logging import TBLogger
    from synthanatomy_tpu_torch.train.vqvae_steps import (
        make_vqvae_eval_step,
        make_vqvae_train_step,
    )
    from synthanatomy_tpu_torch.utils.general import (
        PreemptionGuard,
        basic_initialization,
        log_network_size,
    )
    from synthanatomy_tpu_torch.utils.profiling import StepProfiler, device_memory_summary

    _check_supported(config)
    device = run_device(config)
    logger, dirs, ckpt_path, starting_epoch, seed = basic_initialization(
        config, "vqvae-training"
    )
    profiler = StepProfiler()
    guard = PreemptionGuard(logger)
    loaders = _make_loaders(config, "training")
    epoch_length = config.training_epoch_length or len(loaders["train"])

    # the input shape from one sample (the reference peeks a batch;
    # starting an epoch for it would load that epoch twice)
    input_shape = loaders["train"].dataset.get(0)["MRI"].shape[:3]
    logger.info(f"Input shape: {input_shape}")

    init = torch.Generator().manual_seed(seed)
    model = build_vqvae(config, device=device, generator=init)
    d_model = (_build_discriminator(config, device=device, generator=init)
               if config.adversarial_component else None)
    state = create_vqvae_train_state(
        model, seed,
        learning_rate=config.learning_rate,
        d_model=d_model,
        d_learning_rate=config.discriminator_learning_rate,
        device=device,
    )
    log_network_size(state.model, logger, config.network)

    if ckpt_path:
        state = C.load_checkpoint(ckpt_path, state)
        logger.info(f"Restored checkpoint from {ckpt_path}")

    lpips_params = resolve_lpips_params(config, logger, device)

    device_aug = loaders["train"].dataset.device_augment
    aug_shifts = None
    if device_aug:
        from synthanatomy_tpu_torch.ops.augment import shear_shift_bounds

        ranges = loaders["train"].dataset.transform.affine_ranges()
        if ranges["rotate_range"] < 0.5:
            # JAX's rule: the 3-pass resampler, its static shift bounds
            # covering the whole parameter box
            aug_shifts = shear_shift_bounds(input_shape, **ranges)
            logger.info(f"device augment: 3-pass resampler, shifts {aug_shifts}")
        else:
            logger.info("device augment: exact-gather resampler "
                        "(rotation range too large for the 3-pass form)")

    def build_step(train_generator: bool):
        return make_vqvae_train_step(
            state.model,
            loss_name=config.loss,
            d_model=state.d_model,
            generator_criterion=config.generator_loss,
            discriminator_criterion=config.discriminator_loss,
            use_adaptive_weight=config.use_adversarial_adaptive_weight,
            adaptive_threshold=config.adaptive_adversarial_weight_threshold,
            adaptive_value=config.adaptive_adversarial_weight_value,
            train_generator=train_generator,
            d_grouped_stats=config.grouped_stat_bn,
        )

    g_frozen = config.finetune_adversarial_component is not None
    gate_counter = gate_released = None
    gate_check_every = 1
    if g_frozen:
        gate_lo, gate_hi = config.finetune_adversarial_component
        gate_update = make_finetune_gate(gate_lo, gate_hi, int(config.finetune_patience))
        gate_counter = torch.zeros((), dtype=torch.int32, device=device)
        gate_released = torch.zeros((), dtype=torch.bool, device=device)
        gate_check_every = max(1, min(int(config.finetune_patience), 16))
    step_fn = build_step(not g_frozen)
    eval_step = make_vqvae_eval_step(state.model, loss_name=config.loss)

    tb_train = TBLogger(f"{dirs['logs_directory']}/train", enabled=config.rank == 0)
    tb_val = TBLogger(f"{dirs['logs_directory']}/val_eval", enabled=config.rank == 0)
    tb_train_eval = TBLogger(
        f"{dirs['logs_directory']}/train_eval", enabled=config.rank == 0
    )

    try:
        ms_ssim_win = get_ms_ssim_window(
            eval_patch_size=config.eval_patch_size, roi=config.roi,
            input_shape=input_shape,
        )
    except ValueError:
        # inputs too small for a multi-scale pyramid — skip MS-SSIM
        ms_ssim_win = None
        logger.warning("input too small for MS-SSIM; metric disabled")

    history: List[Dict[str, float]] = []
    best_metric = -np.inf
    global_step = int(state.step)

    def release_generator():
        nonlocal g_frozen, step_fn
        g_frozen = False
        step_fn = build_step(True)
        logger.info("Finetune gate released: generator training on")

    def run_eval(loader, epoch, sched):
        # metric scalars stay on the device inside the loop; one sync
        # per metric at the end
        vals = {"MAE": [], "MSE": [], "MS-SSIM": []}
        last = None
        with torch.no_grad(), state.model.unfused():
            for batch in loader.epoch(epoch):
                x = _volumes(batch, device)
                recon, _ = eval_step(state, x, sched, lpips_params)
                recon = recon.float()
                vals["MAE"].append(mae(recon, x))
                vals["MSE"].append(mse(recon, x))
                if ms_ssim_win is not None:
                    vals["MS-SSIM"].append(ms_ssim_3d(recon, x, win_size=ms_ssim_win))
                last = (batch["MRI"][0], recon[0, 0])
        if last is not None:
            last = (last[0], last[1].cpu().numpy())
        return {k: float(torch.stack(vs).mean()) for k, vs in vals.items() if vs}, last

    for epoch in range(max(starting_epoch, 0), config.epochs):
        sched = _scheduled(config, epoch, epoch_length)
        t_epoch = time.time()
        epoch_metrics: Dict[str, Any] = {}
        n_it = 0
        for it, batch in enumerate(loaders["train"].epoch(epoch)):
            if it >= epoch_length:
                break
            x = _volumes(batch, device)
            with profiler.step(global_step):
                if device_aug:
                    x = _augmented(x, batch, aug_shifts)
                state, metrics = step_fn(state, x, sched, lpips_params)
            global_step += 1
            n_it += 1
            for k, v in metrics.items():
                # accumulate on the device (float() here would sync the
                # host to every step)
                epoch_metrics[k] = epoch_metrics.get(k, 0.0) + v
            # finetune gate: the counter update stays on the device;
            # only the periodic check below touches the host
            if g_frozen and "Loss-Discriminator-Total" in metrics:
                gate_counter, gate_released = gate_update(
                    gate_counter, gate_released, metrics["Loss-Discriminator-Total"])
                if n_it % gate_check_every == 0 and bool(gate_released):
                    release_generator()

        # epoch-boundary gate check, so a release never slips past an
        # epoch end
        if g_frozen and gate_released is not None and bool(gate_released):
            release_generator()

        epoch_metrics = {k: float(v) / max(n_it, 1) for k, v in epoch_metrics.items()}
        if (epoch + 1) % config.log_every == 0 and config.rank == 0:
            epoch_metrics.update(device_memory_summary(device))
            tb_train.scalars(epoch_metrics, epoch + 1)
            tb_train.scalars({"lr": sched["lr"], "decay": sched["decay"]}, epoch + 1, "Sched/")
            logger.info(
                f"epoch {epoch + 1}/{config.epochs} "
                f"loss={epoch_metrics.get('Loss-Reconstruction-Total', float('nan')):.4f} "
                f"({time.time() - t_epoch:.1f}s)"
            )
        history.append(epoch_metrics)

        if (epoch + 1) % config.checkpoint_every == 0 or guard.should_stop:
            C.save_checkpoint(dirs["checkpoint_directory"], state, epoch + 1)
        if guard.should_stop:
            logger.warning(f"preempted: checkpointed at epoch {epoch + 1}")
            break

        if "val" in loaders and (epoch + 1) % config.eval_every == 0:
            val_metrics, last = run_eval(loaders["val"], epoch, sched)
            # clean-transform training-set evaluator (the reference's
            # third engine, run_vqvae.py:300)
            train_eval_metrics = (run_eval(loaders["train_eval"], epoch, sched)[0]
                                  if "train_eval" in loaders else {})
            if config.rank == 0:
                tb_val.scalars(val_metrics, epoch + 1)
                tb_train_eval.scalars(train_eval_metrics, epoch + 1)
                if last is not None and config.save_2d_images:
                    tb_val.volume_images("originals", last[0], epoch + 1, config.save_2d_images)
                    tb_val.volume_images("reconstructions", last[1], epoch + 1,
                                         config.save_2d_images)
                if last is not None and config.save_3d_images:
                    tb_val.volume_gif("originals_3d", last[0], epoch + 1)
                    tb_val.volume_gif("reconstructions_3d", last[1], epoch + 1)
                logger.info(f"eval @ {epoch + 1}: val {val_metrics} "
                            f"train_eval {train_eval_metrics}")
            # eval metrics reach callers through the history
            if history:
                history[-1].update({f"val_{k}": v for k, v in val_metrics.items()})
            key = val_metrics.get("MS-SSIM", -val_metrics.get("MSE", np.inf))
            if key > best_metric:
                best_metric = key
                C.save_best_checkpoint(dirs["checkpoint_directory"], state, key)

    profiler.close()
    guard.restore()
    # skip the final checkpoint_epoch=config.epochs save on preemption:
    # the loop broke at epoch E < config.epochs, and the final name would
    # make auto-resume treat training as complete (epoch-E state was
    # already checkpointed under its true epoch number above)
    if not guard.should_stop:
        C.save_checkpoint(dirs["checkpoint_directory"], state, config.epochs)
        if config.rank == 0:
            # the reference also writes a raw one-file state dict next to
            # the engine checkpoint at training end (run_vqvae.py:389-392)
            # — the release-artifact form its README distributes
            from synthanatomy_tpu_torch.interop import (
                export_vqvae_state_dict,
                save_raw_state_dict,
            )

            out = save_raw_state_dict(
                os.path.join(dirs["checkpoint_directory"],
                             f"model_state_dict_epoch={config.epochs}"),
                export_vqvae_state_dict(state.model),
            )
            logger.info(f"wrote raw state dict {out}")
    tb_train.close()
    tb_val.close()
    tb_train_eval.close()
    return {"state": state, "history": history, "dirs": dirs}


def inference(config: VQVAEConfig) -> Dict[str, Any]:
    """extracting / decoding modes (run_vqvae.py:395-535)."""
    from synthanatomy_tpu_torch.data.datasets import (
        LatentDataset,
        PrefetchLoader,
        discover_decoding_subjects,
    )
    from synthanatomy_tpu_torch.data.nifti import save_nifti
    from synthanatomy_tpu_torch.inferers import VQVAEDecodingInferer, VQVAEExtractionInferer
    from synthanatomy_tpu_torch.losses.adversarial import get_criterion
    from synthanatomy_tpu_torch.train import checkpoints as C
    from synthanatomy_tpu_torch.train.logging import save_npy_outputs, write_transform_trace_csv
    from synthanatomy_tpu_torch.utils.general import basic_initialization

    _check_supported(config)
    device = run_device(config)
    logger, dirs, ckpt_path, _, seed = basic_initialization(config, f"vqvae-{config.mode}")

    init = torch.Generator().manual_seed(seed)
    model = build_vqvae(config, device=device, generator=init)
    # The reference's inference engine also loads the discriminator when
    # adversarial training was on, scores the reconstruction/sample as
    # real and writes the *elementwise* criterion map per sample as
    # ``*_adversarial_loss.npy`` (run_vqvae.py:516-531; criterion
    # functions src/losses/adversarial/adversarial.py:77-105).
    d_model = criterion = None
    if config.adversarial_component:
        d_model = _build_discriminator(config, device=device, generator=init)
        criterion = get_criterion(config.generator_loss)
    state = create_vqvae_train_state(model, seed, d_model=d_model, device=device)
    if ckpt_path:
        C.load_checkpoint(ckpt_path, state, models_only=True)
        logger.info(f"Loaded checkpoint {ckpt_path}")

    def adversarial_maps(out, n):
        """The criterion's elementwise map per sample, channels-last as
        JAX writes it."""
        adv = criterion(out["adversarial_logits"].float(), True)
        return adv.permute(0, 2, 3, 4, 1).cpu().numpy()[:n]

    written: List[str] = []

    # forward-only modes never fuse the residual layers (JAX's policy:
    # the kernel's win is remat training only), as the evaluator
    with model.unfused():
        if config.mode == "extracting":
            loaders = _make_loaders(config, "extracting")
            inferer = VQVAEExtractionInferer(model, d_model)

            all_traces, all_paths = [], []
            for batch in loaders["train"].epoch(0):
                x = _volumes(batch, device)
                out = inferer(x)
                idx = out["quantization_0"].cpu().numpy()
                recon = out["reconstruction"][0].float().cpu().numpy()
                written += save_npy_outputs(
                    dirs["outputs_directory"], idx, batch["paths"],
                    postfix="quantization_0", dtype=np.uint16,
                    augmentation_ids=batch["augmentation_ids"],
                )
                if d_model is not None:
                    written += save_npy_outputs(
                        dirs["outputs_directory"], adversarial_maps(out, len(idx)),
                        batch["paths"], postfix="adversarial_loss", dtype=np.float32,
                        augmentation_ids=batch["augmentation_ids"],
                    )
                for b, src in enumerate(batch["paths"]):
                    base = src.split("/")[-1].replace(".nii.gz", "").replace(".nii", "")
                    out_nii = f"{dirs['outputs_directory']}/{base}_reconstruction.nii.gz"
                    save_nifti(out_nii, recon[b, 0], batch["affines"][b])
                    written.append(out_nii)
                all_traces += batch["traces"]
                all_paths += batch["paths"]
            trace_csv = write_transform_trace_csv(
                dirs["logs_directory"], all_traces, all_paths, rank=config.rank
            )
            if trace_csv:
                written.append(trace_csv)

        elif config.mode == "decoding":
            subjects = discover_decoding_subjects(config.training_subjects)
            loader = PrefetchLoader(
                LatentDataset(subjects), config.batch_size, shuffle=False, drop_last=False,
                num_workers=config.num_workers, collate_keys=("latents",),
            )
            # patient-space orientation for decoded samples: latent .npy
            # files carry no affine (the reference also writes identity
            # here); ``decoding_affine`` names a NIfTI whose affine is
            # stamped on every decoded sample instead
            affine = None
            if config.decoding_affine:
                from synthanatomy_tpu_torch.data.nifti import load_nifti

                affine = np.asarray(
                    load_nifti(config.decoding_affine, as_closest_canonical=False).affine
                )
                logger.info(f"Using affine from {config.decoding_affine}")

            inferer = VQVAEDecodingInferer(model, d_model)
            for batch in loader.epoch(0):
                lat = torch.from_numpy(np.asarray(batch["latents"], np.int32)).to(device)
                out = inferer([lat])
                recon = out["sample"][0].float().cpu().numpy()
                if d_model is not None:
                    written += save_npy_outputs(
                        dirs["outputs_directory"], adversarial_maps(out, len(recon)),
                        batch["paths"], postfix="adversarial_loss", dtype=np.float32,
                    )
                for b, src in enumerate(batch["paths"]):
                    base = src.split("/")[-1].replace(".npy", "")
                    out_nii = f"{dirs['outputs_directory']}/{base}_sample.nii.gz"
                    save_nifti(out_nii, recon[b, 0], affine)
                    written.append(out_nii)
        else:
            raise ValueError(f"inference() got mode {config.mode!r}")

    logger.info(f"Wrote {len(written)} outputs to {dirs['outputs_directory']}")
    return {"written": written, "dirs": dirs}

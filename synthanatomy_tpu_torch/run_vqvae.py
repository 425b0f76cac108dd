"""Stage-1 (3D VQ-VAE) CLI of the PyTorch port — flag-surface parity
with the top-level ``run_vqvae.py`` (run() signature at reference
run_vqvae.py:538-626):
``python -m synthanatomy_tpu_torch.run_vqvae run --training_subjects=... --mode=training``.

Modes: ``training`` / ``extracting`` / ``decoding``
(reference src/utils/vqvae.py:34-37; dispatch run_vqvae.py:848-855).
``--device`` picks the CUDA device by ordinal; ``--device=cpu`` runs on
the host (the tests do).  Without a card and without ``--device=cpu``
the run raises.  Several cards, one process each:
``torchrun --nproc_per_node=N -m synthanatomy_tpu_torch.run_vqvae run
--mesh_shape='(N,)' [--zero1=True] ...`` (rank r on ``cuda:LOCAL_RANK``
over NCCL; with ``--device=cpu`` the ranks run on the CPU over gloo).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

from synthanatomy_tpu_torch.cli import dispatch
from synthanatomy_tpu_torch.config import VQVAEConfig

TORCH_DISTRIBUTED_DEFAULT_PORT = 29500


def run(
    # File system parameters
    training_subjects: Union[str, Tuple[str, ...]] = "",
    validation_subjects: Union[str, Tuple[str, ...]] = "",
    project_directory: str = "",
    experiment_name: str = "",
    mode: str = "training",
    no_augmented_extractions: int = 0,
    decoding_affine: Optional[str] = None,
    # Hardware parameters
    device: Union[int, str] = 0,
    distributed_port: int = TORCH_DISTRIBUTED_DEFAULT_PORT,
    amp: bool = True,
    deterministic: bool = False,
    cuda_benchmark: bool = True,
    seed: int = 4,
    # Training parameters
    epochs: int = 100,
    learning_rate: float = 0.0003,
    gamma: Union[str, float] = 0.99999,
    log_every: int = 1,
    checkpoint_every: int = 1,
    eval_every: int = 5,
    augmentation_probability: float = 0.2,
    augmentation_strength: float = 0,
    # on-device augmentation (ops/augment.py), training only
    device_augmentation: bool = False,
    # Loss parameters
    loss: str = "jukebox_perceptual",
    lpips_weights: Optional[str] = None,
    adversarial_component: bool = True,
    # Adversarial loss parameters
    finetune_adversarial_component: Optional[Tuple[float, float]] = None,
    finetune_patience: int = 100,
    discriminator_network: str = "baseline_discriminator",
    discriminator_learning_rate: float = 0.0005,
    discriminator_loss: str = "least_square",
    generator_loss: str = "least_square",
    use_adversarial_adaptive_weight: bool = False,
    adaptive_adversarial_weight_threshold: int = 0,
    adaptive_adversarial_weight_value: float = 1,
    # Baur factor
    initial_factor_value: float = 0,
    initial_factor_steps: int = 25,
    max_factor_steps: int = 50,
    max_factor_value: float = 5,
    # Dataset parameters
    normalize: bool = True,
    roi=None,
    batch_size: int = 3,
    patch_size: Optional[Tuple[int, int, int]] = None,
    eval_batch_size: int = 3,
    eval_patch_size: Optional[Tuple[int, int, int]] = None,
    training_epoch_length: Optional[int] = None,
    num_workers: int = 8,
    prefetch_factor: int = 8,
    starting_epoch: int = 0,
    # Network parameters
    network: str = "baseline_vqvae",
    use_subpixel_conv: bool = False,
    use_slim_residual: bool = True,
    no_levels: int = 3,
    downsample_parameters: Tuple[Tuple[int, int, int, int], ...] = (
        (4, 2, 1, 1),
        (4, 2, 1, 1),
        (4, 2, 1, 1),
    ),
    upsample_parameters: Tuple[Tuple[int, int, int, int, int], ...] = (
        (4, 2, 1, 0, 1),
        (4, 2, 1, 0, 1),
        (4, 2, 1, 0, 1),
    ),
    no_res_layers: int = 3,
    no_channels: int = 256,
    codebook_type: str = "ema",
    num_embeddings: Tuple[int, ...] = (256,),
    embedding_dim: Tuple[int, ...] = (256,),
    embedding_init: Tuple[str, ...] = ("normal",),
    commitment_cost: Tuple[float, ...] = (0.25,),
    decay: Tuple[float, ...] = (0.99,),
    decay_warmup: Optional[str] = None,
    max_decay_epochs: Union[str, int] = 50,
    norm: Optional[str] = None,
    dropout: float = 0.0,
    act: str = "RELU",
    output_act: Optional[str] = None,
    evaluation_checkpoint: str = "recent",
    load_nii_canonical: bool = True,
    save_2d_images: tuple = ("axial", "saggital", "coronal"),
    save_3d_images: Optional[tuple] = None,
    # additions of the JAX package (the data mesh: one rank per card under torchrun)
    mesh_shape: Optional[Tuple[int, ...]] = None,
    compute_dtype: str = "bfloat16",
    use_pallas_vq: bool = True,
    use_remat: bool = True,
    zero1: bool = False,
    grouped_stat_bn: bool = False,
):
    """Build the typed config and dispatch on ``mode``.  See
    VQVAEConfig for flag documentation (mirrors the reference's
    docstrings at run_vqvae.py:627-826)."""
    cfg_kwargs = {
        k: v for k, v in locals().items() if k in VQVAEConfig.__dataclass_fields__
    }
    # torchrun's ranks (the reference's RANK/WORLD_SIZE plumbing,
    # run_vqvae.py:831-846): the process group first, then the rank
    from synthanatomy_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from synthanatomy_tpu_torch.parallel.mesh import host_shard_info

    maybe_initialize_distributed(device)
    cfg_kwargs["rank"], cfg_kwargs["world_size"] = host_shard_info()
    # amp=False → f32 compute (the reference's AMP toggle; the 'on'
    # form is the bf16 policy)
    if not amp and compute_dtype == "bfloat16":
        cfg_kwargs["compute_dtype"] = "float32"
    config = VQVAEConfig(**cfg_kwargs)

    from synthanatomy_tpu_torch.runners import vqvae as runner

    if config.mode == "training":
        return runner.training(config)
    elif config.mode in ("extracting", "decoding"):
        return runner.inference(config)
    raise ValueError(
        f"Mode {config.mode!r} unknown; choices are "
        "('training', 'extracting', 'decoding')."
    )


if __name__ == "__main__":
    dispatch({"run": run})

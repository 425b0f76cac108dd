"""Typed experiment configuration.

The port's own copy of ``synthanatomy_tpu/config.py`` (which holds no
JAX); its comments on TPU behaviour describe the reference.  One change:
``VQVAEConfig.device`` and ``TransformerConfig.device`` also take
``"cpu"``, the port's way to run on the host.

The reference uses the ``run()`` function signature as the config schema
and ``config = locals()`` as the config object, mutated en route
(reference run_vqvae.py:538-626,827; run_transformer.py:405-474,604).
Here that exact flag surface is formalized into frozen-ish dataclasses;
the CLI (``synthanatomy_tpu_torch.cli``) parses ``--flag=value`` with Python
literal syntax (Fire-compatible, e.g.
``--roi='((16,176),(16,240),(96,256))'``) into these.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# enums-as-tuples (keep plain strings at the API surface like the reference)
# ---------------------------------------------------------------------------

VQVAE_MODES = ("training", "extracting", "decoding")  # ref src/utils/vqvae.py:34-37
TRANSFORMER_MODES = ("training", "inference")  # ref src/utils/transformer.py:16-18
CONDITIONING_TYPES = ("none", "bos_replacement", "prepending")  # ref src/utils/transformer.py:21-24
VQVAE_NETWORKS = ("baseline_vqvae",)
DISCRIMINATOR_NETWORKS = ("baseline_discriminator",)
TRANSFORMER_NETWORKS = ("performer",)
ADVERSARIAL_CRITERIA = ("vanilla", "hinge", "least_square")  # ref src/losses/adversarial/utils.py:4-8
VQVAE_LOSSES = (
    "baur",
    "mse",
    "spectral",
    "hartley",
    "jukebox",
    "wavegan",
    "perceptual",
    "jukebox_perceptual",
    "hartley_perceptual",
    "baseline",
)  # ref src/losses/vqvae/utils.py:4-15


def _astuple(x: Any) -> Optional[tuple]:
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return tuple(_astuple(e) if isinstance(e, (list, tuple)) else e for e in x)
    return (x,)


@dataclass
class VQVAEConfig:
    """Full flag surface of the reference VQ-VAE CLI
    (run_vqvae.py:538-626), plus TPU-specific additions at the bottom."""

    # --- file system
    training_subjects: Union[str, Tuple[str, ...]] = ""
    validation_subjects: Union[str, Tuple[str, ...]] = ""
    project_directory: str = ""
    experiment_name: str = ""
    mode: str = "training"
    no_augmented_extractions: int = 0
    # decoding mode: optional NIfTI whose affine is stamped on decoded
    # samples (latent .npy inputs carry no orientation; the reference
    # writes identity here — this flag restores patient space)
    decoding_affine: Optional[str] = None
    # --- hardware
    device: Union[int, str] = 0  # the port: a CUDA ordinal, or "cpu"
    distributed_port: int = 29500
    amp: bool = True  # on TPU: bf16 compute policy, no loss scaling
    deterministic: bool = False
    cuda_benchmark: bool = True  # accepted for CLI compat; no-op on TPU
    seed: int = 4
    # --- training
    epochs: int = 100
    learning_rate: float = 0.0003
    gamma: Union[str, float] = 0.99999
    log_every: int = 1
    checkpoint_every: int = 1
    eval_every: int = 5
    augmentation_probability: float = 0.2
    augmentation_strength: float = 0.0
    # run the randomized augmentations (affine resample + photometric
    # ops) on the device before each train step (ops/augment.py) instead
    # of scipy on the host.  Decisions and parameters still come from the
    # per-sample host rng, so the trace CSV contract holds.  Full-volume
    # training only (patch mode stays on the host).  Off by default: the
    # 3-pass resampler is multi-pass linear, not scipy-exact.
    device_augmentation: bool = False
    # --- loss
    loss: str = "jukebox_perceptual"
    # pretrained LPIPS weights (.npz from tools/convert_lpips.py /
    # tools/fetch_lpips_weights.py); None → fixed-random features with a
    # loud warning (this environment has no egress to fetch them)
    lpips_weights: Optional[str] = None
    adversarial_component: bool = True
    # --- adversarial
    finetune_adversarial_component: Optional[Tuple[float, float]] = None
    finetune_patience: int = 100
    discriminator_network: str = "baseline_discriminator"
    discriminator_learning_rate: float = 0.0005
    discriminator_loss: str = "least_square"
    generator_loss: str = "least_square"
    use_adversarial_adaptive_weight: bool = False
    adaptive_adversarial_weight_threshold: int = 0
    adaptive_adversarial_weight_value: float = 1.0
    # --- Baur GDL factor schedule
    initial_factor_value: float = 0
    initial_factor_steps: int = 25
    max_factor_steps: int = 50
    max_factor_value: float = 5
    # --- dataset
    normalize: bool = True
    roi: Optional[tuple] = None
    batch_size: int = 3
    patch_size: Optional[Tuple[int, int, int]] = None
    eval_batch_size: int = 3
    eval_patch_size: Optional[Tuple[int, int, int]] = None
    training_epoch_length: Optional[int] = None
    num_workers: int = 8
    prefetch_factor: int = 8
    starting_epoch: int = 0
    # --- network
    network: str = "baseline_vqvae"
    use_subpixel_conv: bool = False
    use_slim_residual: bool = True
    no_levels: int = 3
    downsample_parameters: Tuple[Tuple[int, int, int, int], ...] = (
        (4, 2, 1, 1),
        (4, 2, 1, 1),
        (4, 2, 1, 1),
    )
    upsample_parameters: Tuple[Tuple[int, int, int, int, int], ...] = (
        (4, 2, 1, 0, 1),
        (4, 2, 1, 0, 1),
        (4, 2, 1, 0, 1),
    )
    no_res_layers: int = 3
    no_channels: int = 256
    codebook_type: str = "ema"
    num_embeddings: Tuple[int, ...] = (256,)
    embedding_dim: Tuple[int, ...] = (256,)
    embedding_init: Tuple[str, ...] = ("normal",)
    commitment_cost: Tuple[float, ...] = (0.25,)
    decay: Tuple[float, ...] = (0.99,)
    decay_warmup: Optional[str] = None
    max_decay_epochs: Union[str, int] = 50
    norm: Optional[str] = None
    dropout: float = 0.0
    act: str = "RELU"
    output_act: Optional[str] = None
    evaluation_checkpoint: str = "recent"
    load_nii_canonical: bool = True
    save_2d_images: Optional[tuple] = ("axial", "saggital", "coronal")
    save_3d_images: Optional[tuple] = None
    # --- TPU-native additions (not in the reference surface)
    mesh_shape: Optional[Tuple[int, ...]] = None  # default: all devices on 'data'
    mesh_axis_names: Tuple[str, ...] = ("data", "model")
    compute_dtype: str = "bfloat16"
    use_pallas_vq: bool = True
    # fused residual-layer Pallas kernel (fwd + bwd) on TPU when the
    # shape gate passes; False forces the XLA conv chain
    use_fused_residual: bool = True
    use_remat: bool = True
    donate_state: bool = True
    # one-pass D(fake)+D(real) update with per-half BatchNorm statistics
    # (SplitBatchNorm) — exact two-pass semantics, fewer conv dispatches
    grouped_stat_bn: bool = False
    # ZeRO-1: shard the Adam moments over the data axis (memory lever
    # for many-chip DP; pure placement annotation under GSPMD)
    zero1: bool = False
    # mutated-en-route fields (the reference mutates its config dict;
    # we keep them explicit)
    input_shape: Optional[Tuple[int, int, int]] = None
    epoch_length: Optional[int] = None
    rank: int = 0
    world_size: int = 1

    def __post_init__(self):
        if self.mode not in VQVAE_MODES:
            raise ValueError(f"mode must be one of {VQVAE_MODES}, got {self.mode!r}")
        if self.network not in VQVAE_NETWORKS:
            raise ValueError(f"unknown network {self.network!r}")
        if self.loss not in VQVAE_LOSSES:
            raise ValueError(f"loss must be one of {VQVAE_LOSSES}, got {self.loss!r}")
        if self.adversarial_component:
            if self.discriminator_loss not in ADVERSARIAL_CRITERIA:
                raise ValueError(f"unknown discriminator_loss {self.discriminator_loss!r}")
            if self.generator_loss not in ADVERSARIAL_CRITERIA:
                raise ValueError(f"unknown generator_loss {self.generator_loss!r}")
        for name in (
            "num_embeddings",
            "embedding_dim",
            "embedding_init",
            "commitment_cost",
            "decay",
            "downsample_parameters",
            "upsample_parameters",
        ):
            object.__setattr__(self, name, _astuple(getattr(self, name)))
        if self.roi is not None:
            object.__setattr__(self, "roi", _astuple(self.roi))
        if len(self.downsample_parameters) != self.no_levels:
            raise ValueError(
                f"downsample_parameters must have {self.no_levels} levels, got "
                f"{len(self.downsample_parameters)}"
            )
        if len(self.upsample_parameters) != self.no_levels:
            raise ValueError(
                f"upsample_parameters must have {self.no_levels} levels, got "
                f"{len(self.upsample_parameters)}"
            )
        if self.mesh_shape is not None and len(self.mesh_shape) > 1 \
                and self.mesh_shape[1] > 1:
            # previously a (d, m>1) mesh silently replicated the conv
            # model over the model axis (wasted devices) — the VQ-VAE
            # has no tensor-parallel path; its scale-out is DP (the
            # reference's DDP equivalent) + ZeRO-1
            raise ValueError(
                "the VQ-VAE trains data-parallel only; a model mesh "
                "axis is not supported — use --mesh_shape='(N,)' "
                "(+ --zero1); tensor parallelism is a transformer-CLI "
                "feature"
            )

    # the interface is single-level today but typed as lists for future
    # hierarchical VQ, like the reference (run_vqvae.py:636-637)
    @property
    def levels_num_embeddings(self) -> int:
        return int(self.num_embeddings[0])

    @property
    def levels_embedding_dim(self) -> int:
        return int(self.embedding_dim[0])


@dataclass
class TransformerConfig:
    """Full flag surface of the reference transformer CLI
    (run_transformer.py:405-474) plus network-level Performer options
    (performer.py:75-115) and TPU-specific additions."""

    # --- file system
    training_subjects: str = ""
    validation_subjects: str = ""
    project_directory: str = ""
    experiment_name: str = ""
    mode: str = "training"
    conditioning_path: Optional[str] = None
    conditionings: Optional[Tuple[str, ...]] = None
    conditioning_type: str = "bos_replacement"
    # --- hardware
    device: Union[int, str] = 0  # the port: a CUDA ordinal, or "cpu"
    deterministic: bool = False
    cuda_benchmark: bool = True
    seed: int = 2
    # --- training
    epochs: int = 1_000_000
    learning_rate: float = 1e-4
    gamma: Union[str, float] = "auto"
    log_every: int = 25
    checkpoint_every: int = 50
    eval_every: int = 50
    # --- inference
    sample: bool = True
    temperature: float = 1.0
    top_k: Optional[int] = None
    # --- dataset
    batch_size: int = 2
    eval_batch_size: int = 2
    num_workers: int = 8
    prefetch_factor: int = 6
    starting_epoch: int = 0
    # --- sequence ordering
    ordering_type: str = "raster_scan"
    reflected_spatial_dims: Tuple[bool, ...] = (False, False, False)
    transpositions_axes: Tuple[Tuple[int, ...], ...] = ()
    rot90_axes: Tuple[Tuple[int, ...], ...] = ()
    transformation_order: Tuple[str, ...] = ("transpose", "rotate_90", "reflect")
    # --- network
    network: str = "performer"
    vocab_size: int = 32
    n_embd: int = 256
    n_layers: int = 10
    n_head: int = 8
    dim_head: int = 64
    local_attn_heads: int = 0
    local_window_size: int = 256
    feature_redraw_interval: int = 1000
    generalized_attention: bool = False
    nb_features: Optional[int] = None
    ff_mult: int = 4
    ff_glu: bool = False
    ff_chunks: int = 1
    reversible: bool = False
    # TPU memory lever: remat attention only.  Off by default — the
    # paper config (24L/d512, b6, L1401) fits 16 GB HBM without it and
    # trains ~28% faster; turn on for bigger batches/models.
    remat_attention: bool = False
    emb_dropout: float = 0.0
    ff_dropout: float = 0.0
    attn_dropout: float = 0.0
    use_rezero: bool = False
    use_scalenorm: bool = False
    tie_embed: bool = False
    qkv_bias: bool = False
    attn_out_bias: bool = False
    position_emb: str = "absolute"  # absolute | rotary | fixed | axial
    spatial_position_emb: Optional[str] = None  # None | absolute | fixed
    evaluation_checkpoint: str = "recent"
    # --- TPU-native additions
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axis_names: Tuple[str, ...] = ("data", "model")
    compute_dtype: str = "bfloat16"
    # operand dtype of the attention-internal matmuls (fp32 accumulate);
    # bfloat16 ≈ 2× training throughput, fp32 = bit-exact with decode
    attn_compute_dtype: str = "bfloat16"
    # flash-style Pallas local-attention kernels (auto-falls back to the
    # XLA path off-TPU); 2.3x the XLA batch path at the paper shape
    use_pallas_local_attn: bool = True
    # fused Pallas FAVOR+ kernels (feature maps + causal prefix scan,
    # fwd + two-sweep bwd); ~1.4x the XLA path at the paper shape
    use_pallas_favor_attn: bool = True
    # int8 local-head ring buffers in the fused decode kernel (+17%
    # sampling; quality-guarded). The fused path already streams int8
    # weights; set False for bf16 rings, fused=False for the exact path
    use_int8_rings: bool = True
    donate_state: bool = True
    # ZeRO-1: shard the Adam moments over the data axis under pure DP
    zero1: bool = False
    # Sequence (context) parallelism: shard the TOKEN axis of training
    # over this many devices (the long-context hardware lever, SURVEY
    # §5.7 — params replicated, attention does halo/prefix collectives
    # over ICI).  0/1 = off.  Composes with DP (remaining devices form
    # the data axis); not composable with a model mesh axis or zero1.
    sp_shards: int = 0
    # Pipeline parallelism (GPipe): shard the DEPTH axis of training
    # over this many stages (for models deeper than one chip's HBM);
    # microbatches stream through a fill-drain ppermute schedule.
    # 0/1 = off.  Composes with DP (remaining devices form the data
    # axis); not composable with sp_shards / a model mesh axis / zero1.
    pp_stages: int = 0
    # mutated-en-route
    latent_shape: Optional[Tuple[int, int, int]] = None
    conditioning_num_tokens: Optional[Tuple[int, ...]] = None
    rank: int = 0
    world_size: int = 1

    def __post_init__(self):
        if self.mode not in TRANSFORMER_MODES:
            raise ValueError(
                f"mode must be one of {TRANSFORMER_MODES}, got {self.mode!r}"
            )
        if self.conditioning_type not in CONDITIONING_TYPES:
            raise ValueError(
                f"conditioning_type must be one of {CONDITIONING_TYPES}, got "
                f"{self.conditioning_type!r}"
            )
        if self.network not in TRANSFORMER_NETWORKS:
            raise ValueError(f"unknown network {self.network!r}")
        if self.position_emb not in ("absolute", "rotary", "fixed", "axial"):
            raise ValueError(f"unknown position_emb {self.position_emb!r}")
        if self.spatial_position_emb not in (None, "absolute", "fixed"):
            raise ValueError(
                f"spatial_position_emb must be None/'absolute'/'fixed', got "
                f"{self.spatial_position_emb!r}"
            )
        for name in ("transpositions_axes", "rot90_axes", "reflected_spatial_dims",
                     "transformation_order"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, _astuple(v))
        if self.conditionings is not None:
            object.__setattr__(self, "conditionings", _astuple(self.conditionings))
        if self.sp_shards < 0:
            raise ValueError(f"sp_shards must be >= 0, got {self.sp_shards}")
        if self.pp_stages < 0:
            raise ValueError(f"pp_stages must be >= 0, got {self.pp_stages}")
        if self.sp_shards > 1 and self.pp_stages > 1:
            raise ValueError(
                "sp_shards and pp_stages are mutually exclusive; pick "
                "sequence OR pipeline parallelism (each composes with DP)"
            )
        for flag in ("sp_shards", "pp_stages"):
            if getattr(self, flag) > 1:
                if self.mesh_shape is not None:
                    # the SP/PP runner derives its own ('data', 'seq'/
                    # 'pipe') mesh; a silently-ignored explicit mesh
                    # would mislead (and a model axis would be TP×SP/
                    # TP×PP, which is unsupported)
                    raise ValueError(
                        f"{flag} derives the device mesh itself; drop "
                        f"--mesh_shape (use --mesh_shape for DP/TP or "
                        f"--{flag} alone)"
                    )
                if self.zero1:
                    raise ValueError(
                        "zero1 shards the optimizer over the data axis "
                        f"under pure DP; not composable with {flag}"
                    )


def replace(cfg, **kw):
    """dataclasses.replace that re-runs validation."""
    return dataclasses.replace(cfg, **kw)

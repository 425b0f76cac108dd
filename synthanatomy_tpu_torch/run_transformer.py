"""Stage-2 (Performer AR prior) CLI of the PyTorch port — flag-surface
parity with the top-level ``run_transformer.py`` (run() signature at
reference run_transformer.py:405-474):
``python -m synthanatomy_tpu_torch.run_transformer run --training_subjects=... --mode=training``.

Modes: ``training`` / ``inference``
(reference src/utils/transformer.py:16-18; dispatch :624-631).
``--device`` picks the CUDA device by ordinal; ``--device=cpu`` runs on
the host (the tests do).  Without a card and without ``--device=cpu``
the run raises.  Several cards, one process each:
``torchrun --nproc_per_node=N -m synthanatomy_tpu_torch.run_transformer run
--mesh_shape='(N,)' [--zero1=True] ...`` (rank r on ``cuda:LOCAL_RANK``
over NCCL; with ``--device=cpu`` the ranks run on the CPU over gloo);
``--sp_shards=s`` trains sequence-parallel, ``--mesh_shape='(d,m)'``
tensor-parallel (``runners/transformer.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

from synthanatomy_tpu_torch.cli import dispatch
from synthanatomy_tpu_torch.config import TransformerConfig


def run(
    # File system parameters
    training_subjects: str = "",
    validation_subjects: str = "",
    project_directory: str = "",
    experiment_name: str = "",
    mode: str = "training",
    conditioning_path: Optional[str] = None,
    conditionings: Optional[Tuple[str, ...]] = None,
    conditioning_type: str = "bos_replacement",
    # Hardware parameters
    device: Union[int, str] = 0,
    deterministic: bool = False,
    cuda_benchmark: bool = True,
    seed: int = 2,
    # Training parameters
    epochs: int = 1000000,
    learning_rate: float = 1e-4,
    gamma: Union[str, float] = "auto",
    log_every: int = 25,
    checkpoint_every: int = 50,
    eval_every: int = 50,
    # Inference parameters
    sample: bool = True,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    # Dataset parameters
    batch_size: int = 2,
    eval_batch_size: int = 2,
    num_workers: int = 8,
    prefetch_factor: int = 6,
    starting_epoch: int = 0,
    # Sequence ordering parameters
    ordering_type: str = "raster_scan",
    reflected_spatial_dims: Tuple[bool, ...] = (False, False, False),
    transpositions_axes: Tuple[Tuple[int, ...], ...] = (),
    rot90_axes: Tuple[Tuple[int, ...], ...] = (),
    transformation_order: Tuple[str, ...] = ("transpose", "rotate_90", "reflect"),
    # Network parameters
    network: str = "performer",
    vocab_size: int = 32,
    n_embd: int = 256,
    n_layers: int = 10,
    n_head: int = 8,
    dim_head: int = 64,
    local_attn_heads: int = 0,
    local_window_size: int = 256,
    feature_redraw_interval: int = 1000,
    generalized_attention: bool = False,
    nb_features: Optional[int] = None,
    ff_mult: int = 4,
    ff_glu: bool = False,
    ff_chunks: int = 1,
    reversible: bool = False,
    remat_attention: bool = False,
    emb_dropout: float = 0.0,
    ff_dropout: float = 0.0,
    attn_dropout: float = 0.0,
    use_rezero: bool = False,
    use_scalenorm: bool = False,
    tie_embed: bool = False,
    qkv_bias: bool = False,
    attn_out_bias: bool = False,
    position_emb: str = "absolute",
    spatial_position_emb: Optional[str] = None,
    evaluation_checkpoint: str = "recent",
    # additions of the JAX package (the rank layout: one rank per card
    # under torchrun, (data, model) for a model axis, (data, seq) for
    # sp_shards, (data, pipe) for pp_stages)
    mesh_shape: Optional[Tuple[int, ...]] = None,
    compute_dtype: str = "bfloat16",
    attn_compute_dtype: str = "bfloat16",
    use_pallas_local_attn: bool = True,
    use_pallas_favor_attn: bool = True,
    use_int8_rings: bool = True,
    zero1: bool = False,
    sp_shards: int = 0,
    pp_stages: int = 0,
):
    """Build the typed config and dispatch on ``mode``.  See
    TransformerConfig for flag documentation."""
    cfg_kwargs = {
        k: v for k, v in locals().items() if k in TransformerConfig.__dataclass_fields__
    }
    # torchrun's ranks (the reference's RANK/WORLD_SIZE plumbing,
    # run_vqvae.py:831-846): the process group first, then the rank
    from synthanatomy_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from synthanatomy_tpu_torch.parallel.mesh import host_shard_info

    maybe_initialize_distributed(device)
    cfg_kwargs["rank"], cfg_kwargs["world_size"] = host_shard_info()
    config = TransformerConfig(**cfg_kwargs)

    from synthanatomy_tpu_torch.runners import transformer as runner

    if config.mode == "training":
        return runner.training(config)
    elif config.mode == "inference":
        return runner.inference(config)
    raise ValueError(
        f"Mode {config.mode!r} unknown; choices are ('training', 'inference')."
    )


if __name__ == "__main__":
    dispatch({"run": run})

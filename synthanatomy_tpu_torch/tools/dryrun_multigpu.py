"""Multi-rank dry run of the training steps: the data-parallel half of
the JAX package's ``__graft_entry__.dryrun_multichip`` (:59-160).

Over N ranks, one process each, at the JAX dry run's small sizes: the
adversarial stage-1 DP step (VQ-VAE 2 levels, 16 channels, codebook 64 ×
8; D of 8 filters and 2 levels; mse, the adaptive weight; 16³ volumes, 2
a rank) and the prior's DP step (the paper block form at 2 layers, d 32:
ReZero, learned spatial tables over 3³, 2 local heads; 2 sequences a
rank).  After each step it asserts that every rank holds the same
parameters, buffers (the EMA codebook, D's running statistics, the FAVOR
projections) and metrics.  Its tensor-parallel half waits for tensor
parallelism (ROADMAP.md §1).

    python -m synthanatomy_tpu_torch.tools.dryrun_multigpu [--nprocs 2] [--cpu]

Without torchrun's environment it starts its ranks itself
(``parallel.distributed.launch``): over gloo on the CPU with ``--cpu``,
else over NCCL, rank r on card r.  Under ``torchrun --nproc_per_node=N
-m synthanatomy_tpu_torch.tools.dryrun_multigpu`` each process is a rank.
Raises on a disagreement.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import torch

from synthanatomy_tpu_torch.parallel import distributed as D


def _state_tensors(*modules) -> List[torch.Tensor]:
    return [t for m in modules for t in m.state_dict().values()]


def _check(name: str, tensors, metrics: Dict[str, torch.Tensor], group) -> None:
    vals = [torch.as_tensor(v).reshape(1) for v in metrics.values()]
    if not D.ranks_agree(list(tensors) + vals, group):
        raise RuntimeError(f"{name}: the ranks disagree after the step")


def stage1_step(device, group, rank: int) -> Dict[str, float]:
    """One adversarial DP step of the dry run's stage 1; asserts the ranks agree."""
    from synthanatomy_tpu_torch.models.discriminator import BaselineDiscriminator
    from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE
    from synthanatomy_tpu_torch.train.vqvae_steps import (
        create_vqvae_train_state,
        make_vqvae_train_step,
    )

    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    init = torch.Generator().manual_seed(0)
    model = BaselineVQVAE(n_levels=2, downsample_parameters=((4, 2, 1, 1),) * 2,
                          upsample_parameters=((4, 2, 1, 0, 1),) * 2, n_embed=64, embed_dim=8,
                          n_channels=16, n_res_channels=16, n_res_layers=1, dtype=dtype,
                          generator=init, device=device)
    d_model = BaselineDiscriminator(ndf=8, n_layers=2, dtype=dtype, generator=init,
                                    device=device)
    state = create_vqvae_train_state(model, rank, d_model=d_model, device=device)
    step = make_vqvae_train_step(model, loss_name="mse", d_model=d_model,
                                 use_adaptive_weight=True, process_group=group)
    sched = {"lr": 3e-4, "d_lr": 5e-4, "decay": 0.5, "commitment_cost": 0.25,
             "gdl_factor": 0.0, "epoch": 10}
    x = torch.rand(2, 1, 16, 16, 16, generator=torch.Generator().manual_seed(100 + rank))
    state, metrics = step(state, x.to(device), sched)
    _check("stage 1", _state_tensors(model, d_model), metrics, group)
    return {k: float(v) for k, v in metrics.items()}


def prior_step(device, group, rank: int) -> Dict[str, float]:
    """One DP step of the dry run's prior (a redraw after it); asserts the
    ranks agree."""
    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer
    from synthanatomy_tpu_torch.train.transformer_steps import (
        create_transformer_train_state,
        make_transformer_train_step_dp,
    )

    grid = (3, 3, 3)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    model = Performer(num_tokens=33, max_seq_len=28, dim=32, depth=2, heads=4, dim_head=8,
                      local_attn_heads=2, local_window_size=8, nb_features=16, scan_chunk=8,
                      use_rezero=True, spatial_position_emb="absolute", spatial_shape=grid,
                      ordering=Ordering("raster_scan", 3, grid), feature_redraw_interval=1,
                      dtype=dtype, attn_compute_dtype=dtype,
                      generator=torch.Generator().manual_seed(1), device=device)
    state = create_transformer_train_state(model, 1, rank=rank, learning_rate=1e-4)
    tokens = torch.randint(0, 32, (2, 29), generator=torch.Generator().manual_seed(200 + rank))
    tokens = tokens.to(device)
    state, metrics = make_transformer_train_step_dp(model, group)(
        state, tokens[:, :-1], tokens[:, 1:], None, {"lr": 1e-4})
    _check("prior", _state_tensors(model), metrics, group)
    return {k: float(v) for k, v in metrics.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nprocs", type=int, default=2, help="ranks to start (without torchrun)")
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU over gloo")
    args = ap.parse_args(argv)
    if not D.launched():
        D.launch([sys.executable, "-m", "synthanatomy_tpu_torch.tools.dryrun_multigpu",
                  *(["--cpu"] if args.cpu else [])], args.nprocs, timeout=600)
        print(f"dryrun_multigpu: {args.nprocs} ranks agreed after the stage-1 and prior steps")
        return 0
    if args.cpu:
        torch.set_num_threads(1)
    D.maybe_initialize_distributed("cpu" if args.cpu else 0)
    group = D.default_group()
    rank, world = D.group_info(group)
    device = torch.device("cpu") if args.cpu else torch.device("cuda", D.local_rank())
    s1 = stage1_step(device, group, rank)
    pr = prior_step(device, group, rank)
    if rank == 0:
        print(f"[dryrun] {world} ranks ({device.type}): stage 1 loss "
              f"{s1['Loss-Reconstruction-Total']:.6f}, D loss "
              f"{s1['Loss-Discriminator-Total']:.6f}, adaptive weight "
              f"{s1['Adversarial-Weight']:.4f}; prior CE {pr['Loss']:.6f}; every rank holds "
              f"the same parameters, buffers and metrics")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-rank dry run of the training steps: the JAX package's
``__graft_entry__.dryrun_multichip`` (:59-226) through its pipeline half.

Over N ranks, one process each, at the JAX dry run's small sizes: the
adversarial stage-1 DP step (VQ-VAE 2 levels, 16 channels, codebook 64 ×
8; D of 8 filters and 2 levels; mse, the adaptive weight; 16³ volumes, 2
a rank) and the prior's DP step (the paper block form at 2 layers, d 32:
ReZero, learned spatial tables over 3³, 2 local heads; 2 sequences a
rank).  With an even rank count the prior then takes one step on the
(N/2, 2) DP×TP layout (``parallel/tensor_parallel.py``), and
``favor_attention_sequence_parallel`` and
``local_attention_sequence_parallel`` run over all N ranks (B1 × 2 heads
× 8N tokens, d 8, m 16, window 4), each against the one-device op on
the whole sequence (1e-4 of its largest value).  Last, the pipeline
half (JAX's :205-226): a prior at 33 tokens, d 32, 4 heads of 8, 2 local
of window 8, m 16, as deep as the job has ranks, pipelined one layer a
rank (``parallel/pipeline_parallel.py``): its forward on N 12-token
sequences against the one-device forward (1e-4 of the largest logit in
f32, 2e-2 in bf16), then one GPipe train step.  After each step it
asserts that every rank holds the same parameters, buffers (the EMA
codebook, D's running statistics, the FAVOR projections; the TP step's
shares and the PP step's stages gathered into the canonical model) and
metrics.

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


def _paper_prior(device):
    """The dry run's prior: the paper block form at 2 layers, d 32."""
    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer

    grid = (3, 3, 3)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    return Performer(num_tokens=33, max_seq_len=28, dim=32, depth=2, heads=4, dim_head=8,
                     local_attn_heads=2, local_window_size=8, nb_features=16, scan_chunk=8,
                     use_rezero=True, spatial_position_emb="absolute", spatial_shape=grid,
                     ordering=Ordering("raster_scan", 3, grid), feature_redraw_interval=1,
                     dtype=dtype, attn_compute_dtype=dtype,
                     generator=torch.Generator().manual_seed(1), device=device)


def prior_step(device, group, rank: int) -> Dict[str, float]:
    """One DP step of the dry run's prior (a redraw after it); asserts the
    ranks agree."""
    from synthanatomy_tpu_torch.train.transformer_steps import (
        create_transformer_train_state,
        make_transformer_train_step_dp,
    )

    model = _paper_prior(device)
    state = create_transformer_train_state(model, 1, rank=rank, learning_rate=1e-4)
    tokens = torch.randint(0, 32, (2, 29), generator=torch.Generator().manual_seed(200 + rank))
    tokens = tokens.to(device)
    state, metrics = make_transformer_train_step_dp(model, group)(
        state, tokens[:, :-1], tokens[:, 1:], None, {"lr": 1e-4})
    _check("prior", _state_tensors(model), metrics, group)
    return {k: float(v) for k, v in metrics.items()}


def tp_step(device, rank: int, world: int) -> Dict[str, float]:
    """One step of the dry run's prior on the (world/2, 2) DP×TP layout
    (each data group's own 2 sequences); asserts the ranks agree."""
    from synthanatomy_tpu_torch.parallel import tensor_parallel as TP
    from synthanatomy_tpu_torch.parallel.mesh import build_groups, rank_layout
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    layout = build_groups(rank_layout((world // 2, 2), world, rank))
    model = _paper_prior(device)
    # one dropout stream per data group, as the runner seeds it
    state = create_transformer_train_state(model, 1, rank=layout.data_index, learning_rate=1e-4)
    tp_state = TP.shard_tp_state(model, state, layout.inner_group)
    step = TP.make_tp_train_step(tp_state.model, data_group=layout.data_group)
    tokens = torch.randint(0, 32, (2, 29),
                           generator=torch.Generator().manual_seed(300 + layout.data_index))
    tokens = tokens.to(device)
    tp_state, metrics = step(tp_state, tokens[:, :-1], tokens[:, 1:], None, {"lr": 1e-4})
    TP.gather_tp_state(model, tp_state, state, layout.inner_group)
    _check("DP x TP prior", _state_tensors(model), metrics, D.default_group())
    return {k: float(v) for k, v in metrics.items()}


def sp_attention(device, rank: int, world: int) -> float:
    """The two sequence-parallel attention ops over every rank, each
    rank's shard of the output against the one-device op on the whole
    sequence; returns the largest error."""
    from synthanatomy_tpu_torch.ops.favor import (
        favor_attention,
        favor_attention_sequence_parallel,
        gaussian_orthogonal_random_matrix,
    )
    from synthanatomy_tpu_torch.ops.local_attention import (
        local_attention,
        local_attention_sequence_parallel,
    )

    group = D.default_group()
    gen = torch.Generator().manual_seed(2)
    q, k, v = (t.to(device) for t in torch.randn(3, 1, 2, 8 * world, 8, generator=gen))
    proj = gaussian_orthogonal_random_matrix(16, 8, generator=gen).to(device)
    mine = slice(8 * rank, 8 * (rank + 1))
    worst = 0.0
    for name, sp, full in (
            ("FAVOR+", lambda a, b, c: favor_attention_sequence_parallel(
                a, b, c, proj, group=group, chunk=8),
             lambda a, b, c: favor_attention(a, b, c, proj, chunk=8)),
            ("local", lambda a, b, c: local_attention_sequence_parallel(
                a, b, c, window=4, group=group),
             lambda a, b, c: local_attention(a, b, c, window=4))):
        got = sp(q[:, :, mine], k[:, :, mine], v[:, :, mine])
        want = full(q, k, v)[:, :, mine]
        err = float((got - want).abs().max())
        if err > 1e-4 * float(want.abs().max()):
            raise RuntimeError(f"sequence-parallel {name} attention on rank {rank}: max abs "
                               f"error {err} against the one-device op")
        worst = max(worst, err)
    return worst


def pp_half(device, rank: int, world: int) -> Dict[str, float]:
    """The pipeline half: the pipelined forward against the one-device
    forward on every rank, then one PP train step over all ranks, one
    layer a stage; asserts the ranks agree."""
    from synthanatomy_tpu_torch.models.performer import Performer
    from synthanatomy_tpu_torch.parallel import pipeline_parallel as PP
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    group = D.default_group()
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    model = Performer(num_tokens=33, max_seq_len=28, dim=32, depth=world, heads=4, dim_head=8,
                      local_attn_heads=2, local_window_size=8, nb_features=16, scan_chunk=8,
                      dtype=dtype, attn_compute_dtype=dtype,
                      generator=torch.Generator().manual_seed(4), device=device)
    state = create_transformer_train_state(model, 4, learning_rate=1e-4)
    packed = PP.pack_pp_state(model, state, group)
    tokens = torch.randint(0, 32, (world, 13), generator=torch.Generator().manual_seed(5))
    tokens = tokens.to(device)
    got = PP.make_pipelined_apply(model, group)(tokens[:, :-1]).float()
    with torch.no_grad():
        want = model(tokens[:, :-1]).float()
    err = float((got - want).abs().max())
    if err > (1e-4 if dtype == torch.float32 else 2e-2) * float(want.abs().max()):
        raise RuntimeError(f"pipelined forward on rank {rank}: max abs error {err} against the "
                           f"one-device forward")
    packed, metrics = PP.make_pp_train_step(packed.model, group)(
        packed, tokens[:, :-1], tokens[:, 1:], None, {"lr": 1e-4})
    PP.unpack_pp_state(model, packed, state, group)
    _check("PP prior", _state_tensors(model), metrics, group)
    return {"fwd_err": err, **{k: float(v) for k, v in metrics.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nprocs", type=int, default=2, help="ranks to start (without torchrun)")
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU over gloo")
    args = ap.parse_args(argv)
    if not D.launched():
        D.launch([sys.executable, "-m", "synthanatomy_tpu_torch.tools.dryrun_multigpu",
                  *(["--cpu"] if args.cpu else [])], args.nprocs, timeout=600)
        steps = ("stage-1, prior, DP x TP prior and PP prior" if args.nprocs % 2 == 0
                 else "stage-1, prior and PP prior")
        print(f"dryrun_multigpu: {args.nprocs} ranks agreed after the {steps} steps")
        return 0
    if args.cpu:
        torch.set_num_threads(1)
    D.maybe_initialize_distributed("cpu" if args.cpu else 0)
    group = D.default_group()
    rank, world = D.group_info(group)
    device = torch.device("cpu") if args.cpu else torch.device("cuda", D.local_rank())
    s1 = stage1_step(device, group, rank)
    pr = prior_step(device, group, rank)
    tp = tp_step(device, rank, world) if world % 2 == 0 else None
    sp_err = torch.tensor([sp_attention(device, rank, world)],
                          device=device if D.backend_is_nccl(group) else "cpu")
    torch.distributed.all_reduce(sp_err, op=torch.distributed.ReduceOp.MAX, group=group)
    sp_err = float(sp_err)
    pp = pp_half(device, rank, world)
    if rank == 0:
        tp_line = (f"DP x TP ({world // 2}, 2) prior CE {tp['Loss']:.6f}" if tp is not None
                   else "no DP x TP step (an odd rank count)")
        print(f"[dryrun] {world} ranks ({device.type}): stage 1 loss "
              f"{s1['Loss-Reconstruction-Total']:.6f}, D loss "
              f"{s1['Loss-Discriminator-Total']:.6f}, adaptive weight "
              f"{s1['Adversarial-Weight']:.4f}; prior CE {pr['Loss']:.6f}; {tp_line}; "
              f"sequence-parallel attention over {world} ranks within {sp_err:.2e} of one "
              f"device; pipeline-parallel ({world} stages) prior forward within "
              f"{pp['fwd_err']:.2e} of one device, CE {pp['Loss']:.6f}; every rank holds the "
              f"same parameters, buffers and metrics")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

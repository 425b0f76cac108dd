"""One rank of the port's data-parallel tests on the CPU (gloo).

Run by ``tests/test_torch_parallel.py`` and ``tests/test_torch_run_dp.py``
through ``synthanatomy_tpu_torch.parallel.distributed.launch``, which
starts the ranks with torchrun's environment:

    python tests/torch_dp_worker.py CASE IN.pt OUT_DIR

``IN.pt`` holds what the case needs (the port's models, with weights
made by the JAX package's init and crossed by ``interop``, batches,
flags); each rank writes
``OUT_DIR/rank{r}.pt``.  Imports ``torch`` and the port only, so the
ranks start without JAX.  Every check that needs the JAX package runs in
the test, on what the ranks wrote.
"""

import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from synthanatomy_tpu_torch.parallel import distributed as D  # noqa: E402

SCHED = {"lr": 3e-4, "d_lr": 5e-4, "decay": 0.5, "commitment_cost": 0.25, "gdl_factor": 0.0,
         "epoch": 0}


def _clone(named):
    return {k: v.detach().clone() for k, v in named}


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _stage1(spec, rank, world, adversarial):
    """One DP stage-1 step on this rank's rows of the global batch."""
    from synthanatomy_tpu_torch.train.vqvae_steps import (
        create_vqvae_train_state,
        make_vqvae_train_step,
    )

    group = D.default_group()
    g = copy.deepcopy(spec["g_model"])
    d = copy.deepcopy(spec["d_model"]) if adversarial else None
    state = create_vqvae_train_state(g, 0, d_model=d, device="cpu")
    step = make_vqvae_train_step(g, loss_name="mse", d_model=d, use_adaptive_weight=adversarial,
                                 d_grouped_stats=adversarial, process_group=group)
    x = spec["x"].chunk(world)[rank]
    state, met = step(state, x, SCHED)
    out = {"metrics": {k: float(v) for k, v in met.items()}, "g_grads": _grads(g),
           "g": _clone(g.state_dict().items())}
    if d is not None:
        out.update(d_grads=_grads(d), d=_clone(d.state_dict().items()))
    return out


def _prior(spec):
    return copy.deepcopy(spec["prior"])


def _prior_steps(spec, rank, world, outdir):
    """The DP prior step against JAX's; ZeRO-1 against replicated Adam
    over 3 steps, with a checkpoint after the first; the projection
    redraw on every rank."""
    from synthanatomy_tpu_torch.train import checkpoints as C
    from synthanatomy_tpu_torch.train.transformer_steps import (
        create_transformer_train_state,
        make_transformer_train_step_dp,
    )

    out = {}
    inputs, targets = (t.chunk(world)[rank] for t in (spec["inputs"], spec["targets"]))
    model = _prior(spec)
    state = create_transformer_train_state(model, 0, rank=rank, learning_rate=1e-3)
    state, met = make_transformer_train_step_dp(model)(state, inputs, targets, None,
                                                       {"lr": 1e-3})
    out["prior"] = {"metrics": {k: float(v) for k, v in met.items()}, "grads": _grads(model),
                    "params": _clone(model.state_dict().items())}

    runs = {}
    for zero1 in (False, True):
        model = _prior(spec)
        state = create_transformer_train_state(model, 0, rank=rank, learning_rate=1e-3,
                                               zero1=zero1, process_group=D.default_group())
        step = make_transformer_train_step_dp(model)
        after = []
        for i, (x, y) in enumerate(zip(spec["step_inputs"], spec["step_targets"])):
            state, _ = step(state, x.chunk(world)[rank], y.chunk(world)[rank], None,
                            {"lr": 1e-3})
            after.append(_clone(model.state_dict().items()))
            if zero1 and i == 0:
                C.save_checkpoint(outdir, state, 1)
        runs["zero1" if zero1 else "replicated"] = after
    out["adam"] = runs

    # a ZeRO-1 state resumed from the one-device file keeps stepping as
    # the uninterrupted one did
    model = _prior(spec)
    state = create_transformer_train_state(model, 0, rank=rank, learning_rate=1e-3, zero1=True,
                                           process_group=D.default_group())
    C.load_checkpoint(os.path.join(outdir, "checkpoint_epoch=1"), state)
    step = make_transformer_train_step_dp(model)
    for x, y in list(zip(spec["step_inputs"], spec["step_targets"]))[1:]:
        state, _ = step(state, x.chunk(world)[rank], y.chunk(world)[rank], None, {"lr": 1e-3})
    out["zero1_resumed"] = _clone(model.state_dict().items())

    # dropout on, a redraw after each step: the projections stay equal
    from synthanatomy_tpu_torch.models.performer import Performer

    model = Performer(**spec["redraw_kwargs"], generator=torch.Generator().manual_seed(5),
                      device="cpu")
    state = create_transformer_train_state(model, 0, rank=rank, learning_rate=1e-3)
    before = {n: b.clone() for n, b in model.named_buffers() if n.endswith("projection")}
    state, _ = make_transformer_train_step_dp(model)(state, inputs, targets, None, {"lr": 1e-3})
    out["redraw"] = {"before": before, "after": {n: b.clone() for n, b in model.named_buffers()
                                                 if n.endswith("projection")},
                     "dropout_seed": state.generator.initial_seed()}
    return out


def _sampler(spec, rank, world):
    """``make_dp_sampler`` and, on each rank, ``make_sampler`` on the
    rank's rows with the folded generator."""
    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer
    from synthanatomy_tpu_torch.models.sampling import make_dp_sampler, make_sampler

    model = Performer(**spec["c_kwargs"], generator=torch.Generator().manual_seed(3),
                      device="cpu").eval()
    ordering = Ordering("raster_scan", 3, spec["grid"])
    conds = spec["conds"]
    local = conds[0].shape[0] // world
    mine = [c[rank * local:(rank + 1) * local] for c in conds]
    out = {}
    with torch.no_grad():
        for do_sample in (False, True):
            kw = dict(do_sample=do_sample, with_conditionings=True)
            gen = torch.Generator().manual_seed(7)
            dp = make_dp_sampler(model, ordering, global_batch=conds[0].shape[0], **kw)(
                gen, conds)
            solo = make_sampler(model, ordering, batch=local, **kw)(
                D.fold_in(torch.Generator().manual_seed(7), rank), mine)
            out["sampled" if do_sample else "greedy"] = {"dp": dp, "solo": solo}
    return out


def _case_steps(spec, rank, world, outdir):
    group = D.default_group()
    flags = {"any_rank": [D.any_rank(rank == world - 1, group, "cpu"),
                          D.any_rank(False, group, "cpu")]}
    return {"mse": _stage1(spec, rank, world, False), "adv": _stage1(spec, rank, world, True),
            **_prior_steps(spec, rank, world, outdir), "sampler": _sampler(spec, rank, world),
            **flags}


def _case_cli(spec, rank, world, outdir):
    """Both CLIs over the ranks, each call's result kept."""
    from synthanatomy_tpu_torch.run_transformer import run as run_transformer
    from synthanatomy_tpu_torch.run_vqvae import run as run_vqvae

    out = {}
    for name, (which, flags) in spec["runs"].items():
        res = (run_vqvae if which == "vqvae" else run_transformer)(**flags)
        keep = {k: res[k] for k in ("history", "written") if k in res}
        if "state" in res:
            model = res["state"].model
            keep["params"] = _clone(model.state_dict().items())
        out[name] = keep
    return out


def main(case, spec_path, outdir):
    torch.set_num_threads(1)
    assert D.maybe_initialize_distributed("cpu"), "expected several ranks"
    rank, world = dist.get_rank(), dist.get_world_size()
    spec = torch.load(spec_path, weights_only=False)
    out = {"steps": _case_steps, "cli": _case_cli}[case](spec, rank, world, outdir)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])

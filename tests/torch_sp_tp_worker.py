"""One rank of the port's sequence- and tensor-parallel tests on the CPU
(gloo).

Run by ``tests/test_torch_sp.py``, ``tests/test_torch_tp.py`` and
``tests/test_torch_run_sp_tp.py`` through
``synthanatomy_tpu_torch.parallel.distributed.launch`` (4 ranks, or 2
for the CLI's (1, 2) runs):

    python tests/torch_sp_tp_worker.py CASE IN.pt OUT_DIR

``IN.pt`` holds what the case needs (the port's models, with weights
made by the JAX package's init and crossed by ``interop``, the inputs,
cotangents and flags); each rank writes ``OUT_DIR/rank{r}.pt``.  Imports
``torch`` and the port only; every check against JAX runs in the test.
"""

import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from synthanatomy_tpu_torch.parallel import distributed as D  # noqa: E402
from synthanatomy_tpu_torch.parallel import tensor_parallel as TP  # noqa: E402
from synthanatomy_tpu_torch.parallel.mesh import build_groups, rank_layout  # noqa: E402

LR = 1e-3


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _sp_ops(spec, rank, world):
    """Both sequence-parallel attention ops over 2 shards (the seq groups
    of a (2, 2) layout: ranks {0, 1} and {2, 3}) and over all 4: this
    rank's output and q, k, v gradients for the cotangent ``g``."""
    from synthanatomy_tpu_torch.ops.favor import favor_attention_sequence_parallel
    from synthanatomy_tpu_torch.ops.local_attention import local_attention_sequence_parallel

    pair = build_groups(rank_layout(None, world, rank, sp_shards=2))
    out = {}
    for n_sh, group, idx in ((2, pair.inner_group, pair.inner_index),
                             (world, D.default_group(), rank)):
        for name, fn in (
                ("favor", lambda q, k, v, g: favor_attention_sequence_parallel(
                    q, k, v, spec["proj"], group=g, chunk=8)),
                ("favor_noproj", lambda q, k, v, g: favor_attention_sequence_parallel(
                    q, k, v, None, group=g, chunk=8)),
                ("local", lambda q, k, v, g: local_attention_sequence_parallel(
                    q, k, v, window=spec["window"], group=g))):
            ls = spec["q"].shape[2] // n_sh
            cols = slice(idx * ls, (idx + 1) * ls)
            q, k, v = (spec[x][:, :, cols].clone().requires_grad_() for x in "qkv")
            o = fn(q, k, v, group)
            (o * spec["g"][:, :, cols]).sum().backward()
            out[(name, n_sh)] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    return out


def _sp_steps(spec, rank, world):
    """Each SP step case: the summed gradients and loss after one step
    (rank 0 keeps them) and whether every rank holds the same gradients."""
    from synthanatomy_tpu_torch.parallel.sequence_parallel import make_sp_train_step
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    out = {}
    for case in spec["steps"]:
        layout = build_groups(rank_layout(None, world, rank, sp_shards=case["sp_shards"]))
        model = copy.deepcopy(case["model"])
        state = create_transformer_train_state(model, 0, learning_rate=LR)
        step = make_sp_train_step(model, layout.inner_group, case["seq_len"],
                                  data_group=layout.data_group)
        rows = [t.chunk(layout.shape[0])[layout.data_index]
                for t in (case["inputs"], case["targets"])]
        conds = case["conds"]
        if conds is not None:
            conds = [c.chunk(layout.shape[0])[layout.data_index] for c in conds]
        _, met = step(state, rows[0], rows[1], conds, {"lr": LR})
        grads = _grads(model)
        out[case["name"]] = {"loss": float(met["Loss"]), "grads": grads,
                             "agree": D.ranks_agree(list(grads.values()), D.default_group())}
    return out


def _case_sp(spec, rank, world, outdir):
    return {"ops": _sp_ops(spec, rank, world), "steps": _sp_steps(spec, rank, world)}


def _case_tp(spec, rank, world, outdir):
    """Each TP case on the (2, 2) layout: without a data group each model
    group of 2 trains the whole batch (two (1, 2) runs), with one the
    DP×TP step.  Rank 0 keeps the loss, the gradients gathered over its
    model group and unpacked, and the canonical parameters after the
    step; every rank's canonical parameters are compared over the job."""
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    layout = build_groups(rank_layout((2, 2), world, rank))
    out = {}
    for case in spec["tp"]:
        model = copy.deepcopy(case["model"])
        state = create_transformer_train_state(model, 0, learning_rate=LR)
        tp_state = TP.shard_tp_state(model, state, layout.inner_group)
        data_group = layout.data_group if case["dp"] else None
        step = TP.make_tp_train_step(model, layout.inner_group, data_group=data_group,
                                     use_pallas_local=True, use_pallas_favor=True)
        x, y, conds = case["inputs"], case["targets"], case["conds"]
        if case["dp"]:
            x, y = (t.chunk(2)[layout.data_index] for t in (x, y))
            conds = conds and [c.chunk(2)[layout.data_index] for c in conds]
        tp_state, met = step(tp_state, x, y, conds, {"lr": LR})
        shard = tp_state.model
        grads = TP.gather_tp_grads(model, tp_state, layout.inner_group)
        TP.gather_tp_state(model, tp_state, state, layout.inner_group)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        out[case["name"]] = {
            "loss": float(met["Loss"]), "grads": grads, "params": params,
            "agree": D.ranks_agree(list(params.values()), D.default_group()),
            "heads": (shard.blocks[0].attn.heads, shard.blocks[0].attn.local_heads)}
    return out


def _case_cli(spec, rank, world, outdir):
    """The CLI runs of ``spec["runs"]`` over the ranks, each call's
    history and canonical parameters kept (or the ``NotImplementedError``
    a run raised)."""
    from synthanatomy_tpu_torch.run_transformer import run

    out = {}
    for name, flags in spec["runs"].items():
        try:
            res = run(**flags)
        except NotImplementedError as exc:  # a configuration the step refuses
            out[name] = {"error": f"{type(exc).__name__}: {exc}"}
            continue
        keep = {k: res[k] for k in ("history", "written") if k in res}
        if res.get("state") is not None:
            keep["params"] = {k: v.detach().clone()
                              for k, v in res["state"].model.state_dict().items()}
        out[name] = keep
    return out


def main(case, spec_path, outdir):
    torch.set_num_threads(1)
    assert D.maybe_initialize_distributed("cpu"), "expected several ranks"
    rank, world = dist.get_rank(), dist.get_world_size()
    spec = torch.load(spec_path, weights_only=False)
    out = {"sp": _case_sp, "tp": _case_tp, "cli": _case_cli}[case](spec, rank, world, outdir)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])

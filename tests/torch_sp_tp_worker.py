"""One rank of the port's sequence-, tensor- and pipeline-parallel tests
on the CPU (gloo).

Run by ``tests/test_torch_sp.py``, ``tests/test_torch_tp.py``,
``tests/test_torch_pp.py``, ``tests/test_torch_run_sp_tp.py`` and
``tests/test_torch_run_pp.py`` through
``synthanatomy_tpu_torch.parallel.distributed.launch`` (4 ranks, or 2
for the CLI's two-rank runs):

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


def _holding(state):
    """What a TP share's or PP stage's train state holds: the element
    count of each parameter, buffer and gradient and of each Adam entry
    (by its parameter's name), and the names of the parameters Adam
    steps."""
    model = state.model
    names = {id(p): n for n, p in model.named_parameters()}
    return {"params": {n: p.numel() for n, p in model.named_parameters()},
            "buffers": {n: b.numel() for n, b in model.named_buffers()},
            "grads": {n: p.grad.numel() for n, p in model.named_parameters()
                      if p.grad is not None},
            "adam": {names[id(p)]: {k: v.numel() for k, v in st.items()}
                     for p, st in state.optimizer.state.items()},
            "stepped": [names[id(p)] for p in state.optimizer.param_groups[0]["params"]]}


def _same_state(a, b, opt_a, opt_b):
    """Whether two canonical states are bit-identical: the models' state
    dicts and the optimizers' state dicts, index for index."""
    sa, sb = a.state_dict(), b.state_dict()
    oa, ob = opt_a.state_dict()["state"], opt_b.state_dict()["state"]
    return (set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
            and set(oa) == set(ob) and all(set(oa[i]) == set(ob[i]) and all(
                torch.equal(oa[i][k], ob[i][k]) for k in oa[i]) for i in oa))


def _root_gather(gather, model, layout, lr, **kw):
    """The canonical state gathered onto the inner group's rank 0 alone
    (``gather(model, state, root_only=True)``) into a fresh copy of
    ``model``'s initial state: the copy and its state on that rank, and
    whether every other rank got None."""
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    fresh = copy.deepcopy(model)
    fresh_state = create_transformer_train_state(fresh, 0, learning_rate=lr, **kw)
    root = layout.inner_index == 0
    got = gather(fresh if root else None, fresh_state if root else None)
    return (fresh, fresh_state) if root else got is None


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
    DP×TP step, whose dropout draws from a stream per data group (seed 0
    + data index, as the runner seeds it).  Rank 0 keeps the loss, the
    gradients gathered over its model group and unpacked, and the
    canonical parameters after the step; every rank's canonical
    parameters are compared over the job, and each rank reports which
    parts of its share split and its heads."""
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    layout = build_groups(rank_layout((2, 2), world, rank))
    out = {}
    for case in spec["tp"]:
        model = copy.deepcopy(case["model"])
        stream = layout.data_index if case["dp"] else 0
        state = create_transformer_train_state(model, 0, rank=stream, learning_rate=LR)
        tp_state = TP.shard_tp_state(model, state, layout.inner_group)
        data_group = layout.data_group if case["dp"] else None
        step = TP.make_tp_train_step(tp_state.model, data_group=data_group,
                                     use_pallas_local=True, use_pallas_favor=True)
        x, y, conds = case["inputs"], case["targets"], case["conds"]
        if case["dp"]:
            x, y = (t.chunk(2)[layout.data_index] for t in (x, y))
            conds = conds and [c.chunk(2)[layout.data_index] for c in conds]
        tp_state, met = step(tp_state, x, y, conds, {"lr": LR})
        shard = tp_state.model
        grads = TP.gather_tp_grads(tp_state, layout.inner_group)
        TP.gather_tp_state(model, tp_state, state, layout.inner_group)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        out[case["name"]] = {
            "loss": float(met["Loss"]), "grads": grads, "params": params,
            "agree": D.ranks_agree(list(params.values()), D.default_group()),
            "split": (shard.blocks[0].attn.tp_group is not None,
                      shard.blocks[0].ff.tp_group is not None),
            "heads": (shard.blocks[0].attn.heads - shard.blocks[0].attn.local_heads,
                      shard.blocks[0].attn.local_heads)}
    out["holdings"] = _tp_holdings(spec["holdings"], rank, world)
    return out


def _tp_holdings(spec, rank, world):
    """Each TP layout of ``spec["layouts"]`` (name, mesh shape, whether the
    step averages over the data group: without, each model group of a
    (2, 2) mesh is a (1, 2) run): the rank's share of ``spec["model"]``
    after one step (what it holds; whether each parameter is its slice of
    the packed canonical one), its gradients and state gathered onto the
    model
    group's rank 0 alone against the every-rank gather (bit for bit on
    that rank, nothing on the others)."""
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    out = {}
    for name, shape, dp in spec["layouts"]:
        layout = build_groups(rank_layout(shape, world, rank))
        group, m, me = layout.inner_group, layout.shape[1], layout.inner_index
        model = copy.deepcopy(spec["model"])
        state = create_transformer_train_state(model, 0, rank=layout.data_index,
                                               learning_rate=LR)
        tp_state = TP.shard_tp_state(model, state, group)
        specs = TP.tp_param_specs(model, m, [n for n, _ in model.named_parameters()])
        packed = TP.pack_tp_params(model, {n: p.detach() for n, p in model.named_parameters()},
                                   m)
        mine = {n: torch.equal(p, packed[n] if specs[n] is None
                               else packed[n].chunk(m, specs[n])[me])
                for n, p in tp_state.model.named_parameters()}
        step = TP.make_tp_train_step(tp_state.model, data_group=layout.data_group if dp else None)
        rows = [t.chunk(layout.shape[0] if dp else 1)[layout.data_index if dp else 0]
                for t in (spec["inputs"], spec["targets"])]
        tp_state, _ = step(tp_state, rows[0], rows[1], None, {"lr": LR})
        every_grads = TP.gather_tp_grads(tp_state, group)
        root_grads = TP.gather_tp_grads(tp_state, group, root_only=True)
        TP.gather_tp_state(model, tp_state, state, group)
        root = _root_gather(lambda mdl, st: TP.gather_tp_state(mdl, tp_state, st, group,
                                                               root_only=True),
                            spec["model"], layout, LR, rank=layout.data_index)
        if me == 0:
            fresh, fresh_state = root
            root = (_same_state(fresh, model, fresh_state.optimizer, state.optimizer)
                    and set(root_grads) == set(every_grads)
                    and all(torch.equal(root_grads[n], t) for n, t in every_grads.items()))
        else:
            root = root and root_grads is None
        out[name] = {"holding": _holding(tp_state), "mine": mine, "root_gather": root,
                     "inner": (me, m)}
    return out


def _case_pp(spec, rank, world, outdir):
    """The pipeline cases over 4 ranks: the (1, 4) pipe of all ranks and
    the (2, 2) PP×DP layout.  Each rank keeps every pipelined forward's
    logits; each step's loss, gradients (the stages' gathered into the
    canonical names) and canonical state after Adam's step, whether every
    rank holds that state; the pack/unpack round trip; the errors of bad
    shapes."""
    from synthanatomy_tpu_torch.parallel import pipeline_parallel as PP
    from synthanatomy_tpu_torch.train.transformer_steps import (
        create_transformer_train_state,
        make_transformer_train_step,
    )

    layouts = {p: build_groups(rank_layout(None, world, rank, pp_stages=p)) for p in (2, 4)}
    out = {"fwd": {}, "steps": {}, "errors": {}}
    for case in spec["fwd"]:
        lay = layouts[case["stages"]]
        apply = PP.make_pipelined_apply(copy.deepcopy(case["model"]), lay.inner_group,
                                        n_microbatches=case["n_mb"],
                                        data_group=lay.data_group if case["dp"] else None)
        out["fwd"][case["name"]] = apply(case["inputs"], case["conds"])
    for case in spec["steps"]:
        lay = layouts[case["stages"]]
        model = copy.deepcopy(case["model"])
        state = create_transformer_train_state(model, 0, learning_rate=LR)
        packed = PP.pack_pp_state(model, state, lay.inner_group)
        data_group = lay.data_group if case["dp"] else None
        step = PP.make_pp_train_step(packed.model, lay.inner_group, data_group=data_group,
                                     n_microbatches=case["n_mb"])
        x, y, conds = case["inputs"], case["targets"], case["conds"]
        if case["dp"]:
            x, y = (t.chunk(lay.shape[0])[lay.data_index] for t in (x, y))
            conds = conds and [c.chunk(lay.shape[0])[lay.data_index] for c in conds]
        packed, met = step(packed, x, y, conds, {"lr": LR})
        grads = PP.unpack_pp_tree(model, {n: p.grad for n, p in packed.model.named_parameters()},
                                  lay.inner_group)
        PP.unpack_pp_state(model, packed, state, lay.inner_group)
        sd = {n: t.detach().clone() for n, t in model.state_dict().items()}
        out["steps"][case["name"]] = {
            "loss": float(met["Loss"]), "grads": grads, "state": sd,
            "adam": sum("exp_avg" in v for v in state.optimizer.state.values()),
            "agree": D.ranks_agree(list(sd.values()), D.default_group())}

    # the round trip: a canonical state after a one-device step, packed, is
    # unpacked into a state that still holds the initial weights and no
    # Adam state, so whatever this rank's stage lacks comes from the others
    rt = spec["round_trip"]
    for p, lay in layouts.items():
        model = copy.deepcopy(rt["model"])
        state = create_transformer_train_state(model, 0, learning_rate=LR)
        make_transformer_train_step(model)(state, rt["inputs"], rt["targets"], None, {"lr": LR})
        want = copy.deepcopy((model.state_dict(), state.optimizer.state_dict()["state"]))
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        tree_ok = all(torch.equal(t, sd[k]) for k, t in PP.unpack_pp_tree(
            model, PP.pack_pp_tree(model, sd, lay.inner_group), lay.inner_group).items())
        packed = PP.pack_pp_state(model, state, lay.inner_group)
        fresh = copy.deepcopy(rt["model"])
        fresh_state = create_transformer_train_state(fresh, 0, learning_rate=LR)
        PP.unpack_pp_state(fresh, packed, fresh_state, lay.inner_group)
        got = fresh_state.optimizer.state_dict()["state"]
        stepped = {id(q) for q in packed.optimizer.param_groups[0]["params"]}
        out[f"round_trip_{p}"] = {
            "tree": tree_ok,
            "params": all(torch.equal(fresh.state_dict()[k], t) for k, t in want[0].items()),
            "adam": set(got) == set(want[1]) and all(
                torch.equal(got[i][k], st[k]) for i, st in want[1].items()
                for k in ("step", "exp_avg", "exp_avg_sq")),
            "stage": sum(any(id(q) in stepped for q in blk.parameters())
                         for blk in packed.model.blocks),
            "adam_params": len(packed.optimizer.state)}
    out["holdings"] = _pp_holdings(spec["holdings"], layouts)

    bad = spec["bad"]
    try:
        PP.make_pipelined_apply(bad["depth5"], layouts[4].inner_group)
    except ValueError as exc:
        out["errors"]["stages"] = str(exc)
    apply = PP.make_pipelined_apply(copy.deepcopy(rt["model"]), layouts[4].inner_group,
                                    n_microbatches=3)
    try:
        apply(rt["inputs"])
    except ValueError as exc:
        out["errors"]["microbatches"] = str(exc)
    return out


def _pp_holdings(spec, layouts):
    """Each PP layout of ``spec["layouts"]`` (name, stages, whether the
    step averages over the data group: without, each pipe of the (2, 2)
    layout is a (1, 2) run): the rank's stage of ``spec["model"]`` after
    one step (what it holds; whether each parameter and buffer equals the
    canonical one of its name), its state gathered onto the pipe group's
    rank 0 alone against the every-rank gather (bit for bit on that rank,
    nothing on the others)."""
    from synthanatomy_tpu_torch.parallel import pipeline_parallel as PP
    from synthanatomy_tpu_torch.train.transformer_steps import create_transformer_train_state

    out = {}
    for name, stages, dp in spec["layouts"]:
        lay = layouts[stages]
        group = lay.inner_group
        model = copy.deepcopy(spec["model"])
        state = create_transformer_train_state(model, 0, learning_rate=LR)
        packed = PP.pack_pp_state(model, state, group)
        canon = {**model.state_dict(), **dict(model.named_buffers())}
        mine = {n: torch.equal(t, canon[n]) for n, t in
                {**packed.model.state_dict(), **dict(packed.model.named_buffers())}.items()}
        step = PP.make_pp_train_step(packed.model, group,
                                     data_group=lay.data_group if dp else None)
        rows = [t.chunk(lay.shape[0] if dp else 1)[lay.data_index if dp else 0]
                for t in (spec["inputs"], spec["targets"])]
        packed, _ = step(packed, rows[0], rows[1], None, {"lr": LR})
        PP.unpack_pp_state(model, packed, state, group)
        root = _root_gather(lambda mdl, st: PP.unpack_pp_state(mdl, packed, st, group,
                                                               root_only=True),
                            spec["model"], lay, LR)
        if lay.inner_index == 0:
            fresh, fresh_state = root
            root = _same_state(fresh, model, fresh_state.optimizer, state.optimizer)
        out[name] = {"holding": _holding(packed), "mine": mine, "root_gather": root,
                     "inner": (lay.inner_index, stages)}
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
        except (NotImplementedError, ValueError) as exc:  # a configuration the run refuses
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
    out = {"sp": _case_sp, "tp": _case_tp, "pp": _case_pp,
           "cli": _case_cli}[case](spec, rank, world, outdir)
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])

"""The port's pipeline parallelism on the CPU: four gloo ranks
(``tests/torch_sp_tp_worker.py pp``, started once for the module by
``parallel.distributed.launch`` while JAX computes its side in this
process) against the JAX package, at JAX's ``_pp_setup``
(``tests/test_parallel.py:272``: depth 4, d32, 2 heads of 8, 1 local of
window 6, m 8, B8 × 20, f32).

- ``make_pipelined_apply`` over a (1, 4) pipe, M 4, against JAX's on a
  4-device pipe mesh (``:290``), and over the (2, 2) PP×DP layout, M 2, at
  depth 2 against JAX's on a (pipe, data) mesh (``:870``): within 1e-5 of
  the largest logit, on every rank.
- ``make_pp_train_step`` over the (1, 4) pipe, M 4: the gradients,
  gathered into the canonical names, within 1e-4 of each tensor's largest
  value of JAX's ``make_pp_train_step`` (captured; ``:305``), plain and
  the paper form (ReZero at gains 0.7/0.5, 'absolute' spatial tables,
  'bos_replacement'; ``:1115``); the loss within 1e-5 relative and the
  parameters after one Adam step within 1e-4 in norm of JAX's step with
  Adam (``:335``).
- The step against the one-device port step on the whole batch, at the
  same bounds: those cases, 'prepending' conditioning (the last stage
  strips the conditioning positions; the stages carry them), reversible
  blocks and PP×DP over 2×2 ranks
  (``:389``, 2 microbatches of each data group's 4 rows), the last with a
  projection redraw after the step (every stage's projections equal one
  process's, bit for bit); every rank ends with the same canonical state.
- ``pack_pp_*`` / ``unpack_pp_*`` are exact inverses (parameters, FAVOR
  projections, Adam's moments and step counts), with 1 and 2 layers a
  stage.
- On each rank of the (1, 2), (2, 2) and (1, 4) layouts the packed state
  holds its stage alone: the non-block parameters and buffers and its
  layers' (names and element counts from the canonical shapes, each equal
  to the canonical tensor of its name), and after a step their gradients
  and Adam's entries, no other layer's; its state gathered onto the pipe
  group's rank 0 alone is bit for bit the every-rank gather, and the
  other ranks get nothing.
- Bad shapes raise ``ValueError`` and dropout ``NotImplementedError``
  (``:423``, ``:855``); rotary positions raise ``NotImplementedError("PP
  step: …")``: JAX's pipelined forward of a rotary prior differs from its
  one-device forward (its stage gets no rotary table), while a reversible
  one's equals it.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu.models.ordering import Ordering as JOrdering  # noqa: E402
from synthanatomy_tpu.models.performer import Performer as JPerformer  # noqa: E402
from synthanatomy_tpu.parallel import pipeline_parallel as JPP  # noqa: E402
from synthanatomy_tpu.train.transformer_steps import (  # noqa: E402
    TransformerTrainState as JTrainState,
)
from synthanatomy_tpu_torch.interop import performer_from_jax  # noqa: E402
from synthanatomy_tpu_torch.models.ordering import Ordering  # noqa: E402
from synthanatomy_tpu_torch.models.performer import Performer  # noqa: E402
from synthanatomy_tpu_torch.parallel import pipeline_parallel as PP  # noqa: E402
from synthanatomy_tpu_torch.parallel.distributed import launch  # noqa: E402
from synthanatomy_tpu_torch.train.transformer_steps import (  # noqa: E402
    create_transformer_train_state as create_state,
    make_transformer_train_step,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sp_tp_worker.py")
WORLD = 4
LR = 1e-3
NET = dict(num_tokens=17, dim=32, heads=2, dim_head=8, local_attn_heads=1, local_window_size=6,
           nb_features=8, scan_chunk=8)
GRID = (2, 2, 5)
# name: (Performer options beyond NET, conds, stages, microbatches, PP×DP)
STEPS = {
    "plain": (dict(depth=4, max_seq_len=24), None, 4, 4, False),
    "paper_bos": (dict(depth=4, max_seq_len=21, use_rezero=True, spatial_position_emb="absolute",
                       spatial_shape=GRID, conditioning_num_tokens=(5,),
                       conditioning_type="bos_replacement"), [[1, 3, 0, 4, 2, 2, 1, 0]], 4, 4,
                  False),
    "prepending": (dict(depth=4, max_seq_len=24, conditioning_num_tokens=(5,),
                        conditioning_type="prepending"), [[4, 0, 2, 1, 3, 3, 0, 1]], 4, 4, False),
    "reversible": (dict(depth=4, max_seq_len=24, reversible=True), None, 4, 4, False),
    "pp2x2": (dict(depth=4, max_seq_len=24, use_rezero=True, feature_redraw_interval=1), None,
              2, 2, True),
}
# the holdings' layouts over the 4 ranks: name: (stages, PP×DP); without a data
# group each pipe of the (2, 2) layout is a (1, 2) run
LAYOUTS = {"1x2": (2, False), "2x2": (2, True), "1x4": (4, False)}
FWD = {  # name: (depth, stages, microbatches, PP×DP)
    "pp4": (4, 4, 4, False),
    "pp2x2": (2, 2, 2, True),
}


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), (name, err, np.abs(want).max())


def _close_norm(got, want, tol, name=""):
    """‖got − want‖ ≤ tol · ‖want‖: parameters after Adam's first step,
    which moves an element by ~lr whatever its gradient's size."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * max(np.linalg.norm(want), 1e-6), (name, err, np.linalg.norm(want))


class _Capture(NamedTuple):
    hyperparams: dict
    g: Any
    adam: Any


def _capture_adam_tx():
    """``optax.inject_hyperparams(optax.adam)`` that also keeps the last
    gradients in its state, so one JAX step hands back both its gradients
    and its Adam update."""
    import optax

    scale = optax.scale_by_adam()

    def init(p):
        return _Capture({"learning_rate": jnp.asarray(LR, jnp.float32)},
                        jax.tree.map(jnp.zeros_like, p), scale.init(p))

    def update(g, s, p=None):
        u, adam = scale.update(g, s.adam, p)
        u = jax.tree.map(lambda x: -s.hyperparams["learning_rate"] * x, u)
        return u, _Capture(s.hyperparams, g, adam)

    return optax.GradientTransformation(init, update)


def _jax_model(opts):
    opts = {k: v for k, v in opts.items() if k != "feature_redraw_interval"}
    if "spatial_shape" in opts:
        opts["ordering"] = JOrdering("raster_scan", 3, opts["spatial_shape"])
    return JPerformer(**NET, **opts, dtype=jnp.float32)


def _port_kwargs(opts):
    kw = {k: v for k, v in dict(NET, **opts).items() if k not in ("num_tokens", "dim", "depth")}
    if "spatial_shape" in kw:
        kw["ordering"] = Ordering("raster_scan", 3, kw["spatial_shape"])
    return dict(kw, dtype=torch.float32, attn_compute_dtype=torch.float32, device="cpu")


def _with_gains(params):
    """ReZero gains 0.7/0.5: gradients reach every block weight."""
    return {k: (dict(v, g_attn=np.full((1,), 0.7, np.float32),
                     g_ff=np.full((1,), 0.5, np.float32)) if k.startswith("block_") else v)
            for k, v in params.items()}


def _setup(opts, conds, variables=None):
    """JAX's model, state (with the gains) and the B8 × 20 batch of
    ``_pp_setup``; the weights from JAX's init unless ``variables`` gives
    them.  Adam's state from optax."""
    import optax

    jm = _jax_model(opts)
    if variables is None:
        jc = None if conds is None else [jnp.asarray(c, jnp.int32)[:1] for c in conds]
        variables = jax.jit(jm.init)({"params": jax.random.key(4), "favor": jax.random.key(5)},
                                     jnp.zeros((1, 16), jnp.int32), jc)
    params = jax.device_get(variables["params"])
    if opts.get("use_rezero"):
        params = _with_gains(params)
    favor = jax.device_get(variables["favor"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, favor=favor,
                        opt_state=optax.inject_hyperparams(optax.adam)(
                            learning_rate=LR).init(params), rng=jax.random.key(3))
    x = np.random.default_rng(0).integers(0, 16, (8, 20)).astype(np.int32)
    y = np.random.default_rng(1).integers(0, 16, (8, 20)).astype(np.int32)
    return dict(opts=opts, jm=jm, state=state, params=params, favor=favor, x=x, y=y,
                conds=conds)


def _derived(variables, depth=4, rezero=False, positions=True):
    """``variables`` of the plain depth-4 prior cut to ``depth`` layers, with
    ReZero blocks (the norms dropped; ``_with_gains`` sets the gains) or
    without the learned positional table (a rotary prior)."""
    params = {}
    for k, v in variables["params"].items():
        if k.startswith("block_"):
            if int(k.split("_")[1]) >= depth:
                continue
            if rezero:
                v = {kk: vv for kk, vv in v.items() if not kk.startswith("norm_")}
        elif k == "abs_pos_emb" and not positions:
            continue
        params[k] = v
    favor = {k: v for k, v in variables["favor"].items()
             if not k.startswith("block_") or int(k.split("_")[1]) < depth}
    return {"params": params, "favor": favor}


@pytest.fixture(scope="module")
def cases():
    """Three JAX inits (one takes seconds on the CPU): the plain prior, the
    paper form and the 'prepending' prior; the other cases' weights are
    the plain prior's."""
    out = {name: _setup(STEPS[name][0], STEPS[name][1])
           for name in ("plain", "paper_bos", "prepending")}
    plain = {"params": out["plain"]["params"], "favor": out["plain"]["favor"]}
    out["reversible"] = dict(out["plain"], opts=STEPS["reversible"][0])
    out["pp2x2"] = _setup(STEPS["pp2x2"][0], None, _derived(plain, rezero=True))
    out["fwd_pp4"] = out["plain"]
    out["fwd_pp2x2"] = _setup(dict(depth=FWD["pp2x2"][0], max_seq_len=24), None,
                              _derived(plain, depth=FWD["pp2x2"][0]))
    return out


def _port(case, tree=None):
    return performer_from_jax(case["params"] if tree is None else tree, case["favor"],
                              case["opts"]["depth"], **_port_kwargs(case["opts"]))


def _inputs(case):
    conds = None if case["conds"] is None else [torch.tensor(c) for c in case["conds"]]
    return torch.from_numpy(case["x"]).long(), torch.from_numpy(case["y"]).long(), conds


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """The four ranks' results, as a future: the ranks run while this
    process computes JAX's and the one-device side (ask for this fixture
    first)."""
    spec = {"fwd": [], "steps": []}
    for name, (_, stages, n_mb, dp) in FWD.items():
        case = cases[f"fwd_{name}"]
        spec["fwd"].append(dict(name=name, model=_port(case), inputs=_inputs(case)[0],
                                conds=None, stages=stages, n_mb=n_mb, dp=dp))
    for name, (_, _, stages, n_mb, dp) in STEPS.items():
        x, y, conds = _inputs(cases[name])
        spec["steps"].append(dict(name=name, model=_port(cases[name]), inputs=x, targets=y,
                                  conds=conds, stages=stages, n_mb=n_mb, dp=dp))
    x, y, _ = _inputs(cases["plain"])
    spec["round_trip"] = dict(model=_port(cases["plain"]), inputs=x, targets=y)
    spec["holdings"] = dict(model=_port(cases["plain"]), inputs=x, targets=y,
                            layouts=[(name, stages, dp) for name, (stages, dp) in LAYOUTS.items()])
    spec["bad"] = {"depth5": Performer(17, 24, 32, 5, heads=2, dim_head=8, nb_features=8,
                                       dtype=torch.float32, device="cpu")}
    out = tmp_path_factory.mktemp("pp")
    torch.save(spec, out / "spec.pt")

    def run():
        launch([sys.executable, WORKER, "pp", str(out / "spec.pt"), str(out)], WORLD,
               timeout=300)
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


@pytest.fixture(scope="module")
def jax_pp(cases):
    """JAX's side: the pipelined forwards; the PP step's loss and
    gradients (captured, unpacked) for the JAX-held cases; the parameters
    after its Adam step; its pipelined forward of a rotary and of a
    reversible prior beside the one-device forward."""
    out = {}
    pipe4 = Mesh(np.asarray(jax.devices()[:4]), ("pipe",))
    pipe_data = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("pipe", "data"))
    for name, (_, _, n_mb, dp) in FWD.items():
        case = cases[f"fwd_{name}"]
        variables = {"params": case["params"], "favor": case["favor"]}
        sp, sf = JPP.stack_block_params(case["jm"], variables)
        apply = JPP.make_pipelined_apply(case["jm"], pipe_data if dp else pipe4,
                                         n_microbatches=n_mb, data_axis="data" if dp else None)
        out[f"fwd_{name}"] = np.asarray(jax.jit(apply)(variables, sp, sf, jnp.asarray(case["x"])))
    tx = _capture_adam_tx()
    for name in ("plain", "paper_bos"):
        case, jm = cases[name], cases[name]["jm"]
        jc = None if case["conds"] is None else [jnp.asarray(c, jnp.int32)
                                                 for c in case["conds"]]
        packed = JPP.pack_pp_state(jm, case["state"])
        new, met = jax.jit(JPP.make_pp_train_step(jm, tx, pipe4, n_microbatches=4))(
            packed.replace(opt_state=tx.init(packed.params)), jnp.asarray(case["x"]),
            jnp.asarray(case["y"]), {"lr": LR}, jc)
        out[name] = dict(loss=float(met["Loss"]),
                         grads=JPP.unpack_pp_tree(jm, jax.device_get(new.opt_state.g)),
                         params=JPP.unpack_pp_tree(jm, jax.device_get(new.params)))
    x = jnp.asarray(cases["plain"]["x"])
    plain = {"params": cases["plain"]["params"], "favor": cases["plain"]["favor"]}
    for name in ("rotary_position_emb", "reversible"):
        jm = _jax_model(dict(depth=4, max_seq_len=24, **{name: True}))
        variables = _derived(plain, positions=name != "rotary_position_emb")
        sp, sf = JPP.stack_block_params(jm, variables)
        apply = JPP.make_pipelined_apply(jm, pipe4, n_microbatches=4)
        out[name] = (np.asarray(jax.jit(apply)(variables, sp, sf, x)),
                     np.asarray(jax.jit(jm.apply)(variables, x)))
    return out


@pytest.fixture(scope="module")
def one_device(cases):
    """The one-device port step on each case's whole batch: loss,
    gradients and the state after Adam's step (and the redraw)."""
    out = {}
    for name in STEPS:
        model = _port(cases[name])
        state = create_state(model, 0, learning_rate=LR)
        _, met = make_transformer_train_step(model)(state, *_inputs(cases[name]), {"lr": LR})
        out[name] = {"loss": float(met["Loss"]),
                     "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                     "state": {n: t.detach().clone() for n, t in model.state_dict().items()}}
    return out


@pytest.mark.parametrize("name", list(FWD))
def test_pipelined_forward_matches_jax(ranks, cases, jax_pp, name):
    want = jax_pp[f"fwd_{name}"]
    for r, out in enumerate(ranks.result()):
        got = out["fwd"][name]
        assert got.shape == want.shape
        _close(got.numpy(), want, 1e-5, f"rank {r}")


@pytest.mark.parametrize("name", ["plain", "paper_bos"])
def test_pp_step_gradients_match_jax(ranks, cases, jax_pp, name):
    ref = jax_pp[name]
    want = dict(_port(cases[name], ref["grads"]).named_parameters())
    for r in (0, WORLD - 1):  # the first and the last stage
        got = ranks.result()[r]["steps"][name]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert set(got["grads"]) == set(want)
        for n, p in want.items():
            _close(got["grads"][n].numpy(), p.detach().numpy(), 1e-4, n)


def test_pp_adam_step_matches_jax(ranks, cases, jax_pp):
    ref = jax_pp["plain"]
    want = dict(_port(cases["plain"], ref["params"]).named_parameters())
    got = ranks.result()[0]["steps"]["plain"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for n, p in want.items():
        _close_norm(got["state"][n].numpy(), p.detach().numpy(), 1e-4, n)


@pytest.mark.parametrize("name", list(STEPS))
def test_pp_step_matches_the_one_device_step(ranks, one_device, name):
    """Loss, gradients and the canonical parameters after Adam's step
    against one process on the whole batch; the FAVOR projections (the
    redraw of "pp2x2" included) bit for bit; every rank holds the same
    canonical state with Adam's state for every parameter."""
    want = one_device[name]
    outs = ranks.result()
    got = outs[0]["steps"][name]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for n, t in want["grads"].items():
        _close(got["grads"][n].numpy(), t.numpy(), 1e-4, f"grad {n}")
    assert set(got["state"]) == set(want["state"])
    for n, t in want["state"].items():
        if n.endswith("projection"):
            assert torch.equal(got["state"][n], t), n
        else:
            _close_norm(got["state"][n].numpy(), t.numpy(), 1e-4, n)
    assert got["adam"] == len(want["grads"])
    assert all(out["steps"][name]["agree"] for out in outs)
    assert all(out["steps"][name]["loss"] == got["loss"] for out in outs)


def test_redraw_draws_every_layer_in_step(ranks, cases):
    """The "pp2x2" step redraws (interval 1): every rank drew all four
    layers' matrices in layer order (the one-device redraw), so each
    stage's projections are new and equal one process's (checked above),
    and the layers' projections differ."""
    got = ranks.result()[0]["steps"]["pp2x2"]["state"]
    before = _port(cases["pp2x2"]).state_dict()
    projs = [got[f"blocks.{i}.attn.projection"] for i in range(4)]
    assert all(not torch.equal(p, before[f"blocks.{i}.attn.projection"])
               for i, p in enumerate(projs))
    assert all(not torch.equal(projs[i], projs[j]) for i in range(4) for j in range(i))


@pytest.mark.parametrize("stages", [2, 4])
def test_pack_and_unpack_are_exact_inverses(ranks, cases, stages):
    model = _port(cases["plain"])
    per_block = len(list(model.blocks[0].parameters()))
    non_block = len(list(model.parameters())) - 4 * per_block
    for out in ranks.result():
        rt = out[f"round_trip_{stages}"]
        assert rt["tree"] and rt["params"] and rt["adam"], rt
        assert rt["stage"] == 4 // stages
        # every stage parameter carries its Adam state: its own blocks' and
        # the non-block ones (embeddings, final norm, head)
        assert rt["adam_params"] == 4 // stages * per_block + non_block, rt


def test_bad_shapes_raise(ranks):
    """JAX's messages (``pipeline_parallel.py:120-123, 181-184``)."""
    for out in ranks.result():
        assert out["errors"] == {"stages": "depth 5 must divide into 4 stages",
                                 "microbatches": "batch 8 must divide into 3 microbatches"}


@pytest.mark.parametrize("rate", ["emb_dropout", "ff_dropout", "attn_dropout"])
def test_dropout_raises_as_jax(rate):
    model = Performer(17, 24, 32, 2, heads=2, dim_head=8, nb_features=8, dtype=torch.float32,
                      device="cpu", **{rate: 0.1})
    jm = JPerformer(num_tokens=17, max_seq_len=24, dim=32, depth=2, heads=2, dim_head=8,
                    nb_features=8, **{rate: 0.1})
    with pytest.raises(NotImplementedError) as jax_exc:
        JPP.make_pp_train_step(jm, None, Mesh(np.asarray(jax.devices()[:2]), ("pipe",)))
    with pytest.raises(NotImplementedError) as port_exc:
        PP.make_pp_train_step(model, None)
    assert str(port_exc.value) == str(jax_exc.value)


def test_jax_pp_differs_from_its_one_device_forward_with_rotary(jax_pp):
    """JAX's stage applies its blocks without the rotary table
    (``pipeline_parallel.py:136``), so its pipelined forward of a rotary
    prior is another function than its one-device forward; a reversible
    prior's (remat, the same function) agrees."""
    pp, one = jax_pp["rotary_position_emb"]
    assert np.abs(pp - one).max() > 0.1 * np.abs(one).max()
    pp, one = jax_pp["reversible"]
    _close(pp, one, 1e-5)


def test_rotary_raises_in_the_port():
    model = Performer(17, 24, 32, 2, heads=2, dim_head=8, nb_features=8, dtype=torch.float32,
                      device="cpu", rotary_position_emb=True)
    with pytest.raises(NotImplementedError, match="PP step: rotary"):
        PP.make_pp_train_step(model, None)


def test_one_stage_is_the_one_device_step(cases, one_device):
    """Without a pipe group the schedule is one stage: M microbatches on
    one process, the same step as the one-device one up to rounding."""
    case = cases["paper_bos"]
    model = _port(case)
    state = create_state(model, 0, learning_rate=LR)
    packed = PP.pack_pp_state(model, state, None)
    assert len(packed.model.blocks) == 4
    packed, met = PP.make_pp_train_step(packed.model, None, n_microbatches=2)(
        packed, *_inputs(case), {"lr": LR})
    PP.unpack_pp_state(model, packed, state, None)
    want = one_device["paper_bos"]
    np.testing.assert_allclose(float(met["Loss"]), want["loss"], rtol=1e-5)
    for n, t in want["grads"].items():
        _close(dict(packed.model.named_parameters())[n].grad.numpy(), t.numpy(), 1e-4, n)
    assert state.step == 1 and len(state.optimizer.state) == len(want["grads"])


def test_pp_step_needs_the_conditioning_values(cases):
    model = _port(cases["paper_bos"])
    packed = PP.pack_pp_state(model, create_state(model, 0), None)
    x = torch.zeros(2, 20, dtype=torch.long)
    with pytest.raises(ValueError, match="conditioning"):
        PP.make_pp_train_step(packed.model, None)(packed, x, x, None, {"lr": LR})
    with pytest.raises(ValueError, match="made for another model"):
        PP.make_pp_train_step(model, None)(packed, x, x, None, {"lr": LR})


def _stage_shapes(model, stages, index):
    """What stage ``index`` of ``stages`` holds, from ``model``'s canonical
    shapes: each kept parameter's and buffer's element count by name (the
    non-block ones and its layers')."""
    per = model.depth // stages

    def kept(name):
        head, _, rest = name.partition(".")
        return head != "blocks" or index * per <= int(rest.split(".")[0]) < (index + 1) * per

    return ({n: p.numel() for n, p in model.named_parameters() if kept(n)},
            {n: b.numel() for n, b in model.named_buffers() if kept(n)})


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stage_holds_only_its_layers(ranks, cases, layout):
    """Each rank's packed state after a step holds the non-block tensors
    and its stage's layers, each equal to the canonical tensor of its name,
    with their gradients and Adam's entries (step, both moments), and
    nothing of another stage; its Adam steps exactly those parameters."""
    model = _port(cases["plain"])
    whole = sum(p.numel() for p in model.parameters())
    for r, out in enumerate(ranks.result()):
        got = out["holdings"][layout]
        index, stages = got["inner"]
        params, buffers = _stage_shapes(model, stages, index)
        held = got["holding"]
        assert held["params"] == params and held["grads"] == params, (r, held["params"])
        assert held["buffers"] == buffers, (r, held["buffers"])
        assert held["adam"] == {n: {"step": 1, "exp_avg": c, "exp_avg_sq": c}
                                for n, c in params.items()}, r
        assert held["stepped"] == list(params)
        assert set(got["mine"]) == set(params) | set(buffers) and all(got["mine"].values()), r
        assert sum(params.values()) < whole


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rank0_gather_is_the_every_rank_gather(ranks, layout):
    """``unpack_pp_state(..., root_only=True)`` gives the pipe group's rank
    0 the canonical state that every rank gets without it (parameters,
    projections and Adam's state dict, bit for bit) and the others None."""
    for r, out in enumerate(ranks.result()):
        assert out["holdings"][layout]["root_gather"] is True, (r, layout)

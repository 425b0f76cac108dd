"""The port's tensor parallelism on the CPU: four gloo ranks in a (2, 2)
layout (``tests/torch_sp_tp_worker.py tp``, started once for the module
by ``parallel.distributed.launch``) against the JAX package.

- ``make_tp_train_step`` at (1, 2) (each model group {0, 1} and {2, 3}
  trains the whole batch, rows 5 and 6 on, their plain versions on the
  CPU) against JAX's two TP routes on a 2-device model axis: its manual
  ``make_tp_train_step`` for the forms that step takes (plain, and the
  paper form with 'bos_replacement' conditioning: ReZero at gains
  0.7/0.5, learned spatial tables; ``tests/test_parallel.py:904, 971``),
  and for the forms it refuses the GSPMD step JAX's runner takes
  (``shard_transformer_state`` on a (1, 2) ("data", "model") mesh, then
  the jitted one-device ``make_transformer_train_step``;
  ``synthanatomy_tpu/runners/transformer.py:488-495``): ScaleNorm, GLU,
  rotary, the out-bias and q/k/v biases; fixed positions, 'fixed' spatial
  tables, 'prepending' conditioning and reversible blocks; axial
  positions; heads that do not divide (3 heads, 1 local: the attention
  stays whole on every rank, the FF splits).  The loss within 1e-5
  relative; the gradients, gathered over the model group and unpacked
  (JAX's captured, unpacked from the manual step's packing), within 1e-4
  of each tensor's largest value; the canonical parameters after one
  Adam step within 1e-4 in norm of the one-device port step's.
- Dropout (emb, attn and FF at 0.1, GLU, attention remat): against the
  one-device port step with the same generator state only (random
  streams never match JAX); over the (2, 2) layout each data group draws
  from its own stream (seeded by the data index, as the runner seeds it)
  and the step equals the one-device steps of the two halves, each from
  its stream, averaged.
- The DP×TP step over 2×2 ranks (``:74``) against the one-device port
  step on the whole batch, at the same bounds.
- Each rank holds gh/P FAVOR and lh/P local heads where the attention
  splits, and every rank ends with the same canonical parameters.
- ``pack_tp_params`` equals JAX's packing; ``pack_tp_state`` and
  ``unpack_tp_state`` (parameters and Adam's moments) are exact inverses
  (``:1059``), under GLU too, whose packing gives each share its values'
  gates.
- ``tp_step_compatible`` refuses what JAX's refuses, with its reasons; the
  port's ``make_tp_train_step`` trains each of those forms.
- On each rank of the (1, 2), (2, 2) and (1, 4) layouts (a prior of 8
  heads, 4 local, whose attention splits over 4) the TP state holds its
  share alone: each split parameter at 1/P of its canonical element
  count, the rest whole (names and counts from the canonical shapes and
  the Megatron rules), each parameter its rank's slice of the packed
  canonical one, and after a step their gradients and
  Adam's entries; its state and gradients gathered onto the model group's
  rank 0 alone are bit for bit the every-rank gather, and the other ranks
  get nothing.

The new forms' weights are drawn with numpy into the tree of JAX's
abstract init (``abstract=True``: no QR factorisations), so no JAX init
runs for them.
"""

import copy
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu.models.ordering import Ordering as JOrdering  # noqa: E402
from synthanatomy_tpu.models.performer import Performer as JPerformer  # noqa: E402
from synthanatomy_tpu.parallel import tensor_parallel as JTP  # noqa: E402
from synthanatomy_tpu.parallel.mesh import shard_batch  # noqa: E402
from synthanatomy_tpu.parallel.sharding_rules import shard_transformer_state  # noqa: E402
from synthanatomy_tpu.train.transformer_steps import (  # noqa: E402
    TransformerTrainState,
    create_transformer_train_state,
)
from synthanatomy_tpu.train.transformer_steps import (  # noqa: E402
    make_transformer_train_step as jax_train_step,
)
from synthanatomy_tpu_torch.losses.transformer import ce_loss  # noqa: E402
from synthanatomy_tpu_torch.interop import (  # noqa: E402
    performer_from_jax,
    performer_state_dict_from_jax,
)
from synthanatomy_tpu_torch.models.ordering import Ordering  # noqa: E402
from synthanatomy_tpu_torch.models.performer import Performer  # noqa: E402
from synthanatomy_tpu_torch.parallel import tensor_parallel as TP  # noqa: E402
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
NET = dict(num_tokens=17, dim=32, depth=2, heads=4, dim_head=8, local_attn_heads=2,
           local_window_size=8, nb_features=8, scan_chunk=8)
GRID = (2, 3, 4)
DROPOUT = dict(max_seq_len=24, emb_dropout=0.1, attn_dropout=0.1, ff_dropout=0.1, ff_glu=True,
               remat_attention=True)
# name: (Performer options beyond NET, batch, conds, DP×TP, JAX's route: "manual" (its
# shard_map TP step), "gspmd" (its runner's GSPMD step), None (compared with the port's
# one-device step only))
CASES = {
    "plain": (dict(max_seq_len=24), 2, None, False, "manual"),
    "paper_bos": (dict(max_seq_len=25, use_rezero=True, spatial_position_emb="absolute",
                       spatial_shape=GRID, conditioning_num_tokens=(5,),
                       conditioning_type="bos_replacement"), 2, [[1, 3]], False, "manual"),
    "dp_x_tp": (dict(max_seq_len=24, use_rezero=True), 4, None, True, None),
    "norms_glu_rotary": (dict(max_seq_len=24, use_scalenorm=True, ff_glu=True,
                              rotary_position_emb=True, attn_out_bias=True, qkv_bias=True),
                         2, None, False, "gspmd"),
    "fixed_prepend_reversible": (dict(max_seq_len=25, fixed_position_emb=True,
                                      spatial_position_emb="fixed", spatial_shape=GRID,
                                      conditioning_num_tokens=(5,),
                                      conditioning_type="prepending", reversible=True),
                                 2, [[1, 3]], False, "gspmd"),
    "axial": (dict(max_seq_len=24, axial_position_emb=True), 2, None, False, "gspmd"),
    "uneven_heads": (dict(max_seq_len=24, heads=3, local_attn_heads=1), 2, None, False,
                     "gspmd"),
    "dropout": (DROPOUT, 2, None, False, None),
    "dropout_dp_x_tp": (DROPOUT, 4, None, True, None),
}
# the cases whose weights come from JAX's own init (the rest: _random_tree)
JAX_INIT = ("plain", "paper_bos", "dp_x_tp")
# the holdings' layouts over the 4 ranks: name: (mesh shape, DP×TP); without a
# data group each model group of the (2, 2) mesh is a (1, 2) run
LAYOUTS = {"1x2": ((2, 2), False), "2x2": ((2, 2), True), "1x4": ((1, 4), False)}
HOLDINGS = dict(NET, heads=8, dim_head=4, local_attn_heads=4)
# Megatron's split parameters by part (the rest of the model is replicated)
SPLIT = {"attn": re.compile(r"^blocks\.\d+\.attn\.(to_[qkv]\.(weight|bias)|to_out\.weight)$"),
         "ff": re.compile(r"^blocks\.\d+\.ff\.(w1\.(weight|bias)|w2\.weight)$")}


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), (name, err, np.abs(want).max())


def _close_norm(got, want, tol, name=""):
    """‖got − want‖ ≤ tol · ‖want‖: parameters after Adam's first step,
    which moves an element by ~lr whatever its gradient's size, so a
    near-zero gradient's rounding can flip one element's step."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * max(np.linalg.norm(want), 1e-6), (name, err, np.linalg.norm(want))


class _Capture(NamedTuple):
    hyperparams: dict
    g: Any


def _capture_tx():
    """An optax transformation that changes nothing and keeps the last
    gradients in its state, so the JAX step hands them back."""
    import optax

    def init(p):
        return _Capture({"learning_rate": jnp.zeros(())}, jax.tree.map(jnp.zeros_like, p))

    def update(g, s, p=None):
        return jax.tree.map(jnp.zeros_like, g), _Capture(s.hyperparams, g)

    return optax.GradientTransformation(init, update)


def _jax_model(opts):
    # remat leaves the tree as it is, and JAX's init cannot trace it with
    # dropout (flax's remat takes ``deterministic`` as a traced value)
    opts = {k: v for k, v in dict(NET, **opts).items() if k != "remat_attention"}
    if "spatial_shape" in opts:
        opts["ordering"] = JOrdering("raster_scan", 3, opts["spatial_shape"])
    return JPerformer(**opts, dtype=jnp.float32)


def _random_tree(skeleton, dim, seed):
    """Values for the leaves of JAX's abstract init (``skeleton``: params
    or favor), drawn with numpy by the leaf's name: kernels at
    lecun-normal scale, biases and norm offsets ~0.1, norm scales ~1,
    ScaleNorm's gain ~√dim, embeddings and FAVOR projections unit
    normal."""
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = r.normal(size=s.shape)
        if name == "kernel":
            z = z / np.sqrt(s.shape[0])
        elif name == "bias":
            z = 0.1 * z
        elif name == "scale":
            z = 1.0 + 0.1 * z
        elif name == "g":  # ScaleNorm
            z = np.sqrt(dim) * (1.0 + 0.1 * z)
        return jnp.asarray(z, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, skeleton)


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


@pytest.fixture(scope="module")
def cases():
    """JAX's weights and batch of each case."""
    out = {}
    for i, (name, (opts, batch, conds, dp, route)) in enumerate(CASES.items()):
        jm = _jax_model(opts)
        jc = None if conds is None else [jnp.asarray(c, jnp.int32)[:1] for c in conds]
        state, _ = create_transformer_train_state(jm, jax.random.key(0), opts["max_seq_len"],
                                                  learning_rate=LR, conditionings=jc,
                                                  abstract=name not in JAX_INIT)
        if name not in JAX_INIT:
            state = TransformerTrainState(
                step=jnp.zeros((), jnp.int32), params=_random_tree(state.params, NET["dim"], i),
                favor=_random_tree(state.favor, NET["dim"], 100 + i), opt_state=None,
                rng=jax.random.key(1))
        params = jax.device_get(state.params)
        if opts.get("use_rezero"):
            params = _with_gains(params)
        n_tok = opts["max_seq_len"] - 1
        r = np.random.default_rng(17)
        x, y = (r.integers(0, 16, (batch, n_tok)).astype(np.int32) for _ in range(2))
        out[name] = dict(opts=opts, jm=jm, state=state, params=params,
                         favor=jax.device_get(state.favor), x=x, y=y, conds=conds, dp=dp,
                         route=route)
    return out


@pytest.fixture(scope="module")
def jax_tp(cases):
    """JAX's TP steps over a 2-device model axis for the (1, 2) cases with a
    JAX route: loss and gradients (captured; the manual step's unpacked),
    and the manual step's packing of the weights."""
    cap = _capture_tx()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
    gspmd = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    out = {}
    for name, case in cases.items():
        if case["route"] is None:
            continue
        jm = case["jm"]
        jc = None if case["conds"] is None else [jnp.asarray(c, jnp.int32)
                                                 for c in case["conds"]]
        if case["route"] == "gspmd":
            # the runner's route: the Megatron placement, the one-device step
            state = case["state"].replace(params=case["params"],
                                          opt_state=cap.init(case["params"]))
            state = shard_transformer_state(gspmd, cap, state)
            with jax.set_mesh(gspmd):
                new, met = jax.jit(jax_train_step(jm, cap))(
                    state, shard_batch(gspmd, case["x"]), shard_batch(gspmd, case["y"]), jc,
                    {"lr": LR})
            out[name] = dict(loss=float(met["Loss"]), grads=jax.device_get(new.opt_state.g))
            continue
        packed = JTP.pack_tp_params(jm, case["params"], 2)
        shard = jax.tree.map(lambda s: NamedSharding(mesh, s), JTP.tp_param_specs(packed))
        packed = jax.device_put(packed, shard)
        tp_state = case["state"].replace(params=packed, opt_state=cap.init(packed))
        step = JTP.make_tp_train_step(jm, cap, mesh)
        new, met = jax.jit(step)(tp_state, jnp.asarray(case["x"]), jnp.asarray(case["y"]),
                                 {"lr": LR}, jc)
        out[name] = dict(loss=float(met["Loss"]),
                         packed=JTP.pack_tp_params(jm, case["params"], 2),
                         grads=JTP.unpack_tp_params(jm, jax.device_get(new.opt_state.g), 2))
    return out


def _port(case, tree=None):
    return performer_from_jax(case["params"] if tree is None else tree, case["favor"],
                              NET["depth"], **_port_kwargs(case["opts"]))


def _inputs(case):
    conds = None if case["conds"] is None else [torch.tensor(c) for c in case["conds"]]
    return torch.from_numpy(case["x"]).long(), torch.from_numpy(case["y"]).long(), conds


def _halves_step(case):
    """The DP×TP dropout case's reference: the one-device port forward and
    backward on each data group's half of the batch, with that group's
    generator (seed 0 + data index), the loss and gradients averaged,
    then Adam's step on the average."""
    x, y, conds = _inputs(case)
    losses, grads = [], []
    for d in range(2):
        model = _port(case)
        create_state(model, 0, rank=d)
        model.train()
        loss, _ = ce_loss(model(x.chunk(2)[d], conds and [c.chunk(2)[d] for c in conds]),
                          y.chunk(2)[d])
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad for n, p in model.named_parameters()})
    model = _port(case)
    state = create_state(model, 0, learning_rate=LR)
    for n, p in model.named_parameters():
        p.grad = (grads[0][n] + grads[1][n]) / 2
    state.optimizer.step()
    return {"loss": sum(losses) / 2,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def one_device(cases):
    """The one-device port step on each case's whole batch (the DP×TP
    dropout case: :func:`_halves_step`): loss, gradients and the
    parameters after Adam's step."""
    out = {}
    for name, case in cases.items():
        if case["dp"] and case["opts"].get("ff_dropout"):
            out[name] = _halves_step(case)
            continue
        model = _port(case)
        state = create_state(model, 0, learning_rate=LR)
        _, met = make_transformer_train_step(model)(state, *_inputs(case), {"lr": LR})
        out[name] = {"loss": float(met["Loss"]),
                     "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                     "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """The four ranks' results, as a future: the ranks run while this
    process computes JAX's and the one-device side (ask for this fixture
    first)."""
    spec = {"tp": []}
    for name, case in cases.items():
        x, y, conds = _inputs(case)
        spec["tp"].append(dict(name=name, model=_port(case), inputs=x, targets=y, conds=conds,
                               dp=case["dp"]))
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 16, (4, 23))).long()
    spec["holdings"] = dict(model=_holdings_model(), inputs=x, targets=x.roll(1, 1),
                            layouts=[(n, shape, dp) for n, (shape, dp) in LAYOUTS.items()])
    out = tmp_path_factory.mktemp("tp")
    torch.save(spec, out / "spec.pt")

    def run():
        launch([sys.executable, WORKER, "tp", str(out / "spec.pt"), str(out)], WORLD,
               timeout=300)
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


def _holdings_model():
    return Performer(17, 24, **{k: v for k, v in HOLDINGS.items() if k != "num_tokens"},
                     dtype=torch.float32, generator=torch.Generator().manual_seed(3),
                     device="cpu")


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[4]])
def test_tp_step_matches_jax(ranks, cases, jax_tp, name):
    case, ref = cases[name], jax_tp[name]
    want = dict(_port(case, ref["grads"]).named_parameters())
    outs = ranks.result()
    for r in (0, 2):  # the first rank of each model group
        got = outs[r][name]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert set(got["grads"]) == set(want)
        for n, p in want.items():
            _close(got["grads"][n].numpy(), p.detach().numpy(), 1e-4, n)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_the_one_device_step(ranks, one_device, name):
    """(1, 2) and the DP×TP (2, 2) step: loss, gradients and the canonical
    parameters after Adam's step against one process on the whole batch;
    every rank holds the same canonical parameters, and gh/P + lh/P heads
    where the attention splits (all of them where it does not)."""
    want = one_device[name]
    outs = ranks.result()
    got = outs[0][name]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for key, close in (("grads", _close), ("params", _close_norm)):
        assert set(got[key]) == set(want[key])
        for n, t in want[key].items():
            close(got[key][n].numpy(), t.numpy(), 1e-4, f"{key} {n}")
    assert all(out[name]["agree"] for out in outs)
    # (attention split, FF split), the FAVOR and local heads a rank: 2 + 2
    # split in two, or 2 + 1 whole
    split, heads = ((False, True), (2, 1)) if name == "uneven_heads" else ((True, True), (1, 1))
    assert all(out[name]["split"] == split and out[name]["heads"] == heads for out in outs)


def test_pack_matches_jax_and_state_round_trip_is_exact(cases, jax_tp):
    case = cases["paper_bos"]
    model = _port(case)
    want = performer_state_dict_from_jax(jax_tp["paper_bos"]["packed"], case["favor"],
                                         NET["depth"])
    packed = TP.pack_tp_params(model, model.state_dict(), 2)
    assert set(packed) == set(want)
    for n, t in want.items():
        assert torch.equal(packed[n], t), n
    back = TP.unpack_tp_params(model, packed, 2)
    assert all(torch.equal(back[n], t) for n, t in model.state_dict().items())

    # the state: parameters and Adam's moments after a step, out and back
    x, y, conds = _inputs(case)
    state = create_state(model, 0, learning_rate=LR)
    make_transformer_train_step(model)(state, x, y, conds, {"lr": LR})
    before = copy.deepcopy((model.state_dict(), state.optimizer.state_dict()))
    TP.pack_tp_state(model, state, 2)
    q = model.blocks[0].attn.to_q.weight
    assert not torch.equal(q, before[0]["blocks.0.attn.to_q.weight"])
    TP.unpack_tp_state(model, state, 2)
    assert all(torch.equal(model.state_dict()[n], t) for n, t in before[0].items())
    after = state.optimizer.state_dict()["state"]
    for i, st in before[1]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(after[i][key], st[key]), (i, key)


def test_glu_packing_pairs_values_with_gates_and_round_trips(cases):
    """Under GLU each rank's contiguous share of w1's rows and bias is its
    values' block then their gates' block, [a_p; g_p]; packing the state
    (parameters and Adam's moments after a step) and unpacking it is
    exact."""
    case = cases["norms_glu_rotary"]
    model = _port(case)
    inner = NET["dim"] * 4
    packed = TP.pack_tp_params(model, model.state_dict(), 2)
    for key in ("blocks.0.ff.w1.weight", "blocks.1.ff.w1.bias"):
        t = model.state_dict()[key]
        a, g = t[:inner], t[inner:]
        for p, share in enumerate(packed[key].chunk(2)):
            assert torch.equal(share, torch.cat([a.chunk(2)[p], g.chunk(2)[p]])), (key, p)
    x, y, conds = _inputs(case)
    state = create_state(model, 0, learning_rate=LR)
    make_transformer_train_step(model)(state, x, y, conds, {"lr": LR})
    before = copy.deepcopy((model.state_dict(), state.optimizer.state_dict()))
    TP.pack_tp_state(model, state, 2)
    assert not torch.equal(model.blocks[0].ff.w1.weight, before[0]["blocks.0.ff.w1.weight"])
    TP.unpack_tp_state(model, state, 2)
    assert all(torch.equal(model.state_dict()[n], t) for n, t in before[0].items())
    after = state.optimizer.state_dict()["state"]
    for i, st in before[1]["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(after[i][key], st[key]), (i, key)


REFUSED = {
    "heads": dict(heads=3, local_attn_heads=1),
    "scalenorm": dict(use_scalenorm=True),
    "rotary": dict(rotary_position_emb=True),
    "fixed": dict(fixed_position_emb=True),
    "axial": dict(axial_position_emb=True),
    "fixed_spatial": dict(spatial_position_emb="fixed", spatial_shape=GRID),
    "prepending": dict(conditioning_num_tokens=(5,), conditioning_type="prepending"),
    "attn_out_bias": dict(attn_out_bias=True),
    "dropout": dict(ff_dropout=0.1),
    "ff_glu": dict(ff_glu=True),
    "reversible": dict(reversible=True),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_tp_step_compatible_refuses_as_jax(name):
    """JAX's manual step refuses each form, and the port's function says
    so; the port's TP step builds for each and (over one rank, no group
    here) trains one step to a finite loss."""
    opts = dict(NET, max_seq_len=24, **REFUSED[name])
    jopts, popts = dict(opts), {k: v for k, v in opts.items()
                                if k not in ("num_tokens", "max_seq_len", "dim", "depth")}
    if "spatial_shape" in opts:
        jopts["ordering"] = JOrdering("raster_scan", 3, GRID)
        popts["ordering"] = Ordering("raster_scan", 3, GRID)
    want = JTP.tp_step_compatible(JPerformer(**jopts), 2)
    model = Performer(17, 24, 32, 2, **popts, dtype=torch.float32, device="cpu")
    assert TP.tp_step_compatible(model, 2) == want and not want[0]
    state = TP.shard_tp_state(model, create_state(model, 0), None)
    step = TP.make_tp_train_step(state.model)
    x = torch.zeros(2, 23, dtype=torch.long)
    conds = [torch.tensor([1, 3])] if "conditioning_num_tokens" in opts else None
    _, met = step(state, x, x, conds, {"lr": LR})
    assert np.isfinite(float(met["Loss"]))


def test_tp_step_needs_the_conditioning_values():
    model = Performer(17, 24, 32, 1, heads=2, dim_head=8, nb_features=8, scan_chunk=8,
                      conditioning_num_tokens=(5,), conditioning_type="bos_replacement",
                      dtype=torch.float32, device="cpu")
    state = TP.shard_tp_state(model, create_state(model, 0), None)
    x = torch.zeros(2, 24, dtype=torch.long)
    with pytest.raises(ValueError, match="conditioning"):
        TP.make_tp_train_step(state.model)(state, x, x, None, {"lr": LR})
    with pytest.raises(ValueError, match="made for another model"):
        TP.make_tp_train_step(model)(state, x, x, None, {"lr": LR})


def test_tp_step_sets_the_kernel_flags_once():
    """The step is built, and the share's kernel flags set, when it is
    made; a call changes neither."""
    model = _holdings_model()
    state = TP.shard_tp_state(model, create_state(model, 0), None)
    step = TP.make_tp_train_step(state.model, use_pallas_local=True, use_pallas_favor=True)
    flags = [(b.attn.use_pallas_local, b.attn.use_pallas_favor) for b in state.model.blocks]
    assert flags == [(True, True)] * HOLDINGS["depth"]
    assert not any(b.attn.use_pallas_local for b in model.blocks)
    for blk in state.model.blocks:
        blk.attn.use_pallas_favor = False  # a call leaves the share's flags alone
    x = torch.zeros(2, 23, dtype=torch.long)
    _, met = step(state, x, x, None, {"lr": LR})
    assert np.isfinite(float(met["Loss"]))
    assert not any(b.attn.use_pallas_favor for b in state.model.blocks)


def _share_shapes(model, m):
    """What a rank's share of ``model`` over ``m`` model ranks holds, from
    the canonical shapes and Megatron's rules: each parameter's element
    count by name (a split one's 1/m), each buffer's whole."""
    gh, lh = model.heads - model.local_attn_heads, model.local_attn_heads
    split = {"attn": gh % m == 0 and lh % m == 0, "ff": model.dim * model.ff_mult % m == 0}
    params = {n: p.numel() // m if any(split[k] and rx.match(n) for k, rx in SPLIT.items())
              else p.numel() for n, p in model.named_parameters()}
    return params, {n: b.numel() for n, b in model.named_buffers()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_share_holds_only_its_slices(ranks, layout):
    """Each rank's TP state after a step holds its share alone: every
    parameter at its count from shapes (split or whole) and its rank's
    slice of the packed canonical tensor, the buffers whole,
    with their gradients and Adam's entries; its Adam steps exactly those
    parameters."""
    model = _holdings_model()
    whole = sum(p.numel() for p in model.parameters())
    for r, out in enumerate(ranks.result()):
        got = out["holdings"][layout]
        params, buffers = _share_shapes(model, got["inner"][1])
        held = got["holding"]
        assert held["params"] == params and held["grads"] == params, (r, held["params"])
        assert held["buffers"] == buffers, r
        assert held["adam"] == {n: {"step": 1, "exp_avg": c, "exp_avg_sq": c}
                                for n, c in params.items()}, r
        assert held["stepped"] == list(params)
        assert set(got["mine"]) == set(params) and all(got["mine"].values()), r
        assert sum(params.values()) < whole
    if layout == "1x4":  # the attention splits over 4 ranks too
        assert params["blocks.0.attn.to_q.weight"] == (
            HOLDINGS["dim"] * HOLDINGS["heads"] * HOLDINGS["dim_head"] // 4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_rank0_gather_is_the_every_rank_gather(ranks, layout):
    """``gather_tp_state`` and ``gather_tp_grads`` with ``root_only`` give
    the model group's rank 0 what every rank gets without it (parameters,
    projections, Adam's state dict, gradients; bit for bit) and the others
    None."""
    for r, out in enumerate(ranks.result()):
        assert out["holdings"][layout]["root_gather"] is True, (r, layout)

"""The port's sequence parallelism on the CPU: four gloo ranks
(``tests/torch_sp_tp_worker.py sp``, started once for the module by
``parallel.distributed.launch``) against the JAX package's
``shard_map`` forms on its forced 8-device CPU mesh.

- ``favor_attention_sequence_parallel`` (with and without a projection)
  and ``local_attention_sequence_parallel``, over 2 shards (the seq
  groups {0, 1} and {2, 3} of a (2, 2) layout) and over 4: each rank's
  output and q, k, v gradients for a seeded cotangent against JAX's
  (``tests/test_parallel.py:131,164,239``), 1e-4 of the largest value.
- ``make_sp_train_step`` against JAX's ``make_sp_train_step`` (dim 32,
  depth 2, 4 heads, 2 local, window 8, f32): plain, with padding, at the
  canonical ``seq_len`` for the absolute and the fixed positional table,
  the paper form (ReZero at gains 0.7/0.5, learned spatial tables), the
  full-``max_seq_len`` spatial rows, DP×SP over 2×2 ranks, and both
  conditioning types (``tests/test_parallel.py:486,536,570,622,677,730,
  776``): the loss within 1e-5 relative, every gradient (summed over the
  ranks, JAX's captured before the update) within 1e-4 of its largest
  value, and every rank holding the same gradients.
- The raises (``:831,852``), in this process (a step of one shard).
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
from jax.sharding import PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from synthanatomy_tpu.models.ordering import Ordering as JOrdering  # noqa: E402
from synthanatomy_tpu.models.performer import Performer as JPerformer  # noqa: E402
from synthanatomy_tpu.ops import favor as jfavor  # noqa: E402
from synthanatomy_tpu.ops import local_attention as jlocal  # noqa: E402
from synthanatomy_tpu.parallel import sequence_parallel as JSP  # noqa: E402
from synthanatomy_tpu.train.transformer_steps import create_transformer_train_state  # noqa: E402
from synthanatomy_tpu_torch.interop import performer_from_jax  # noqa: E402
from synthanatomy_tpu_torch.models.ordering import Ordering  # noqa: E402
from synthanatomy_tpu_torch.models.performer import Performer  # noqa: E402
from synthanatomy_tpu_torch.parallel.distributed import launch  # noqa: E402
from synthanatomy_tpu_torch.parallel.sequence_parallel import make_sp_train_step  # noqa: E402
from synthanatomy_tpu_torch.train.transformer_steps import (  # noqa: E402
    create_transformer_train_state as create_state,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_sp_tp_worker.py")
WORLD = 4
NET = dict(num_tokens=17, dim=32, depth=2, heads=4, dim_head=8, local_attn_heads=2,
           local_window_size=8, nb_features=8, scan_chunk=8)
GRID = (2, 4, 4)
OPS = dict(b=2, h=2, n=64, d=8, m=16, w=8)


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), (name, err, np.abs(want).max())


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


# name: (Performer options beyond NET, token count, batch, sp_shards, conds)
CASES = {
    "plain": (dict(max_seq_len=32), 32, 2, 4, None),
    "padding": (dict(max_seq_len=40), 27, 2, 4, None),
    "canonical_absolute": (dict(max_seq_len=28), 27, 2, 4, None),
    "canonical_fixed": (dict(max_seq_len=28, fixed_position_emb=True), 27, 2, 4, None),
    "paper": (dict(max_seq_len=33, use_rezero=True, spatial_position_emb="absolute",
                   spatial_shape=GRID), 32, 2, 4, None),
    "full_max_seq_len": (dict(max_seq_len=33, use_rezero=True, spatial_position_emb="absolute",
                              spatial_shape=GRID), 33, 2, 4, None),
    "dp_x_sp": (dict(max_seq_len=16), 16, 4, 2, None),
    "bos_replacement": (dict(max_seq_len=40, conditioning_num_tokens=(5, 3),
                             conditioning_type="bos_replacement"), 32, 2, 4, [[1, 4], [2, 0]]),
    "prepending": (dict(max_seq_len=40, conditioning_num_tokens=(5, 3),
                        conditioning_type="prepending"), 27, 2, 4, [[1, 4], [2, 0]]),
}


def _jax_model(opts):
    opts = dict(opts)
    if "spatial_shape" in opts:
        opts["ordering"] = JOrdering("raster_scan", 3, opts["spatial_shape"])
    return JPerformer(**NET, **opts, dtype=jnp.float32)


def _port_kwargs(opts):
    kw = {k: v for k, v in dict(NET, **opts).items() if k not in ("num_tokens", "dim", "depth")}
    if "spatial_shape" in kw:
        kw["ordering"] = Ordering("raster_scan", 3, kw["spatial_shape"])
    return dict(kw, dtype=torch.float32, attn_compute_dtype=torch.float32, device="cpu")


def _jax_ops(q, k, v, g, proj):
    out = {}
    spec = P(None, None, "seq", None)
    for n_sh in (2, WORLD):
        mesh = Mesh(np.asarray(jax.devices()[:n_sh]), ("seq",))
        for name, fn in (
                ("favor", lambda a, b, c: jfavor.favor_attention_sequence_parallel(
                    a, b, c, proj, axis_name="seq", chunk=8)),
                ("favor_noproj", lambda a, b, c: jfavor.favor_attention_sequence_parallel(
                    a, b, c, None, axis_name="seq", chunk=8)),
                ("local", lambda a, b, c: jlocal.local_attention_sequence_parallel(
                    a, b, c, window=OPS["w"], axis_name="seq"))):
            sharded = jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                                    check_vma=False)

            def fwd_bwd(a, b, c, fn=sharded):
                o, vjp = jax.vjp(fn, a, b, c)
                return o, vjp(jnp.asarray(g))

            o, grads = jax.jit(fwd_bwd)(q, k, v)
            out[(name, n_sh)] = {"out": np.asarray(o),
                                 **{f"d{x}": np.asarray(t) for x, t in zip("qkv", grads)}}
    return out


@pytest.fixture(scope="module")
def weights():
    """The ops' inputs and each step case's JAX weights and batch."""
    rng = np.random.default_rng(0)
    b, h, n, d, m = (OPS[x] for x in "bhndm")
    q, k, v, g = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    proj = np.asarray(jfavor.gaussian_orthogonal_random_matrix(jax.random.key(1), m, d))
    # one init per architecture (JAX's init runs eagerly, seconds each):
    # the plain one, the conditioned one and the paper form; a case takes
    # its architecture's weights with the learned position table cut to
    # its length (or none, for the fixed table)
    inits = {}
    for arch, name in (("plain", "padding"), ("cond", "prepending"), ("paper", "paper")):
        opts, conds = CASES[name][0], CASES[name][4]
        jc = None if conds is None else [jnp.asarray(c, jnp.int32)[:1] for c in conds]
        state, _ = create_transformer_train_state(_jax_model(opts), jax.random.key(0),
                                                  opts["max_seq_len"], conditionings=jc)
        inits[arch] = (state, jax.device_get(state.params))
    cases = {}
    for name, (opts, n_tok, batch, n_sh, conds) in CASES.items():
        jm = _jax_model(opts)
        arch = ("paper" if opts.get("use_rezero") else "cond" if conds else "plain")
        state, params = inits[arch]
        params = dict(params)
        table = params.pop("abs_pos_emb")["embedding"]
        if not opts.get("fixed_position_emb"):
            params["abs_pos_emb"] = {"embedding": table[:jm.effective_seq_len]}
        if opts.get("use_rezero"):  # non-zero gains: gradients reach every block weight
            params = {k: (dict(v, g_attn=np.full((1,), 0.7, np.float32),
                               g_ff=np.full((1,), 0.5, np.float32))
                          if k.startswith("block_") else v) for k, v in params.items()}
        r = np.random.default_rng(11)
        x, y = (r.integers(0, 16, (batch, n_tok)).astype(np.int32) for _ in range(2))
        cases[name] = dict(opts=opts, jm=jm, state=state, params=params,
                           favor=jax.device_get(state.favor), x=x, y=y, conds=conds, n_sh=n_sh)
    return {"ops": {"q": q, "k": k, "v": v, "g": g, "proj": proj}, "steps": cases}


@pytest.fixture(scope="module")
def jax_side(weights):
    """JAX's ops over 2 and 4 shards and its SP step on every case."""
    ops = weights["ops"]
    cap = _capture_tx()
    steps = {}
    for name, c in weights["steps"].items():
        jc = None if c["conds"] is None else [jnp.asarray(v, jnp.int32) for v in c["conds"]]
        state = c["state"].replace(params=c["params"], opt_state=cap.init(c["params"]))
        n_tok, n_sh = c["x"].shape[1], c["n_sh"]
        if n_sh == WORLD:
            mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("seq",))
            step = JSP.make_sp_train_step(c["jm"], cap, mesh, n_tok)
        else:
            mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(2, n_sh), ("data", "seq"))
            step = JSP.make_sp_train_step(c["jm"], cap, mesh, n_tok, data_axis="data")
        new, met = jax.jit(step)(state, jnp.asarray(c["x"]), jnp.asarray(c["y"]), {"lr": 1e-3},
                                 jc)
        steps[name] = dict(loss=float(met["Loss"]), grads=jax.device_get(new.opt_state.g))
    return {"ops": _jax_ops(*(ops[x] for x in ("q", "k", "v", "g", "proj"))), "steps": steps}


def _port(case, tree):
    return performer_from_jax(tree, case["favor"], NET["depth"], **_port_kwargs(case["opts"]))


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """The four ranks' results, as a future: the ranks run while this
    process computes JAX's side (ask for this fixture before
    ``jax_side``)."""
    ops = weights["ops"]
    spec = {x: torch.tensor(ops[x]) for x in ("q", "k", "v", "g", "proj")}
    spec["window"] = OPS["w"]
    spec["steps"] = [
        dict(name=name, model=_port(c, c["params"]), seq_len=c["x"].shape[1],
             inputs=torch.from_numpy(c["x"]).long(), targets=torch.from_numpy(c["y"]).long(),
             conds=None if c["conds"] is None else [torch.tensor(v) for v in c["conds"]],
             sp_shards=c["n_sh"])
        for name, c in weights["steps"].items()]
    out = tmp_path_factory.mktemp("sp")
    torch.save(spec, out / "spec.pt")

    def run():
        launch([sys.executable, WORKER, "sp", str(out / "spec.pt"), str(out)], WORLD,
               timeout=300)
        return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


@pytest.mark.parametrize("n_sh", [2, WORLD])
@pytest.mark.parametrize("name", ["favor", "favor_noproj", "local"])
def test_sequence_parallel_attention_matches_jax(ranks, jax_side, name, n_sh):
    ref = jax_side["ops"][(name, n_sh)]
    ls = OPS["n"] // n_sh
    for r, out in enumerate(ranks.result()):
        got = out["ops"][(name, n_sh)]
        idx = r % n_sh if n_sh == 2 else r
        cols = slice(idx * ls, (idx + 1) * ls)
        for key in ("out", "dq", "dk", "dv"):
            _close(got[key].numpy(), ref[key][:, :, cols], 1e-4, f"rank {r} {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_sp_step_matches_jax(weights, ranks, jax_side, name):
    case = dict(weights["steps"][name], **jax_side["steps"][name])
    outs = ranks.result()
    got = outs[0]["steps"][name]
    np.testing.assert_allclose(got["loss"], case["loss"], rtol=1e-5)
    want = dict(_port(case, case["grads"]).named_parameters())
    assert set(got["grads"]) == set(want)
    for n, p in want.items():
        _close(got["grads"][n].numpy(), p.detach().numpy(), 1e-4, n)
    assert all(out["steps"][name]["agree"] for out in outs)


def _small(**kw):
    return Performer(num_tokens=17, max_seq_len=32, dim=32, depth=1, heads=2, dim_head=8,
                     nb_features=8, scan_chunk=8, dtype=torch.float32, device="cpu", **kw)


def test_sp_step_raises_as_jax():
    """Missing or unexpected conditioning values, a sequence beyond the
    padded length, dropout and rotary or axial positions."""
    x = torch.zeros(2, 32, dtype=torch.long)
    model = _small(conditioning_num_tokens=(5,), conditioning_type="bos_replacement")
    step = make_sp_train_step(model, None, 32)
    with pytest.raises(ValueError, match="conds missing"):
        step(create_state(model, 0), x, x, None, {"lr": 1e-3})
    model = _small()
    step = make_sp_train_step(model, None, 32)
    with pytest.raises(ValueError, match="conds given"):
        step(create_state(model, 0), x, x, [torch.tensor([1, 2])], {"lr": 1e-3})
    with pytest.raises(ValueError, match="exceeds padded capacity"):
        step(create_state(model, 0), torch.zeros(2, 40, dtype=torch.long),
             torch.zeros(2, 40, dtype=torch.long), None, {"lr": 1e-3})
    with pytest.raises(NotImplementedError, match="dropout"):
        make_sp_train_step(_small(ff_dropout=0.1), None, 32)
    for kw in (dict(rotary_position_emb=True), dict(axial_position_emb=True)):
        with pytest.raises(NotImplementedError, match="absolute/fixed"):
            make_sp_train_step(_small(**kw), None, 32)

"""Port fused decode step (synthanatomy_tpu_torch/ops/fused_decode.py)
against the JAX package: parameter packing, ring updates, and the plain
step held against both JAX's ``fused_decode_step_ref`` and its Pallas
kernel in interpret mode, on the shapes of tests/test_fused_decode.py.
The CUDA kernel itself is held against the plain step on the card by
tests/test_torch_kernels_gpu.py and, at paper width, chip_smoke.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.models.performer import Performer as JPerformer
from synthanatomy_tpu.ops import fused_decode as jfd
from synthanatomy_tpu_torch.interop import performer_from_jax
from synthanatomy_tpu_torch.ops import fused_decode as tfd

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B, DIM, HEADS, DH, LH, WIN, M, DEPTH, VOCAB = 2, 128, 2, 64, 1, 12, 128, 2, 33


def _models(rezero: bool):
    jm = JPerformer(
        num_tokens=VOCAB, max_seq_len=64, dim=DIM, depth=DEPTH, heads=HEADS,
        dim_head=DH, local_attn_heads=LH, local_window_size=WIN,
        nb_features=M, dtype=jnp.bfloat16, use_rezero=rezero,
    )
    variables = jax.jit(jm.init)(
        {"params": jax.random.key(0), "favor": jax.random.key(1)},
        jnp.zeros((1, 8), jnp.int32),
    )
    params = jax.device_get(variables["params"])
    if rezero:  # non-trivial gains so the fold is exercised
        params = dict(params)
        for i in range(DEPTH):
            blk = dict(params[f"block_{i}"])
            blk["g_attn"] = np.asarray([0.7], np.float32)
            blk["g_ff"] = np.asarray([0.5], np.float32)
            params[f"block_{i}"] = blk
    variables = {"params": params, "favor": jax.device_get(variables["favor"])}
    tm = performer_from_jax(
        params, variables["favor"], DEPTH, device="cpu", heads=HEADS, dim_head=DH,
        local_attn_heads=LH, local_window_size=WIN, nb_features=M,
        use_rezero=rezero,
    )
    return jm, variables, tm


@pytest.fixture(scope="module", params=[False, True], ids=["preln", "rezero"])
def models(request):
    return (request.param,) + _models(request.param)


def _cfgs(rezero, weight_quant, ring_quant):
    kw = dict(depth=DEPTH, batch=B, dim=DIM, heads=HEADS, dim_head=DH,
              local_heads=LH, local_window=WIN, nb_features=M,
              weight_quant=weight_quant, ring_quant=ring_quant,
              use_rezero=rezero)
    return (jfd.FusedDecodeConfig(**kw, state_dtype=jnp.bfloat16),
            tfd.FusedDecodeConfig(**kw))


@pytest.mark.parametrize("weight_quant", ["int8", "int4"])
def test_pack_fused_params_matches_jax(models, weight_quant):
    rezero, jm, variables, tm = models
    pj = jfd.pack_fused_params(jm, variables, weight_quant=weight_quant)
    pt = tfd.pack_fused_params(tm, weight_quant=weight_quant)
    assert set(pt) == (set(pj) - {"proj2"}) | {"projT"}
    for k, v in pt.items():
        want = np.asarray(pj["proj2"])[:, :DH, :M] if k == "projT" else np.asarray(pj[k])
        # quantized bytes bit-exact; f32 tensors from the same f32 inputs
        # through the same scalar products
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)


def _random_state(cfg_t, seed):
    """Seeded state with realistic signs: S from k_p·v sums, z > 0,
    rings holding rotated keys/values of O(1) size."""
    rng = np.random.default_rng(seed)
    L, R = DEPTH, cfg_t.ring_size
    st = {
        "S": (rng.normal(size=(L, M, cfg_t.bg)) * 0.5).astype(np.float32),
        "z": rng.uniform(0.5, 3.0, size=(L, B * cfg_t.gh, M)).astype(np.float32),
    }
    if cfg_t.ring_quant:
        st["ck"] = rng.integers(-127, 128, size=(L, R, cfg_t.bl)).astype(np.int8)
        st["cv"] = rng.integers(-127, 128, size=(L, R, cfg_t.bl)).astype(np.int8)
        st["ck_s"] = rng.uniform(0.005, 0.02, size=(L, R, B * LH)).astype(np.float32)
        st["cv_s"] = rng.uniform(0.005, 0.02, size=(L, R, B * LH)).astype(np.float32)
    else:
        st["ck"] = rng.normal(size=(L, R, cfg_t.bl)).astype(np.float32)
        st["cv"] = rng.normal(size=(L, R, cfg_t.bl)).astype(np.float32)
    h = rng.normal(size=(B, DIM)).astype(np.float32)
    return st, h


def _to_jax(st):
    out = {}
    for k, v in st.items():
        dt = jnp.bfloat16 if k in ("S",) or (k in ("ck", "cv") and v.dtype == np.float32) else None
        out[k] = jnp.asarray(v, dt) if dt is not None else jnp.asarray(v)
    return out


def _to_torch(st):
    out = {}
    for k, v in st.items():
        t = torch.from_numpy(v.copy())
        if k == "S" or (k in ("ck", "cv") and v.dtype == np.float32):
            t = t.to(torch.bfloat16)
        out[k] = t
    return out


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.to(torch.float32).numpy()


@pytest.mark.parametrize("ring_quant", [False, True], ids=["bf16rings", "int8rings"])
def test_update_rings_matches_jax(ring_quant):
    cfg_j, cfg_t = _cfgs(False, "int8", ring_quant)
    st, _ = _random_state(cfg_t, 3)
    rng = np.random.default_rng(4)
    k_all = rng.normal(size=(DEPTH, cfg_t.bl)).astype(np.float32)
    v_all = rng.normal(size=(DEPTH, cfg_t.bl)).astype(np.float32)
    k_all[0, :DH] = 0.0  # an all-zero head hits the 1e-8 scale floor
    for t in (5, 130):  # 130 wraps the 128-slot ring
        sj = jfd.update_rings(_to_jax(st), jnp.asarray(k_all), jnp.asarray(v_all), t, cfg_j)
        stt = _to_torch(st)
        out = tfd.update_rings(stt, torch.from_numpy(k_all), torch.from_numpy(v_all), t, cfg_t)
        assert out is stt  # in place
        for k in stt:
            np.testing.assert_array_equal(_np(stt[k]), _np(sj[k]), err_msg=f"{k} t={t}")


# every weight x ring format at a partly filled window, plus the empty
# ring (t=0) and steps past the 128-slot ring wrap
STEP_CASES = [
    pytest.param(wq, rq, t, id=f"{wq}-{'int8' if rq else 'bf16'}rings-t{t}")
    for wq, rq, t in (("int8", False, 0), ("int8", False, 7), ("int8", True, 7),
                      ("int4", False, 7), ("int4", True, 7), ("int8", True, 131),
                      ("int4", False, 131))
]


@pytest.mark.parametrize("weight_quant,ring_quant,t", STEP_CASES)
def test_plain_step_matches_jax_ref_and_kernel(models, weight_quant, ring_quant, t):
    rezero, jm, variables, tm = models
    cfg_j, cfg_t = _cfgs(rezero, weight_quant, ring_quant)
    pj = jfd.pack_fused_params(jm, variables, weight_quant=weight_quant)
    pt = tfd.strip_reference_weights(tfd.pack_fused_params(tm, weight_quant=weight_quant))
    st, h = _random_state(cfg_t, 11 + t)

    hk, sk, kk, vk = jfd.make_fused_decode_step(cfg_j, interpret=True)(
        pj, _to_jax(st), jnp.asarray(h), t)
    hr, sr, kr, vr = jfd.fused_decode_step_ref(pj, _to_jax(st), jnp.asarray(h), jnp.asarray(t), cfg_j)
    stt = _to_torch(st)
    ht, stt2, kt, vt = tfd.fused_decode_step(pt, stt, torch.from_numpy(h), t, cfg_t)
    assert stt2 is stt  # S and z were updated in place

    # vs the Pallas kernel: same bf16 rounding points, sums in another
    # order.  Agreement is ~1e-6 unless an activation sits on a bf16
    # rounding boundary and flips by one ulp (2^-8 relative) before a
    # GEMV; such a flip moves a few outputs by up to ~1e-2, so the
    # elementwise bound allows it and the norm bound keeps it rare.
    for name, a, b in (("h", ht, hk), ("k", kt, kk), ("v", vt, vk),
                       ("z", stt["z"], sk["z"]), ("S", stt["S"], sk["S"])):
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2, err_msg=name)
        assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b), name
    # vs JAX's plain reference, which keeps f32 where the kernel rounds to
    # bf16 (numerator, scores): the tolerance of tests/test_fused_decode.py
    np.testing.assert_allclose(_np(ht), _np(hr), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(kt), _np(kr), rtol=2e-2, atol=2e-2)


def test_cpu_wrapper_takes_plain_version(models):
    """A CPU tensor runs the plain version and launches nothing."""
    rezero, jm, variables, tm = models
    _, cfg_t = _cfgs(rezero, "int8", True)
    pt = tfd.pack_fused_params(tm)
    st, h = _random_state(cfg_t, 5)
    before = tfd.fused_decode_step.launches
    a = tfd.fused_decode_step(pt, _to_torch(st), torch.from_numpy(h), 3, cfg_t)
    b = tfd.fused_decode_step_ref(pt, _to_torch(st), torch.from_numpy(h), 3, cfg_t)
    assert tfd.fused_decode_step.launches == before
    for x, y in zip((a[0], a[2], a[3]), (b[0], b[2], b[3])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_step_takes_t_as_a_tensor(models):
    """t as a 0-d int64 tensor (what a CUDA graph of the step captures)
    gives the bits of the int t, state included."""
    rezero, jm, variables, tm = models
    _, cfg_t = _cfgs(rezero, "int8", True)
    pt = tfd.strip_reference_weights(tfd.pack_fused_params(tm))
    st, h = _random_state(cfg_t, 6)
    for t in (0, 9, 130):
        sa, sb = _to_torch(st), _to_torch(st)
        a = tfd.fused_decode_step(pt, sa, torch.from_numpy(h), t, cfg_t)
        b = tfd.fused_decode_step(pt, sb, torch.from_numpy(h), torch.tensor(t), cfg_t)
        for x, y in zip((a[0], a[2], a[3], sa["S"], sa["z"]), (b[0], b[2], b[3], sb["S"], sb["z"])):
            assert torch.equal(x, y), t


@pytest.mark.parametrize("ring_quant", [False, True], ids=["bf16rings", "int8rings"])
def test_update_rings_tensor_slot_matches_int(ring_quant):
    """The ring write at a 0-d tensor t (``index_copy_``, capturable) writes
    what the write at the int t writes, across the ring's wrap."""
    _, cfg_t = _cfgs(False, "int8", ring_quant)
    st, _ = _random_state(cfg_t, 8)
    rng = np.random.default_rng(9)
    k_all = torch.from_numpy(rng.normal(size=(DEPTH, cfg_t.bl)).astype(np.float32))
    v_all = torch.from_numpy(rng.normal(size=(DEPTH, cfg_t.bl)).astype(np.float32))
    for t in (0, 5, 127, 128, 131):
        sa, sb = _to_torch(st), _to_torch(st)
        tfd.update_rings(sa, k_all, v_all, t, cfg_t)
        assert tfd.update_rings(sb, k_all, v_all, torch.tensor(t), cfg_t) is sb
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (k, t)


def test_stepper_takes_t_as_a_tensor(models):
    """The fused stepper fed t as a 0-d tensor gives the logits of the
    stepper fed ints, bit for bit, over steps past the 12-token window."""
    from synthanatomy_tpu_torch.models.sampling import fused_logits_stepper

    rezero, jm, variables, tm = models
    tokens = _token_seq()
    a = _teacher_forced(tm, tokens, fused_logits_stepper(tm, batch=B, ring_quant=True))
    step = fused_logits_stepper(tm, batch=B, ring_quant=True)
    with torch.no_grad():
        b = torch.stack([step(torch.from_numpy(tokens[:, t]).long(), torch.tensor(t))
                         for t in range(tokens.shape[1])], dim=1)
    assert torch.equal(a, b)


def test_unquantized_branch_tracks_quantized():
    """The f32-weight branch of the plain step (``use_quantized=False``)
    matches JAX's unquantized reference."""
    jm, variables, tm = _models(True)
    cfg_j, cfg_t = _cfgs(True, "int8", False)
    pj = jfd.pack_fused_params(jm, variables)
    pt = tfd.pack_fused_params(tm)
    st, h = _random_state(cfg_t, 9)
    hr, _, kr, _ = jfd.fused_decode_step_ref(
        pj, _to_jax(st), jnp.asarray(h), jnp.asarray(4), cfg_j, use_quantized=False)
    ht, _, kt, _ = tfd.fused_decode_step_ref(
        pt, _to_torch(st), torch.from_numpy(h), 4, cfg_t, use_quantized=False)
    np.testing.assert_allclose(_np(ht), _np(hr), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(kt), _np(kr), rtol=2e-2, atol=2e-2)


def test_supports_fused_decode_gating():
    _, _, tm = _models(False)
    assert tfd.supports_fused_decode(tm)
    tm.dim_head = 32
    assert not tfd.supports_fused_decode(tm)


def test_wide_prior_routes_to_the_fused_step():
    """A dim-2048 prior (FF 8192: its FF2 product's K is past 16 splits of
    256 int8 rows) is one the fused step covers, as the JAX package's gate
    says, so ``make_sampler("auto")`` takes the fused sampler."""
    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer
    from synthanatomy_tpu_torch.models.sampling import make_sampler

    kw = dict(num_tokens=17, max_seq_len=13, dim=2048, depth=1, heads=3, dim_head=128,
              local_attn_heads=1, local_window_size=4, nb_features=64)
    jm = JPerformer(**kw, dtype=jnp.bfloat16)
    tm = Performer(**kw, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    assert jfd.supports_fused_decode(jm)
    assert tfd.supports_fused_decode(tm)
    assert make_sampler(tm, Ordering("raster_scan", 3, (2, 3, 2)), batch=2).fused


def test_wrapper_rejects_meta_tensors():
    _, cfg_t = _cfgs(False, "int8", False)
    with pytest.raises(ValueError):
        tfd.fused_decode_step({}, {}, torch.empty(B, DIM, device="meta"), 0, cfg_t)



def test_init_fused_state_defaults_to_the_card():
    """Like every other entry, the zeroed decode state is allocated on the
    card unless the caller asks for the CPU."""
    _, cfg_t = _cfgs(False, "int8", True)
    st = tfd.init_fused_state(cfg_t, device="cpu")
    assert all(v.device.type == "cpu" and not v.any() for v in st.values())
    if torch.cuda.is_available():
        assert all(v.is_cuda for v in tfd.init_fused_state(cfg_t).values())
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tfd.init_fused_state(cfg_t)


# ---------------------------------------------------------------------------
# guards of the fused engine against the exact decode path
# ---------------------------------------------------------------------------


def _teacher_forced(tm, tokens, step):
    """Logits (B, T, V) f32 of ``step(tok, t)`` over the given tokens."""
    with torch.no_grad():
        return torch.stack([step(torch.from_numpy(tokens[:, t]).long(), t).float()
                            for t in range(tokens.shape[1])], dim=1)


def _token_seq():
    return np.random.default_rng(7).integers(0, VOCAB - 1, (B, 24)).astype(np.int32)


def test_int8_rings_close_to_bf16_rings(models):
    """Quality guard (tests/test_fused_decode.py:364): the fused engine
    with int8 rings against bf16 rings on the same tokens, past the
    12-token window — logit perturbation small, greedy picks kept."""
    from synthanatomy_tpu_torch.models.sampling import fused_logits_stepper

    rezero, jm, variables, tm = models
    tokens = _token_seq()
    lb = _teacher_forced(tm, tokens, fused_logits_stepper(tm, batch=B, ring_quant=False))
    li = _teacher_forced(tm, tokens, fused_logits_stepper(tm, batch=B, ring_quant=True))
    rel = float((lb - li).abs().max() / (lb.std() + 1e-9))
    assert rel < 0.1, rel
    agree = float((lb.argmax(-1) == li.argmax(-1)).float().mean())
    assert agree >= 0.9, agree


def test_int4_weights_bounded_perturbation_against_exact(models):
    """int4 packed weights through the fused engine against the exact
    decode_step path (tests/test_fused_decode.py:154): finite, mean
    perturbation under 0.3 of the logit std, greedy agreement ≥ 0.5 on
    this untrained random prior, whose flat logits flip easily."""
    from synthanatomy_tpu_torch.models.sampling import exact_logits_stepper, fused_logits_stepper

    rezero, jm, variables, tm = models
    tokens = _token_seq()
    exact = _teacher_forced(tm, tokens, exact_logits_stepper(tm, batch=B))
    q4 = _teacher_forced(tm, tokens, fused_logits_stepper(tm, batch=B, weight_quant="int4"))
    assert torch.isfinite(q4).all()
    rel = float((q4 - exact).abs().mean() / exact.std())
    assert rel < 0.3, f"mean perturbation {rel:.3f} of logit std"
    agree = float((q4.argmax(-1) == exact.argmax(-1)).float().mean())
    assert agree >= 0.5, f"greedy agreement {agree}"


@pytest.mark.parametrize("paper_form", [False, True], ids=["preln", "rezero+spatial"])
def test_trained_model_fused_int8_greedy_matches_exact(paper_form):
    """Quality guard on a TRAINED prior (tests/test_fused_decode.py:520),
    trained with the port's own train step: fit a deterministic pattern to
    low CE, then the fused sampler with int8 weights AND int8 rings must
    agree greedily with the exact sampler, everywhere."""
    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.performer import Performer
    from synthanatomy_tpu_torch.models.sampling import make_sampler
    from synthanatomy_tpu_torch.runners.transformer import prepare_batch
    from synthanatomy_tpu_torch.train.transformer_steps import (
        create_transformer_train_state,
        make_transformer_train_step,
    )

    grid, vocab = (2, 3, 2), 16
    seq = int(np.prod(grid))
    ordering = Ordering("raster_scan", 3, grid)
    pattern = (5 * np.arange(seq)) % vocab
    latents = np.broadcast_to(pattern.reshape(grid), (8,) + grid)
    extra = (dict(use_rezero=True, spatial_position_emb="absolute", spatial_shape=grid,
                  ordering=ordering) if paper_form else {})
    model = Performer(vocab + 1, seq + 1, 128, 2, heads=2, dim_head=64, local_attn_heads=1,
                      local_window_size=4, nb_features=64, dtype=torch.float32, scan_chunk=8,
                      generator=torch.Generator().manual_seed(0), device="cpu", **extra)
    assert tfd.supports_fused_decode(model)
    state = create_transformer_train_state(model, 0, learning_rate=3e-3)
    step = make_transformer_train_step(model)
    inputs, targets = (torch.from_numpy(a).long() for a in prepare_batch(latents, ordering, vocab))
    for _ in range(120):
        state, metrics = step(state, inputs, targets, None, {"lr": 3e-3})
    ce = float(metrics["Loss"])
    assert ce < 0.2, f"tiny model failed to fit (CE={ce})"

    exact = make_sampler(model, ordering, batch=2, do_sample=False, fused=False)(None)
    fused = make_sampler(model, ordering, batch=2, do_sample=False, fused=True,
                         ring_quant=True)(None)
    assert float((exact == fused).float().mean()) == 1.0
    np.testing.assert_array_equal(exact[0].numpy(), pattern.reshape(grid))

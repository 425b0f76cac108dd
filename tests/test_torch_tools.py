"""The port's tools on ported modules (``synthanatomy_tpu_torch/cli.py``,
``tools/validate_fused_decode.py``, ``tools/bench_pipeline.py``,
``tools/bench_local_attn.py``, ``tools/bench_local_kernel.py``,
``tools/bench_res_stack.py``) on the CPU, where every kernel wrapper
takes its plain twin: each CLI end to end at shrunken module constants,
the copied ``parse_argv`` against JAX's, and ``validate_fused_decode``'s
pieces against the JAX tool's computation at 3 training steps in f32.

Tolerances of the parity test: f32 on both sides, the same operations
summed in other orders (~1e-6 relative per step); the training losses
agree to 1e-4 relative after 3 Adam steps, greedy grids exactly, the
batch forward's logits to 1e-4 of their scale, and the fused step's
(int8 weights and rings, bf16 FAVOR state on both sides) to 1e-2 of
the logit scale: a value on a bf16 or int8 rounding boundary may go
the other way.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.cli import parse_argv as j_parse_argv
from synthanatomy_tpu.models.ordering import Ordering as JOrdering
from synthanatomy_tpu.models.performer import Performer as JPerformer
from synthanatomy_tpu.models.sampling import make_sampler as j_make_sampler
from synthanatomy_tpu.ops import fused_decode as jfd
from synthanatomy_tpu.runners.transformer import prepare_batch as j_prepare_batch
from synthanatomy_tpu.train.transformer_steps import (
    create_transformer_train_state as j_create_state,
    make_transformer_train_step as j_make_step,
)
from synthanatomy_tpu_torch.cli import parse_argv
from synthanatomy_tpu_torch.interop import performer_from_jax
from synthanatomy_tpu_torch.models.ordering import Ordering
from synthanatomy_tpu_torch.ops import vq
from synthanatomy_tpu_torch.tools import (
    bench_fused_decode,
    bench_local_attn,
    bench_local_kernel,
    bench_pipeline,
    bench_res_stack,
    bench_vq,
    validate_fused_decode,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SMALL = dict(dim=128, depth=2, heads=2, dim_head=64, local_attn_heads=1, local_window_size=6,
             nb_features=128)


@pytest.mark.parametrize("argv", [
    [],
    ["run", "--batch=4", "--reps", "2", "--split"],
    ["--roi=((16,176),(16,240),(96,256))", "--name", "x y", "--nosplit"],
    ["a", "b", "--lr=1e-3", "--flag", "--other=None", "--t=True", "--f", "false"],
    ["--dash-name=3", "--last"],
])
def test_parse_argv_matches_jax(argv):
    assert parse_argv(argv) == j_parse_argv(argv)


@pytest.fixture
def small_validation(monkeypatch):
    for name, value in (("GRID", (2, 3, 4)), ("VOCAB", 32), ("N_VOLS", 8), ("MODEL", SMALL),
                        ("T_TF", 20), ("SAMPLE_BATCH", 2)):
        monkeypatch.setattr(validate_fused_decode, name, value)
    return validate_fused_decode


@pytest.mark.parametrize("flags", [[], ["--weight-quant", "int4", "--paper-form"]],
                         ids=["int8", "int4-paper-form"])
def test_validate_fused_decode_cli_runs_on_cpu(small_validation, flags, capsys):
    rec = small_validation.main(["--cpu", "--steps", "2", "--batch", "2", *flags])
    assert '"trained_ce"' in capsys.readouterr().out
    assert rec["weight_quant"] == (flags[1] if flags else "int8")
    assert rec["block_form"] == ("rezero+spatial" if flags else "preln")
    for key in ("greedy_agreement_fused_bf16_rings", "greedy_agreement_fused_int8_rings",
                "teacher_forced_greedy_agreement"):
        assert 0.0 <= rec[key] <= 1.0
    assert rec["teacher_forced_mean_kl"] >= 0.0 and 0.0 <= rec["teacher_forced_mean_tv"] <= 1.0
    assert rec["fused_step_kernel_vs_plain_max_rel_err"] == 0.0  # no kernel on the host


def _jax_roll(jm, variables, toks, weight_quant, cfg_kw):
    """The JAX tool's teacher-forced fused roll (tools/validate_fused_decode.py:
    :149-183): fused_decode_step_ref over the tokens, then the final
    LayerNorm and the head in f32, at every position."""
    cfg = jfd.FusedDecodeConfig(quantize=True, state_dtype=jnp.bfloat16, ring_quant=True,
                                weight_quant=weight_quant, **cfg_kw)
    params_f = jfd.pack_fused_params(jm, variables, weight_quant=weight_quant)
    st = jfd.init_fused_state(cfg)
    p = variables["params"]
    pemb, ppos = p["token_emb"]["embedding"], p["abs_pos_emb"]["embedding"]
    fn, out_k = p["final_norm"], p["to_out"]

    @jax.jit
    def roll(params_f, st, toks, pemb, ppos):
        def body(st, t):
            h = (pemb[toks[:, t]] + ppos[t][None]).astype(jnp.float32)
            h, st, ka, va = jfd.fused_decode_step_ref(params_f, st, h, t, cfg,
                                                      use_quantized=True)
            st = jfd.update_rings(st, ka, va, t, cfg)
            mu = h.mean(-1, keepdims=True)
            var = ((h - mu) ** 2).mean(-1, keepdims=True)
            hn = (h - mu) * jax.lax.rsqrt(var + 1e-6) * fn["scale"] + fn["bias"]
            return st, hn @ out_k["kernel"] + out_k["bias"]

        _, logits = jax.lax.scan(body, st, jnp.arange(toks.shape[1]))
        return jnp.swapaxes(logits, 0, 1)

    return np.asarray(roll(params_f, st, toks, pemb, ppos))


def test_validate_fused_decode_matches_jax(small_validation):
    """The tool's latents, 3 training steps, greedy grids and
    teacher-forced logits against the JAX tool's computation, in f32."""
    v = small_validation
    steps, batch, lr = 3, 2, 1e-3
    grid, vocab = v.GRID, v.VOCAB
    seq = int(np.prod(grid))
    jm = JPerformer(num_tokens=vocab + 1, max_seq_len=seq + 1, dtype=jnp.float32,
                    scan_chunk=128, **SMALL)
    jordering = JOrdering("raster_scan", 3, grid)
    rng = np.random.default_rng(0)
    latents = v.structured_latents(rng)
    state, tx = j_create_state(jm, jax.random.key(0), seq + 1, learning_rate=lr)
    init = jax.device_get({"params": state.params, "favor": state.favor})
    model = performer_from_jax(
        init["params"], init["favor"], SMALL["depth"], device="cpu", dtype=torch.float32,
        use_pallas_favor=True, use_pallas_local=True, feature_redraw_interval=0,
        **{k: val for k, val in SMALL.items() if k not in ("dim", "depth")})

    jstep = jax.jit(j_make_step(jm, tx))
    jrng = np.random.default_rng(1)
    jlosses = []
    for _ in range(steps):
        sel = jrng.integers(0, len(latents), batch)
        inputs, targets = j_prepare_batch(latents[sel], jordering, vocab)
        state, metrics = jstep(state, jnp.asarray(inputs), jnp.asarray(targets), None,
                               {"lr": lr})
        jlosses.append(float(metrics["Loss"]))
    ordering = Ordering("raster_scan", 3, grid)
    losses = v.train(model, ordering, latents, np.random.default_rng(1), steps, batch, lr)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)

    variables = jax.device_get({"params": state.params, "favor": state.favor})
    grids = v.greedy_grids(model, ordering, "int8")
    for key, fused, rq in (("exact", False, False), ("fused_bf16_rings", True, False),
                           ("fused_int8_rings", True, True)):
        want = j_make_sampler(jm, jordering, batch=v.SAMPLE_BATCH, do_sample=False, fused=fused,
                              ring_quant=rq, weight_quant="int8")(variables, jax.random.key(7))
        np.testing.assert_array_equal(grids[key].numpy(), np.asarray(want), err_msg=key)

    tf = v.teacher_forced(model, latents, "int8")
    toks = np.concatenate([[vocab], latents[0].reshape(-1)[: v.T_TF - 1]])
    toks = jnp.asarray(toks[None].repeat(2, 0), jnp.int32)
    exact = np.asarray(jax.jit(jm.apply)(variables, toks))
    scale = np.abs(exact).max()
    np.testing.assert_allclose(tf["exact"].numpy() / scale, exact / scale, rtol=0, atol=1e-4)
    fused = _jax_roll(jm, variables, toks, "int8", dict(
        depth=SMALL["depth"], batch=2, dim=SMALL["dim"], heads=SMALL["heads"],
        dim_head=SMALL["dim_head"], local_heads=SMALL["local_attn_heads"],
        local_window=SMALL["local_window_size"], nb_features=SMALL["nb_features"]))
    np.testing.assert_allclose(tf["fused"].numpy() / scale, fused / scale, rtol=0, atol=1e-2)


def test_bench_pipeline_cli_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench_pipeline, "GRID", (2, 3, 2))
    monkeypatch.setattr(bench_pipeline, "PRIOR", SMALL)
    monkeypatch.setattr(bench_pipeline, "VQVAE", dict(
        n_levels=2, downsample_parameters=((4, 2, 1, 1),) * 2,
        upsample_parameters=((4, 2, 1, 0, 1),) * 2, n_embed=32, embed_dim=8, n_channels=16,
        n_res_channels=16, n_res_layers=1))
    res = bench_pipeline.main(["--cpu", "--batch=2", "--reps=1", "--split"])
    out = capsys.readouterr().out
    for line in ("[e2e] compile+run", "[e2e] paper-form synthesis batch=2",
                 "[split] sampling alone", "[split] decode alone (2 vols, sub-batch 8)"):
        assert line in out
    assert all(res[k] > 0 for k in ("e2e_s", "volumes_per_min", "sampling_s", "decode_s"))


def test_bench_local_attn_cli_runs_on_cpu(capsys):
    res = bench_local_attn.main(["--cpu", "--b", "1", "--h", "2", "--n", "40", "--d", "16",
                                 "--window", "12"])
    out = capsys.readouterr().out
    assert all(f"{k} {p}:" in out for k in ("xla", "pallas") for p in ("fwd", "bwd"))
    # bf16 outputs of the same function rounded at other points
    assert res["max_abs_diff"] < 0.05 and all(res[k] > 0 for k in ("xla_fwd", "pallas_bwd"))


@pytest.mark.parametrize("variant", bench_local_kernel.VARIANTS)
def test_bench_local_kernel_cli_runs_on_cpu(variant, capsys):
    for bwd in ([], ["--bwd"]):
        t = bench_local_kernel.main(["--cpu", "--batch", "1", "--heads", "2", "--seq", "40",
                                     "--d", "16", "--window", "12", "--iters", "1",
                                     "--variant", variant, *bwd])
        assert t > 0
    out = capsys.readouterr().out
    assert "fwd: " in out and "fwd+bwd: " in out and "(b1 h2 w12 L40)" in out


def test_bench_res_stack_cli_runs_on_cpu(capsys):
    res = bench_res_stack.main(["--cpu", "--shape", "4,6,4", "--reps", "1"])
    out = capsys.readouterr().out
    assert "exactness: sum ref=" in out and "-> fused vs XLA" in out
    assert set(res) == {("module", False), ("fused", False), ("module", True),
                        ("fused", True)}


def test_bench_vq_check_allows_only_near_ties():
    """The check before the turns: indices equal but where the two codes'
    distances tie (here a duplicated codeword), counts equal."""
    gen = torch.Generator().manual_seed(3)
    x, w = torch.randn(50, 8, generator=gen), torch.randn(40, 8, generator=gen)
    w[39] = w[0]
    x[0] = w[0]  # row 0 ties between codes 0 and 39
    want = vq.nearest_codeword_plain(x, w)
    assert int(want[0]) == 0
    got = want.clone()
    got[0] = 39
    assert bench_vq.check_same(x, w, got, want) == 1
    far = want.clone()
    far[1] = int(torch.argmax((w * w).sum(1) - 2 * x[1] @ w.t()))
    with pytest.raises(RuntimeError, match="argmin differs on 1 rows"):
        bench_vq.check_same(x, w, far, want)
    with pytest.raises(RuntimeError, match="counts differ"):
        bench_vq.check_same(x, w, want, want, torch.ones(40), torch.zeros(40))


def test_bench_vq_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is checked where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_vq.main(["vq_argmin.cu"])


def test_bench_fused_decode_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal is checked where there is no card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_fused_decode.main([])

"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

Every test is marked ``gpu`` and skips without a CUDA card.
"""

import numpy as np
import pytest
import torch

from synthanatomy_tpu_torch.models.performer import Performer
from synthanatomy_tpu_torch.ops import favor_attention as tfa
from synthanatomy_tpu_torch.ops import fused_decode as tfd
from synthanatomy_tpu_torch.ops import kernel_body as tkb
from synthanatomy_tpu_torch.ops import local_attention_flash as tlf
from synthanatomy_tpu_torch.ops import local_attention_splash as tsp
from synthanatomy_tpu_torch.ops import probes as tpr
from synthanatomy_tpu_torch.ops import quant as tq
from synthanatomy_tpu_torch.ops import res_stack as trs
from synthanatomy_tpu_torch.ops import vq as tvq
from synthanatomy_tpu_torch.ops.favor import gaussian_orthogonal_random_matrix
from synthanatomy_tpu_torch.tools import probe_kernel_body as pkb

B, DIM, HEADS, DH, LH, WIN, M, DEPTH, VOCAB = 2, 128, 2, 64, 1, 12, 128, 2, 33


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' f32 convolutions in full f32 (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(rezero, device, max_seq_len=64):
    model = Performer(VOCAB, max_seq_len, DIM, DEPTH, HEADS, DH, LH, WIN, nb_features=M,
                      use_rezero=rezero, generator=torch.Generator().manual_seed(0))
    if rezero:
        with torch.no_grad():
            for blk in model.blocks:
                blk.g_attn.fill_(0.7)
                blk.g_ff.fill_(0.5)
    return model.to(device)


def _state(cfg, seed, device):
    rng = np.random.default_rng(seed)
    L, R = cfg.depth, cfg.ring_size
    st = {
        "S": torch.tensor(rng.normal(size=(L, M, cfg.bg)) * 0.5, dtype=torch.bfloat16),
        "z": torch.tensor(rng.uniform(0.5, 3.0, size=(L, B * cfg.gh, M)), dtype=torch.float32),
    }
    if cfg.ring_quant:
        for k in ("ck", "cv"):
            st[k] = torch.tensor(rng.integers(-127, 128, size=(L, R, cfg.bl)), dtype=torch.int8)
            st[k + "_s"] = torch.tensor(rng.uniform(0.005, 0.02, size=(L, R, B * LH)),
                                        dtype=torch.float32)
    else:
        for k in ("ck", "cv"):
            st[k] = torch.tensor(rng.normal(size=(L, R, cfg.bl)), dtype=torch.bfloat16)
    h = torch.tensor(rng.normal(size=(B, DIM)), dtype=torch.float32)
    return {k: v.to(device) for k, v in st.items()}, h.to(device)


def _fused_cfg(weight_quant="int8", ring_quant=False, rezero=False, **kw):
    base = dict(depth=DEPTH, batch=B, dim=DIM, heads=HEADS, dim_head=DH, local_heads=LH,
                local_window=WIN, nb_features=M)
    base.update(kw)
    return tfd.FusedDecodeConfig(weight_quant=weight_quant, ring_quant=ring_quant,
                                 use_rezero=rezero, **base)


def _fused_close(name, a, b):
    # sums in another order; a bf16 flip of one activation moves a few
    # outputs by up to ~1e-2 (see tests/test_torch_fused_decode.py)
    a, b = a.float(), b.float()
    torch.testing.assert_close(a, b, rtol=1e-2, atol=1e-2, msg=name)
    assert torch.linalg.norm(a - b) <= 2e-3 * torch.linalg.norm(b), name


FUSED_VARIANTS = [(wq, rq, rz) for wq in ("int8", "int4") for rq in (False, True)
                  for rz in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("weight_quant,ring_quant,rezero", FUSED_VARIANTS,
                         ids=[f"{w}-{'int8' if r else 'bf16'}rings-{'rezero' if z else 'preln'}"
                              for w, r, z in FUSED_VARIANTS])
def test_fused_decode_kernel_matches_plain(cuda, weight_quant, ring_quant, rezero):
    """Every weight, ring and block variant against the plain step at t = 0,
    1, R − 1, R (the ring's wrap) and 1000; two calls give the same bits,
    t as an int or a device tensor, and each call counts one step."""
    model = _model(rezero, cuda)
    cfg = _fused_cfg(weight_quant, ring_quant, rezero)
    R = cfg.ring_size
    params = tfd.strip_reference_weights(tfd.pack_fused_params(model, weight_quant=weight_quant))
    for t in (0, 1, R - 1, R, 1000):
        sk, h = _state(cfg, t, cuda)
        sr = {k: v.clone() for k, v in sk.items()}
        s2 = {k: v.clone() for k, v in sk.items()}
        before = tfd.fused_decode_step.launches
        hk, _, kk, vk = tfd.fused_decode_step(params, sk, h, t, cfg)
        hr, _, kr, vr = tfd.fused_decode_step_ref(params, sr, h, t, cfg)
        h2, _, k2, v2 = tfd.fused_decode_step(params, s2, h, torch.tensor(t, device=cuda), cfg)
        torch.cuda.synchronize()
        assert tfd.fused_decode_step.launches == before + 2
        for name, a, b in (("h", hk, hr), ("k", kk, kr), ("v", vk, vr),
                           ("z", sk["z"], sr["z"]), ("S", sk["S"], sr["S"])):
            _fused_close(f"{name} t={t}", a, b)
        for a, b in ((hk, h2), (kk, k2), (vk, v2), (sk["S"], s2["S"]), (sk["z"], s2["z"])):
            assert torch.equal(a, b), f"two calls differ at t={t}"


@pytest.mark.gpu
@pytest.mark.parametrize("wide", ["B17", "d128-chunked", "ff9216-chunked-k"])
def test_fused_decode_kernel_wide_shapes(cuda, wide):
    """Two batch tiles (B17); d 128 with bf16 rings at window 420, whose
    ring slice does not fit shared memory whole (the local blocks stream
    it in chunks, fused_plan.h); and FF 9216, whose FF2 splits hold more
    than kMaxRows packed rows with int8 (576) and int4 (288) weights (a
    GEMV block walks them in chunks): against the plain step, layer by
    layer, and the whole depth equal to the chain of its layers."""
    import dataclasses

    ff_mult, formats = 4, [("int8", False), ("int8", True)]
    if wide == "B17":
        kw, mkw = dict(batch=17, heads=4, local_heads=2, local_window=40, nb_features=64), \
            dict(heads=4, dim_head=64, local_heads=2, window=40, m=64, dim=DIM)
        ts = (0, 45, 300)
    elif wide == "d128-chunked":
        kw, mkw = dict(batch=3, dim=256, heads=2, dim_head=128, local_heads=1, local_window=420,
                       nb_features=64), dict(heads=2, dim_head=128, local_heads=1, window=420,
                                              m=64, dim=256)
        ts = (5, 1000)
    else:
        ff_mult, formats = 72, [("int8", True), ("int4", False)]
        kw, mkw = dict(ff_mult=ff_mult), dict(heads=HEADS, dim_head=DH, local_heads=LH,
                                              window=WIN, m=M, dim=DIM)
        ts = (0, 200)
    model = Performer(VOCAB, 64, mkw["dim"], DEPTH, mkw["heads"], mkw["dim_head"],
                      mkw["local_heads"], mkw["window"], nb_features=mkw["m"], ff_mult=ff_mult,
                      generator=torch.Generator().manual_seed(3)).to(cuda)
    for wq, rq in formats:
        cfg = _fused_cfg(wq, rq, False, **kw)
        one = dataclasses.replace(cfg, depth=1)
        params = tfd.strip_reference_weights(tfd.pack_fused_params(model, weight_quant=wq))
        layers = [{k: v[i:i + 1].clone() for k, v in params.items()} for i in range(DEPTH)]
        gen = torch.Generator(device=cuda).manual_seed(4)
        for t in ts:
            st = {"S": (torch.randn(DEPTH, cfg.nb_features, cfg.bg, generator=gen, device=cuda)
                        * 0.5).to(torch.bfloat16),
                  "z": torch.rand(DEPTH, cfg.batch * cfg.gh, cfg.nb_features, generator=gen,
                                  device=cuda) + 0.5}
            shape = (DEPTH, cfg.ring_size, cfg.bl)
            if rq:
                for k in ("ck", "cv"):
                    st[k] = torch.randint(-127, 128, shape, generator=gen, device=cuda,
                                          dtype=torch.int8)
                    st[k + "_s"] = torch.rand(DEPTH, cfg.ring_size, cfg.batch * cfg.local_heads,
                                              generator=gen, device=cuda) * 0.015 + 0.005
            else:
                for k in ("ck", "cv"):
                    st[k] = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
            h = torch.randn(cfg.batch, cfg.dim, generator=gen, device=cuda)
            full = {k: v.clone() for k, v in st.items()}
            hf, _, kf, vf = tfd.fused_decode_step(params, full, h, t, cfg)
            x = h
            for i, p in enumerate(layers):
                sk = {k: v[i:i + 1].clone() for k, v in st.items()}
                sr = {k: v.clone() for k, v in sk.items()}
                hk, _, kk, vk = tfd.fused_decode_step(p, sk, x, t, one)
                hr, _, kr, vr = tfd.fused_decode_step_ref(p, sr, x, t, one)
                for name, a, b in (("h", hk, hr), ("k", kk, kr), ("v", vk, vr),
                                   ("z", sk["z"], sr["z"]), ("S", sk["S"], sr["S"])):
                    _fused_close(f"{wide} {wq} rq={rq} layer {i} {name} t={t}", a, b)
                assert torch.equal(kf[i], kk[0]) and torch.equal(full["S"][i], sk["S"][0])
                x = hk
            assert torch.equal(hf, x), f"{wide} t={t}: whole depth differs from the chain"


@pytest.mark.gpu
def test_fused_decode_launches_per_step(cuda):
    """One step makes 5·L + 1 kernel launches (torch.profiler's kernel
    count for one call, t on the device already)."""
    from torch.profiler import ProfilerActivity, profile

    model = _model(False, cuda)
    cfg = _fused_cfg(ring_quant=True)
    params = tfd.strip_reference_weights(tfd.pack_fused_params(model))
    st, h = _state(cfg, 3, cuda)
    t = torch.tensor(5, device=cuda)
    tfd.fused_decode_step(params, st, h, t, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tfd.fused_decode_step(params, st, h, t, cfg)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [n for n in names if any(k in n for k in ("gemv_kernel", "attention_kernel",
                                                     "step_begin_kernel"))]
    assert len(ours) == 5 * DEPTH + 1, names
    assert len(names) == len(ours), names


@pytest.mark.gpu
@pytest.mark.parametrize("ring_quant", [False, True], ids=["bf16rings", "int8rings"])
def test_fused_stepper_graph_matches_eager(cuda, ring_quant):
    """The fused stepper's graph replays equal eager stepping bit for bit
    over 140 tokens, past the ring's wrap at its 128 slots (window 12),
    and each token counts one step.  Eager stepping is the step's parts
    called directly at an int t: embedding, positional row,
    ``fused_decode_step``, ``update_rings``, final LayerNorm and head."""
    from synthanatomy_tpu_torch.models.sampling import (
        _config,
        combined_position_table,
        fused_logits_stepper,
    )

    n = 140
    model = _model(True, cuda, max_seq_len=n)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, VOCAB - 1, (B, n)), device=cuda)
    with torch.no_grad():
        before = tfd.fused_decode_step.launches
        step = fused_logits_stepper(model, batch=B, ring_quant=ring_quant)
        got = torch.stack([step(tokens[:, t], t) for t in range(n)], dim=1)
        torch.cuda.synchronize()
        assert tfd.fused_decode_step.launches == before + n

        cfg = _config(model, B, ring_quant, "int8")
        assert cfg.ring_size == 128 and not model.tie_embed
        params = tfd.strip_reference_weights(tfd.pack_fused_params(model))
        state = tfd.init_fused_state(cfg, device=cuda)
        emb = model.token_emb.weight.to(torch.bfloat16)
        pos = combined_position_table(model, n)
        fn_s, fn_b = model.final_norm.weight.float(), model.final_norm.bias.float()
        head_w = model.to_out.weight.T.to(torch.bfloat16).float()
        head_b = model.to_out.bias.float()
        want = []
        for t in range(n):
            x = emb[tokens[:, t]].float() + pos[t]
            h, _, k_all, v_all = tfd.fused_decode_step(params, state, x, t, cfg)
            tfd.update_rings(state, k_all, v_all, t, cfg)
            mu = h.mean(-1, keepdim=True)
            var = (h - mu).square().mean(-1, keepdim=True)
            hn = (h - mu) * torch.rsqrt(var + 1e-6) * fn_s + fn_b
            want.append(hn.to(torch.bfloat16).float() @ head_w + head_b)
        want = torch.stack(want, dim=1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_fused_routing_agrees_with_the_launch(cuda):
    """On the card the gate asks the kernel library's plan: a prior whose
    FAVOR slice passes a block's shared memory (m 1024 at dh 128) is
    refused by ``supports_fused_decode`` and by the step alike (before any
    launch), and the small prior passes both."""
    big = Performer(VOCAB, 64, 256, 1, 2, 128, 1, WIN, nb_features=1024,
                    generator=torch.Generator().manual_seed(0)).to(cuda)
    assert not tfd.supports_fused_decode(big)
    cfg = tfd.FusedDecodeConfig(depth=1, batch=B, dim=256, heads=2, dim_head=128,
                                local_heads=1, local_window=WIN, nb_features=1024)
    params = tfd.strip_reference_weights(tfd.pack_fused_params(big))
    st = tfd.init_fused_state(cfg, device=cuda)
    before = tfd.fused_decode_step.launches
    with pytest.raises(ValueError, match="shared memory"):
        tfd.fused_decode_step(params, st, torch.zeros(B, 256, device=cuda), 0, cfg)
    assert tfd.fused_decode_step.launches == before
    assert tfd.supports_fused_decode(_model(False, cuda))


@pytest.mark.gpu
def test_fused_decode_kernel_rejects_bad_inputs(cuda):
    model = _model(False, cuda)
    cfg = tfd.FusedDecodeConfig(
        depth=DEPTH, batch=B, dim=DIM, heads=HEADS, dim_head=DH, local_heads=LH,
        local_window=WIN, nb_features=M)
    params = tfd.strip_reference_weights(tfd.pack_fused_params(model))
    st, h = _state(cfg, 0, cuda)
    with pytest.raises(TypeError):
        tfd.fused_decode_step(params, dict(st, S=st["S"].float()), h, 0, cfg)
    with pytest.raises(ValueError):
        tfd.fused_decode_step(params, st, h[:, ::2], 0, cfg)
    with pytest.raises(ValueError):
        tfd.fused_decode_step(params, dict(st, z=st["z"].cpu()), h, 0, cfg)


# ---------------------------------------------------------------------------
# training kernels: FAVOR+ (forward, dq and dk/dv sweeps) and banded local
# attention (forward, dq, dk/dv), each against its plain twin
# ---------------------------------------------------------------------------


def _fwd_bwd(fn, q, k, v, g):
    """fn's output and d(Σ out·g)/d(q, k, v) on fresh leaves."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, g.to(out.dtype))
    return [out.detach()] + list(grads)


def _assert_kernel_close(name, a, b, dtype, scale=None):
    """Same rounding points, other summation orders: at f32 the results
    agree to ~1e-6 relative; at bf16 an operand on a rounding boundary
    may round the other way (2^-8 of it) and move a few results by up to
    ~1e-2 of the largest, while the norm-relative error stays ~1e-3.  A
    wrong index or mask gives errors of order 1.  The tolerances are
    relative to ``scale`` (default: b itself)."""
    a, b = a.float(), b.float()
    ref = b if scale is None else scale.float()
    tol_max, tol_norm = (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 1e-2)
    err = float((a - b).abs().max())
    assert err <= tol_max * float(ref.abs().max()), f"{name}: max abs err {err}"
    assert float(torch.linalg.norm(a - b)) <= tol_norm * float(torch.linalg.norm(ref)), name


def _inputs(shape, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = (torch.randn(*shape, generator=gen, device=device) for _ in range(4))
    return q.to(dtype), k.to(dtype), (v * 0.5).to(dtype), g


FAVOR_SHAPES = [  # (B, H, L, d, m, chunk, dtype)
    (1, 2, 37, 16, 32, 16, torch.float32),   # L not a multiple of the chunk
    (2, 3, 300, 64, 256, 128, torch.bfloat16),
    (1, 2, 100, 64, 128, 64, torch.float32),
    (6, 8, 1400, 64, 256, 128, torch.bfloat16),  # the paper shape
    (6, 8, 1401, 64, 256, 128, torch.bfloat16),  # the bench's length: a last chunk of 121
    (8, 2, 1400, 64, 128, 128, torch.bfloat16),  # the validation prior's m
    (1, 2, 100, 64, 256, 128, torch.bfloat16),   # L < chunk
    (1, 2, 70, 128, 64, 32, torch.float32),      # d above 64: the earlier kernels
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FAVOR_SHAPES, ids=lambda s: "x".join(map(str, s[:6])))
def test_favor_kernel_matches_plain(cuda, shape):
    b, h, n, d, m, chunk, dtype = shape
    q, k, v, g = _inputs((b, h, n, d), dtype, cuda, seed=n)
    proj = gaussian_orthogonal_random_matrix(
        m, d, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = tfa.favor_attention_fused.launches
    got = _fwd_bwd(lambda *x: tfa.favor_attention_fused(*x, proj, chunk), q, k, v, g)
    torch.cuda.synchronize()
    assert tfa.favor_attention_fused.launches == before + tfa.launches_per_call(q, proj, chunk)
    assert tfa.launches_per_call(q, proj, chunk) == (7 if d <= 64 else 3)
    want = _fwd_bwd(lambda *x: tfa.favor_attention_fused_plain(*x, proj, chunk), q, k, v, g)
    for name, a, b_ in zip(("out", "dq", "dk", "dv"), got, want):
        _assert_kernel_close(f"favor {shape} {name}", a, b_, dtype)
    again = _fwd_bwd(lambda *x: tfa.favor_attention_fused(*x, proj, chunk), q, k, v, g)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), "not deterministic"


def favor_tie_inputs(b, h, n, d, m, seed, device):
    """Inputs whose every product is exact, so the kernel and the plain
    version see the same U = rnd(q·dn)·rnd(P)ᵀ bit for bit: d 16 (dn =
    1/2), q, k, v, g and P small integers times powers of two.  Projection
    rows 0 and 1 are equal and the longest, and every query points along
    them, so each row's max over features is a tie of features 0 and 1."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-2, 3, size=(m, d)).astype(np.float32) * 0.25
    p[0] = p[1] = 1.0
    q = (0.25 * (4.0 + rng.integers(0, 3, size=(b, h, n, 1)))
         + 0.125 * rng.integers(-1, 2, size=(b, h, n, d)))
    k, v, g = (s * rng.integers(-3, 4, size=(b, h, n, d)) for s in (0.125, 0.25, 0.25))
    t = [torch.tensor(x, dtype=torch.float32, device=device).to(torch.bfloat16) for x in (q, k, v)]
    return (*t, torch.tensor(g, dtype=torch.float32, device=device),
            torch.tensor(p, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("n,m,chunk", [(100, 32, 16), (150, 64, 128), (300, 256, 128)])
def test_favor_kernel_row_max_ties(cuda, n, m, chunk):
    """bf16 with exact row-max ties (features 0 and 1 of every query): the
    kernel splits the max's cotangent over both, as the plain version does;
    the inputs make both find the same ties."""
    q, k, v, g, proj = favor_tie_inputs(2, 2, n, 16, m, n + m, cuda)
    u = (q.float() * 0.5).to(torch.bfloat16).float() @ proj.to(torch.bfloat16).float().T
    assert (u[..., 0] == u[..., 1]).all() and (u.argmax(-1) <= 1).all()
    got = _fwd_bwd(lambda *x: tfa.favor_attention_fused(*x, proj, chunk), q, k, v, g)
    want = _fwd_bwd(lambda *x: tfa.favor_attention_fused_plain(*x, proj, chunk), q, k, v, g)
    for name, a, b_ in zip(("out", "dq", "dk", "dv"), got, want):
        _assert_kernel_close(f"favor ties n {n} m {m} {name}", a, b_, torch.bfloat16)


LOCAL_SHAPES = [  # (B, H, L, d, window, dtype)
    (1, 2, 37, 16, 12, torch.float32),
    (1, 2, 20, 16, 40, torch.bfloat16),    # L < w
    (2, 2, 100, 64, 45, torch.bfloat16),   # w not a multiple of the block
    (1, 3, 70, 32, 1, torch.float32),      # the diagonal alone
    (6, 8, 1400, 64, 420, torch.bfloat16),  # the paper shape
    # the tile walk's awkward shapes: L one off a multiple of the 64-row
    # tile, w 1, 64 and 65 (the lower edge on and one past a tile
    # boundary), w ≥ L, and d 16, 32, 128 (and 48, 100: zero-padded in the
    # staged tiles; 100 bf16 rows are not 16-byte multiples)
    (1, 2, 127, 16, 64, torch.bfloat16),
    (1, 2, 129, 32, 65, torch.bfloat16),
    (2, 2, 191, 128, 1, torch.bfloat16),
    (1, 2, 193, 128, 300, torch.float32),   # w ≥ L
    (1, 3, 65, 64, 64, torch.float32),
    (1, 2, 129, 32, 1000, torch.bfloat16),  # w ≥ L, past the earlier kernel's bound
    (1, 2, 63, 16, 65, torch.float32),
    (1, 2, 255, 100, 65, torch.bfloat16),
    (1, 2, 200, 48, 77, torch.float32),
    (1, 1, 100, 200, 37, torch.bfloat16),   # d > 128: the band form
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LOCAL_SHAPES, ids=lambda s: "x".join(map(str, s[:5])))
def test_local_kernel_matches_plain(cuda, shape):
    b, h, n, d, w, dtype = shape
    q, k, v, g = _inputs((b, h, n, d), dtype, cuda, seed=n + w)
    before = tlf.local_attention_flash.launches
    got = _fwd_bwd(lambda *x: tlf.local_attention_flash_core(*x, w), q, k, v, g)
    torch.cuda.synchronize()
    assert tlf.local_attention_flash.launches == before + 3
    want = _fwd_bwd(lambda *x: tlf.local_attention_flash_plain(*x, w), q, k, v, g)
    for name, a, b_ in zip(("out", "dq", "dk", "dv"), got, want):
        _assert_kernel_close(f"local {shape} {name}", a, b_, dtype)
    again = _fwd_bwd(lambda *x: tlf.local_attention_flash_core(*x, w), q, k, v, g)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), "not deterministic"


@pytest.mark.gpu
def test_attention_kernels_reject_bad_inputs(cuda):
    q = torch.zeros(1, 2, 16, 16, device=cuda)
    proj = torch.zeros(32, 16, device=cuda)
    with pytest.raises(TypeError):
        tfa.favor_attention_fused(q.half(), q.half(), q.half(), proj)
    with pytest.raises(ValueError):
        tfa.favor_attention_fused(q, q[:, :1], q, proj)
    with pytest.raises(ValueError):
        tfa.favor_attention_fused(q, q, q, proj[:, :8])
    with pytest.raises(ValueError):  # S of 1024 x 128 f32 does not fit shared memory
        big = torch.zeros(1, 1, 8, 128, device=cuda)
        tfa.favor_attention_fused(big, big, big, torch.zeros(1024, 128, device=cuda))
    with pytest.raises(TypeError):
        tlf.local_attention_flash_core(q.half(), q.half(), q.half(), 4)
    with pytest.raises(ValueError):
        tlf.local_attention_flash_core(q, q.cpu(), q, 4)
    with pytest.raises(ValueError):  # d > 128 takes the band form: its band does not fit
        wide = torch.zeros(1, 1, 16, 256, device=cuda)
        tlf.local_attention_flash_core(wide, wide, wide, 4000)


@pytest.mark.gpu
@pytest.mark.parametrize("small,w", [((2, 3, 300, 64), 100), ((1, 2, 129, 32), 65),
                                     ((1, 5, 63, 16), 200)],
                         ids=["2x3x300x64", "1x2x129x32", "1x5x63x16"])
def test_kernel_body_variants_match_plain(cuda, monkeypatch, small, w):
    """Every ablated body of rows 5 and 6 (ops/kernel_body.py) against its
    plain twin at the probe's small shape and at tile-walk edges (L one off
    a tile, w 65, w ≥ L, d 16 and 32), in bf16 and f32, at 1 and 4 heads per
    block (check_small raises on a mismatch; tolerance 2e-2 of max |plain|
    in bf16, 1e-4 in f32)."""
    monkeypatch.setattr(pkb, "SMALL", small)
    monkeypatch.setattr(pkb, "SMALL_W", w)
    before = (tkb.local_fwd_body.launches, tkb.local_bwd_body.launches,
              tkb.favor_fwd_body.launches, tkb.favor_bwd_body.launches)
    assert pkb.check_small(cuda) <= 2e-2
    torch.cuda.synchronize()
    after = (tkb.local_fwd_body.launches, tkb.local_bwd_body.launches,
             tkb.favor_fwd_body.launches, tkb.favor_bwd_body.launches)
    assert all(a > b_ for a, b_ in zip(after, before))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,w,m,chunk", [((2, 3, 300, 64), 100, 64, 128),
                                             ((1, 2, 37, 16), 12, 16, 16)],
                         ids=["2x3x300x64", "1x2x37x16"])
def test_kernel_body_production_bodies_are_bit_equal(cuda, monkeypatch, shape, w, m, chunk):
    """The local forward's foldscale, the local backward's full (bf16
    outputs, and f32 outputs rounded) and FAVOR's full equal the
    production kernels bit for bit (check_production raises otherwise)."""
    monkeypatch.setattr(pkb, "W", w)
    monkeypatch.setattr(pkb, "CHUNK", chunk)
    q, k, v, g = _inputs(shape, torch.bfloat16, cuda, seed=shape[2])
    proj = gaussian_orthogonal_random_matrix(
        m, shape[-1], generator=torch.Generator().manual_seed(1)).to(cuda)
    pkb.check_production(q, k, v, g.to(torch.bfloat16), proj)


@pytest.mark.gpu
def test_idfeat_dq_miss_is_a_ds_rounding_flip(cuda):
    """The evidence behind the bound of the bf16 identity-features dq
    case (tools/probe_kernel_body.idfeat_dq_bound), at the shape where it
    showed (1 x 2 x 129 x 32). Every k16 step of the card's mma.sync on
    the plain twin's operands stays within the bound's allowance of its
    Σ|terms|. Where the kernel's worst element leaves the plain twin by
    more than 2e-2 of max |plain|, the miss must be a ds rounding flip:
    the dq_p product rebuilt on the card from the plain's operands gives
    the plain's dq, ds = rnd(dnum)·vᵀ + gd summed on the card rounds that
    element's key to bf16 the other way, with that ds the plain's tail
    gives the kernel's dq, and the miss stays within the bound. A kernel
    whose sums no longer flip passes without that explanation."""
    r = pkb.dq_cancellation(cuda, (1, 2, 129, 32))
    assert r["step_miss_of_sum_abs_terms"] <= pkb.MMA_SUM_MISS / 4
    miss = abs(r["kernel"] - r["plain"])
    if miss <= 2e-2 * r["max_abs_plain"]:
        return
    assert abs(r["dq_from_card_mma"] - r["plain"]) < 1e-2 * miss
    assert r["ds_flips"] and r["ds_flips"][0][0] == r["worst"][1]
    assert abs(r["dq_from_card_ds"] - r["kernel"]) < 1e-2 * miss
    assert r["excess_over_bound_max"] <= 1e-3 * miss


@pytest.mark.gpu
def test_mma_steps_sum_each_step_near_exactly(cuda):
    """The diagnostic kernel's chained mma.sync steps against exactly
    rounded steps on random bf16 operands: each within the bound's
    per-step allowance of its Σ|terms|."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(16, 64, generator=gen).to(torch.bfloat16)
    bt = torch.randn(8, 64, generator=gen).to(torch.bfloat16)
    c = torch.randn(16, 8, generator=gen)
    before = tkb.mma_steps.launches
    got = tkb.mma_steps(a.to(cuda), bt.to(cuda), c.to(cuda)).cpu()
    assert tkb.mma_steps.launches == before + 1
    prev = c.double()
    for s in range(4):
        terms = a.double()[:, None, 16 * s:16 * s + 16] * bt.double()[None, :, 16 * s:16 * s + 16]
        want = (prev + terms.sum(-1)).float()
        total = terms.abs().sum(-1) + prev.abs()
        assert float(((got[s].double() - want.double()).abs() / total).max()) \
            <= pkb.MMA_SUM_MISS / 4
        prev = got[s].double()


@pytest.mark.gpu
def test_kernel_body_refuses_what_does_not_fit(cuda):
    q = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16, device=cuda)
    wide = torch.zeros(1, 1, 64, 128, dtype=torch.bfloat16, device=cuda)
    before = (tkb.local_fwd_body.launches, tkb.local_bwd_body.launches)
    with pytest.raises(ValueError):  # the local bodies are built for d ≤ 64
        tkb.local_fwd_body(wide, wide, wide, 4)
    with pytest.raises(ValueError):
        tkb.local_bwd_body(wide, wide, wide, wide, 4)
    assert (tkb.local_fwd_body.launches, tkb.local_bwd_body.launches) == before
    with pytest.raises(tkb.DoesNotFit) as err:  # S of 1024 x 64 f32
        tkb.favor_fwd_body(q, q, q, torch.zeros(1024, 64, device=cuda))
    assert err.value.nbytes > 232448
    with pytest.raises(ValueError):
        tkb.local_fwd_body(q, q, q, 4, body="nosuch")
    with pytest.raises(ValueError):
        tkb.local_bwd_body(q, q, q, q.float(), 4)


SPLASH_SHAPES = [  # (B, H, L, window, block, dtype)
    (1, 2, 130, 17, 128, torch.float32),   # padded tail
    (2, 2, 300, 37, 128, torch.bfloat16),
    (1, 2, 50, 100, 128, torch.bfloat16),  # L < w
    (1, 3, 200, 1, 128, torch.float32),    # the diagonal alone
    (1, 2, 300, 128, 128, torch.bfloat16),  # w a multiple of the kernel's tile
    (6, 8, 1401, 420, 256, torch.bfloat16),  # the paper shape
    (6, 8, 1401, 420, 128, torch.float32),
    # the tile walk's awkward shapes: w 1 in bf16, L one off a multiple of
    # the 64-row tile, w 2, 64 and 65, w ≥ L, in bf16 and f32
    (1, 3, 200, 1, 128, torch.bfloat16),
    (1, 2, 127, 64, 128, torch.bfloat16),
    (1, 2, 129, 65, 128, torch.float32),
    (1, 2, 191, 2, 128, torch.bfloat16),
    (1, 2, 193, 400, 128, torch.bfloat16),
    (2, 2, 255, 65, 128, torch.bfloat16),
    (1, 3, 65, 64, 128, torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("shape", SPLASH_SHAPES, ids=lambda s: "x".join(map(str, s[:5])))
def test_splash_kernel_matches_plain(cuda, shape, fused):
    """o, lse, dq, dk, dv of the splash kernels against the plain version on
    the same padded inputs; every block visits exactly its tiles of the
    map; two runs are bit-identical."""
    b, h, n, w, block, dtype = shape
    n_pad = -(-n // block) * block
    q, k, v, g = _inputs((b, h, n_pad, 64), dtype, cuda, seed=n + w)
    q = (q.float() * 0.125).to(dtype)
    before = tsp.local_attention_splash.launches
    got = _fwd_bwd(lambda *x: tsp.splash_attention_core(*x, w, block, block, fused), q, k, v, g)
    torch.cuda.synchronize()
    assert tsp.local_attention_splash.launches == before + 3
    want = _fwd_bwd(lambda *x: tsp.splash_attention_plain(*x, w, block, block, fused), q, k, v, g)
    for name, a, b_ in zip(("out", "dq", "dk", "dv"), got, want):
        # at w 1 in bf16, p = 1 and o = v: dq and dk are rnd((dp − di)·p),
        # the cancellation of two equal sums (~1e-6 where dv is ~1), so
        # both sides are rounding noise; they are held to dv's scale, where
        # a wrong tile or mask still gives errors of order 1
        scale = want[3] if w == 1 and dtype == torch.bfloat16 and name in ("dq", "dk") else None
        _assert_kernel_close(f"splash {shape} {name}", a, b_, dtype, scale)
    visits = torch.zeros(b * h, n_pad // tsp.KERNEL_TILE, dtype=torch.int32, device=cuda)
    _, lse = tsp._kernel_fwd(q, k, v, w, visits=visits)
    _, lse_plain = tsp.splash_fwd_plain(q, k, v, w, block, block)
    torch.testing.assert_close(lse, lse_plain, rtol=0, atol=1e-4)
    nnz = tsp._device_map(n_pad, w, q.device)[2]
    assert int(visits.sum()) == nnz * b * h
    again = _fwd_bwd(lambda *x: tsp.splash_attention_core(*x, w, block, block, fused), q, k, v, g)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), "not deterministic"


@pytest.mark.gpu
def test_splash_kernel_rejects_bad_inputs(cuda):
    q = torch.zeros(1, 2, 128, 64, device=cuda)
    with pytest.raises(TypeError):
        tsp.splash_attention_core(q.half(), q.half(), q.half(), 4)
    with pytest.raises(ValueError):  # the kernel is built for head dim 64
        x = torch.zeros(1, 2, 128, 32, device=cuda)
        tsp.splash_attention_core(x, x, x, 4)
    with pytest.raises(ValueError):  # not a whole number of tiles
        tsp.splash_attention_core(q[:, :, :100], q[:, :, :100], q[:, :, :100], 4)
    with pytest.raises(ValueError):
        tsp.splash_attention_core(q, q.cpu(), q, 4)
    with pytest.raises(ValueError):
        tsp.splash_attention_core(q, q, q, 0)


VQ_SHAPES = [(37, 130, 5), (1000, 300, 64), (4099, 2047, 32), (4200, 2048, 32)]  # (N, K, D)
# one row and one code; N and K one past a tile; rows wider than 64 (x's
# fragments read per product); a codebook of 16384
VQ_EDGE_SHAPES = [(1, 1, 1), (129, 9, 17), (300, 100, 65), (130, 64, 256), (5000, 16384, 24)]


def _check_vq(cuda, shape):
    """Indices equal the plain argmin except on near-ties (distances within
    1e-5 of their scale, in f64); counts exact; sums of x within f32
    summation error; two runs bit-identical."""
    n, k, d = shape
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    x = torch.randn(n, d, generator=gen, device=cuda)
    w = torch.randn(k, d, generator=gen, device=cuda)
    before = tvq.nearest_codeword.launches
    idx = tvq.nearest_codeword(x, w)
    assert tvq.nearest_codeword.launches == before + 1 and idx.dtype == torch.int32
    ref = tvq.nearest_codeword_plain(x, w)
    rows = torch.nonzero(idx != ref).flatten()
    if rows.numel():
        dist = (w.double() ** 2).sum(1)[None] - 2 * x[rows].double() @ w.double().t()
        gap = (dist.gather(1, idx[rows].long()[:, None])
               - dist.gather(1, ref[rows].long()[:, None])).abs().max()
        assert float(gap) <= 1e-5 * float(dist.abs().max())
    sidx, counts, dw = tvq.nearest_codeword_stats(x, w)
    assert torch.equal(sidx, idx)
    assert torch.equal(counts, torch.bincount(idx.long(), minlength=k).float())
    onehot = torch.nn.functional.one_hot(idx.long(), k).float()
    _assert_kernel_close(f"vq {shape} sum x", dw, onehot.t() @ x, torch.float32)
    again = tvq.nearest_codeword_stats(x, w)
    assert all(torch.equal(a, b_) for a, b_ in zip((sidx, counts, dw), again))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", VQ_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vq_kernels_match_plain(cuda, shape):
    """Indices equal the plain argmin except on near-ties (distances within
    1e-5 of their scale, in f64); counts exact; sums of x within f32
    summation error; two runs bit-identical."""
    _check_vq(cuda, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", VQ_EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_vq_kernels_match_plain_at_edge_shapes(cuda, shape):
    """The same rules at one row and one code, ragged tiles, rows wider
    than 64 and a codebook of 16384."""
    _check_vq(cuda, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["halves", "neighbours"])
def test_vq_kernel_ties_go_to_the_lower_index(cuda, layout):
    """Every codeword twice, at i and i + K/2 (the same place in two
    splits of a cluster) or at 2i and 2i + 1 (one lane's two columns):
    the two distances are the same bits, and the lower index wins every
    row, as torch.argmin breaks ties."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    half = torch.randn(1024, 32, generator=gen, device=cuda)
    x = torch.randn(4200, 32, generator=gen, device=cuda)
    if layout == "halves":
        w, low = torch.cat([half, half]), lambda i: i < 1024
    else:
        w, low = half.repeat_interleave(2, dim=0), lambda i: i % 2 == 0
    idx = tvq.nearest_codeword(x, w)
    assert bool(low(idx).all()), f"{int((~low(idx)).sum())} rows took the higher index"
    sidx, counts, _ = tvq.nearest_codeword_stats(x, w)
    assert torch.equal(sidx, idx) and float(counts[~low(torch.arange(2048, device=cuda))].sum()) == 0


RES_SHAPES = [  # (B, C, D, H, W, R, dtype)
    (1, 3, 5, 6, 7, 4, torch.float32),
    (2, 8, 9, 10, 11, 12, torch.bfloat16),  # R 12: the GEMM route
    (1, 24, 7, 9, 70, 40, torch.bfloat16),  # the tile route, ragged tiles and chunks
    (1, 16, 6, 7, 33, 32, torch.float32),
    (1, 64, 5, 6, 11, 128, torch.bfloat16),  # the tile route, C != R
    (1, 136, 4, 5, 6, 64, torch.bfloat16),  # C 136: the GEMM route
    (2, 128, 9, 10, 11, 64, torch.bfloat16),  # the tile route, B2, C > R
    (3, 128, 9, 10, 17, 128, torch.bfloat16),  # the tile route, dW1 chunks across volumes
    (1, 128, 80, 112, 80, 128, torch.bfloat16),  # the paper shape
]
RES_FORMATS = {"ncdhw": torch.contiguous_format, "ndhwc": torch.channels_last_3d}


def _tile_route_expected(c, r, dtype):
    """csrc/res_plan.h: bf16 with C and R multiples of 8 up to 128."""
    return dtype == torch.bfloat16 and all(8 <= n <= 128 and n % 8 == 0 for n in (c, r))


def _res_case(shape, cuda, fmt):
    *xs, r, dtype = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(xs) + r)
    c = xs[1]
    x = torch.randn(*xs, generator=gen, device=cuda).to(dtype)
    w1 = (torch.randn(r, c, 3, 3, 3, generator=gen, device=cuda) * (27 * c) ** -0.5).to(dtype)
    b1 = (torch.randn(r, generator=gen, device=cuda) * 0.1).to(dtype)
    w2 = (torch.randn(c, r, 1, 1, 1, generator=gen, device=cuda) * r ** -0.5).to(dtype)
    b2 = (torch.randn(c, generator=gen, device=cuda) * 0.1).to(dtype)
    gy = torch.randn(*xs, generator=gen, device=cuda).to(dtype)
    fmt = RES_FORMATS[fmt]
    return (x.contiguous(memory_format=fmt), w1, b1, w2, b2,
            gy.contiguous(memory_format=fmt))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", list(RES_FORMATS))
@pytest.mark.parametrize("shape", RES_SHAPES, ids=lambda s: "x".join(map(str, s[:6])))
def test_residual_kernels_match_plain(cuda, shape, fmt):
    """The forward on the same inputs; the backward on the same saved x,
    h, y and gy; two backward runs bit-identical; in either memory format
    of x (the kernels convert what is not in their layout)."""
    x, w1, b1, w2, b2, gy = _res_case(shape, cuda, fmt)
    dtype = x.dtype
    before = trs.fused_residual_layer.launches
    _, yk, hk = trs._kernel_fwd(x, w1, b1, w2, b2, True)
    assert trs.fused_residual_layer.launches == before + 1
    yp, hp = trs.residual_layer_plain(x, w1, b1, w2, b2)
    _assert_kernel_close(f"res {shape} y", yk, yp, dtype)
    _assert_kernel_close(f"res {shape} h", hk, hp, dtype)
    got = trs._kernel_bwd(x, hp, yp, gy, w1, w2)
    want = trs.residual_layer_bwd_plain(x, hp, yp, gy, w1, w2)
    for name, a, b_ in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        _assert_kernel_close(f"res {shape} {name}", a, b_, dtype)
    again = trs._kernel_bwd(x, hp, yp, gy, w1, w2)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), "not deterministic"


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", list(RES_FORMATS))
@pytest.mark.parametrize("shape", RES_SHAPES[:-1], ids=lambda s: "x".join(map(str, s[:6])))
def test_residual_route_and_memory_format(cuda, shape, fmt):
    """The library takes the tile route exactly where the plan says
    (bf16, C and R multiples of 8 up to 128), and reads its layout
    (channels-last there, NCDHW on the GEMM route); through autograd, y
    and dx come back in x's memory format."""
    x, w1, b1, w2, b2, gy = _res_case(shape, cuda, fmt)
    c, r = x.shape[1], w1.shape[0]
    tile = _tile_route_expected(c, r, x.dtype)
    assert trs._tile_route(c, r, x.dtype) == tile
    want = torch.channels_last_3d if tile else torch.contiguous_format
    assert trs.kernel_layout(x, r).is_contiguous(memory_format=want)
    leaves = [t.detach().clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    y = trs.fused_residual_layer(*leaves)
    (dx,) = torch.autograd.grad(y, leaves[:1], gy)
    for t in (y, dx):
        assert t.is_contiguous(memory_format=RES_FORMATS[fmt])


@pytest.mark.gpu
def test_autograd_through_residual_kernel(cuda):
    """fused_residual_layer on the card: autograd reaches the backward
    kernel and agrees with the plain route."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    args = [torch.randn(2, 6, 5, 7, 9, generator=gen, device=cuda),
            torch.randn(5, 6, 3, 3, 3, generator=gen, device=cuda) * 0.1,
            torch.randn(5, generator=gen, device=cuda) * 0.1,
            torch.randn(6, 5, 1, 1, 1, generator=gen, device=cuda) * 0.3,
            torch.randn(6, generator=gen, device=cuda) * 0.1]
    outs = []
    for fn in (trs.fused_residual_layer, trs.fused_residual_layer_plain):
        leaves = [a.clone().requires_grad_() for a in args]
        y = fn(*leaves)
        outs.append([y] + list(torch.autograd.grad(y.square().sum(), leaves)))
    for a, b_ in zip(*outs):
        _assert_kernel_close("res autograd", a, b_, torch.float32)


@pytest.mark.gpu
def test_stage1_kernels_reject_bad_inputs(cuda):
    x = torch.zeros(8, 4, device=cuda)
    with pytest.raises(ValueError):
        tvq.nearest_codeword(x, torch.zeros(16, 5, device=cuda))
    with pytest.raises(TypeError):
        tvq.nearest_codeword(x, torch.zeros(16, 4, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):  # rows wider than the kernel takes
        tvq.nearest_codeword(torch.zeros(8, 300, device=cuda), torch.zeros(4, 300, device=cuda))
    v = torch.zeros(1, 4, 3, 3, 3, device=cuda)
    w1, b1 = torch.zeros(5, 4, 3, 3, 3, device=cuda), torch.zeros(5, device=cuda)
    w2, b2 = torch.zeros(4, 5, 1, 1, 1, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(TypeError):
        trs.fused_residual_layer(v.half(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        trs.fused_residual_layer(v, w1[:, :3], b1, w2, b2)
    with pytest.raises(ValueError):
        trs.fused_residual_layer(v, w1, b1, w2.cpu(), b2)
    with pytest.raises(ValueError):  # R above the kernel's shared-memory h tile
        trs.fused_residual_layer(v, torch.zeros(600, 4, 3, 3, 3, device=cuda),
                                 torch.zeros(600, device=cuda),
                                 torch.zeros(4, 600, 1, 1, 1, device=cuda), b2)


# ---------------------------------------------------------------------------
# decode-side weight streaming: int8_matmul (row 2), the packed-int4
# product, the weight-stream chain, the unpack formulations and the
# launch-overhead tile program (rows 9a-9c)
# ---------------------------------------------------------------------------


def _int8_weights(k, n, gen, device):
    w = torch.randn(k, n, generator=gen, device=device)
    return tq.quantize_int8(w)


@pytest.mark.gpu
@pytest.mark.parametrize("r,k,n", [(16, 512, 1024), (16, 2048, 512), (1, 200, 96),
                                   (5, 64, 1000), (33, 128, 256), (7, 30, 17),
                                   (65, 512, 1024), (17, 72, 200)])
def test_int8_matmul_kernel_matches_plain(cuda, r, k, n):
    gen = torch.Generator(device=cuda).manual_seed(r * k + n)
    x = torch.randn(r, k, generator=gen, device=cuda)
    w_q, scale = _int8_weights(k, n, gen, cuda)
    before = tq.int8_matmul.launches
    got = tq.int8_matmul(x, w_q, scale)
    again = tq.int8_matmul(x, w_q, scale)
    want = tq.int8_matmul_plain(x, w_q, scale)
    torch.cuda.synchronize()
    assert tq.int8_matmul.launches == before + 2
    assert torch.equal(got, again)  # fixed summation order
    # exact bf16 products summed in f32 in another order
    _assert_kernel_close("int8_matmul", got, want, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("r,k,n,layers", [(16, 256, 512, 1), (16, 256, 512, 4), (16, 256, 100, 2),
                                          (16, 512, 2048, 1), (1, 512, 1024, 2),
                                          (17, 72, 200, 2), (33, 256, 96, 3), (65, 40, 64, 1)])
def test_int4_matmul_kernel_matches_plain(cuda, r, k, n, layers):
    """The packed product's last layer against the plain twin, also at
    the paper GEMV width, at 1, 17, 33 and 65 rows of x (one to four m16
    tiles, then two row groups), with K/2 not a multiple of the 16-row
    k-step and N not a multiple of 16 (byte loads); one launch a call,
    bit-identical reruns."""
    gen = torch.Generator(device=cuda).manual_seed(r * k + n + layers)
    x = torch.randn(r, k, generator=gen, device=cuda)
    packed, scale = zip(*(tq.quantize_int4_packed(torch.randn(k, n, generator=gen, device=cuda))
                          for _ in range(layers)))
    packed, scale = torch.stack(packed), torch.stack(scale)
    before = tq.int4_matmul.launches
    got = tq.int4_matmul(x, packed, scale)
    again = tq.int4_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert tq.int4_matmul.launches == before + 2
    assert torch.equal(got, again)  # fixed summation order
    _assert_kernel_close("int4_matmul", got, tq.int4_matmul_plain(x, packed[-1], scale[-1]),
                         torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed-int4"])
@pytest.mark.parametrize("b,k,n,layers", [(16, 128, 512, 5), (16, 512, 2048, 3),
                                          (1, 512, 2048, 2), (17, 128, 512, 2),
                                          (33, 128, 512, 2), (16, 72, 144, 2),
                                          (16, 40, 200, 2)],
                         ids=["B16-L5", "paper-L3", "B1", "B17", "B33", "K72", "K40-N200"])
def test_weight_stream_kernel_matches_plain(cuda, packed, b, k, n, layers):
    """The chain against the plain twin, also at the probe's width (B16,
    K512, N2048) at L 3, at B 1, 17 and 33 (one, two and four m16 tiles),
    with K/2 = 36 (packed rows not a multiple of the k-step) and with
    K 40, N 200 (not multiples of 16: byte loads); one launch a call,
    two runs bit-identical."""
    gen = torch.Generator(device=cuda).manual_seed(b * k + n + layers + int(packed))
    x = torch.randn(b, k, generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randint(-128, 128, (layers, k // 2 if packed else k, n), generator=gen,
                      device=cuda).to(torch.int8)
    s = torch.rand(layers, 1, n, generator=gen, device=cuda) * 0.01 + 0.01
    before = tpr.weight_stream.launches
    got = tpr.weight_stream(x, w, s, packed)
    again = tpr.weight_stream(x, w, s, packed)
    torch.cuda.synchronize()
    assert tpr.weight_stream.launches == before + 2
    assert torch.equal(got, again)  # fixed summation order
    _assert_kernel_close("weight_stream", got, tpr.weight_stream_plain(x, w, s, packed),
                         torch.float32)


# layout: (shape, byte offset of the view from a 16-byte boundary, the
# 16-byte pieces of the vector path that its launch must take)
_UNPACK_LAYOUTS = {
    "every-byte": ((16, 16), 0, 0),   # 256 bytes, under a warp's 512: one byte a thread
    "ragged": ((3, 7), 0, 0),         # 21 bytes: one byte a thread
    "tiled": ((64, 16), 0, 64),       # two warps' 512 bytes, n % 4 == 0: vector path only
    "vector-tail": ((33, 17), 0, 32),  # 512 bytes a vector warp, a 49-byte tail, n % 4 == 1
    "unaligned": ((64, 16), 1, 0),    # 1024 bytes one byte past a boundary: one byte a thread
    "aligned-view": ((65, 16), 16, 64),  # 1040 bytes of a view 16 bytes in: vector and tail
}


def _unpack_case(layout, device):
    """Packed bytes that cycle through every byte value, of the layout's
    shape, as a view that starts the layout's offset past a 16-byte
    boundary (``_UNPACK_LAYOUTS``)."""
    shape, offset, _ = _UNPACK_LAYOUTS[layout]
    n = shape[0] * shape[1]
    every = (torch.arange(n, dtype=torch.int32, device=device) % 256).to(torch.uint8)
    buf = torch.zeros(n + 32, dtype=torch.int8, device=device)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset:offset + n].reshape(shape)
    view.copy_(every.view(torch.int8).reshape(shape))
    assert view.is_contiguous() and view.data_ptr() % 16 == offset % 16
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(_UNPACK_LAYOUTS))
@pytest.mark.parametrize("variant", range(4))
def test_int4_unpack_kernel_is_exact(cuda, variant, layout):
    """Every formulation exact on the one-byte path alone, on the 16-byte
    path alone, on both in one launch (a tail after the whole warps, the
    high half's stores 4 bytes each where n % 4 != 0), and on views."""
    packed = _unpack_case(layout, cuda)
    assert tpr.int4_unpack_grid(packed)["pieces"] == _UNPACK_LAYOUTS[layout][2]
    lo, hi = tq.unpack_int4(packed)
    want = torch.cat([lo, hi]).float()
    assert torch.equal(tpr.int4_unpack(packed, variant), want)
    assert torch.equal(tpr.unpack_int4_plain(packed, variant), want)


def _assert_tile_steps_close(cuda, m, k, n, steps):
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=cuda).to(torch.bfloat16)
    got = tpr.tile_steps(x, w, steps).float()
    want = tpr.tile_steps_plain(x, w, steps).float()
    torch.cuda.synchronize()
    # bf16 output: one rounding of f32 sums taken in other orders
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,steps", [(256, 512, 512, 3), (64, 48, 128, 1),
                                         (128, 1024, 256, 5), (64, 16, 64, 2),
                                         (256, 512, 512, 96), (64, 2048, 64, 3),
                                         (64, 176, 64, 4)])
def test_tile_steps_kernel_matches_plain(cuda, m, k, n, steps):
    """Shapes across the K split (K 48 three splits of 16, K 1024 eight of
    128, K 2048 the most K takes: eight of 256) and the cluster (one block
    at 64 x 16 x 64; K 176 six splits of two products, the last of zeros)."""
    _assert_tile_steps_close(cuda, m, k, n, steps)


@pytest.mark.gpu
@pytest.mark.parametrize("products", range(1, 17))
def test_tile_steps_every_split_length(cuda, products):
    """Every split length the kernel is built for (1-16 k16 products, one
    template instance each), launched: 128 tiles leave room for no second
    split, so K = 16 · products is one split of that many."""
    m, k, n = 512, 16 * products, 1024
    plan = tpr.tile_steps_plan(m, k, n)
    assert (plan["cluster"], plan["products"]) == (1, products)
    _assert_tile_steps_close(cuda, m, k, n, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,steps", [(256, 512, 512, 96), (64, 48, 128, 7)])
def test_tile_steps_runs_are_bit_identical(cuda, m, k, n, steps):
    """The splits' sums meet in rank order: two runs are bit-identical;
    and every cluster of the probe's grid is resident at once."""
    gen = torch.Generator(device=cuda).manual_seed(7 * m + k)
    x = torch.randn(m, k, generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device=cuda).to(torch.bfloat16)
    assert torch.equal(tpr.tile_steps(x, w, steps), tpr.tile_steps(x, w, steps))
    plan = tpr.tile_steps_plan(m, k, n)
    assert plan["active_clusters"] * plan["cluster"] >= plan["blocks"]


@pytest.mark.gpu
def test_decode_side_kernels_reject_bad_inputs(cuda):
    x = torch.zeros(4, 32, device=cuda)
    with pytest.raises(TypeError):
        tq.int8_matmul(x, torch.zeros(32, 16, device=cuda), torch.ones(1, 16, device=cuda))
    with pytest.raises(ValueError):
        tq.int8_matmul(x, torch.zeros(32, 16, dtype=torch.int8), torch.ones(1, 16))
    with pytest.raises(ValueError):
        tpr.tile_steps(torch.zeros(60, 32, device=cuda, dtype=torch.bfloat16),
                       torch.zeros(32, 64, device=cuda, dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError):  # N not a multiple of K
        tpr.weight_stream(x, torch.zeros(2, 32, 48, dtype=torch.int8, device=cuda),
                          torch.ones(2, 1, 48, device=cuda))


# ---------------------------------------------------------------------------
# the exact sampler's CUDA graph (models/sampling.exact_logits_stepper)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [{}, dict(rotary_position_emb=True, local_attn_heads=2),
                                   dict(axial_position_emb=True, spatial_position_emb="fixed")],
                         ids=["rezero-spatial", "rotary-all-local", "axial-fixed-spatial"])
def test_exact_stepper_graph_matches_eager(cuda, extra):
    """Steps replayed from the captured graph equal eager ``decode_step``
    on the same tokens (the same kernels, in f32), across a ring wrap."""
    from synthanatomy_tpu_torch.models.ordering import Ordering
    from synthanatomy_tpu_torch.models.sampling import exact_logits_stepper

    grid = (2, 3, 4)
    kw = dict(num_tokens=33, max_seq_len=25, dim=64, depth=2, heads=2, dim_head=32,
              local_attn_heads=1, local_window_size=5, use_rezero=True,
              spatial_position_emb="absolute", spatial_shape=grid,
              ordering=Ordering("raster_scan", 3, grid), dtype=torch.float32,
              generator=torch.Generator().manual_seed(0), device="cpu")
    kw.update(extra)
    model = Performer(**kw).to(cuda)
    with torch.no_grad():
        for blk in model.blocks:
            blk.g_attn.fill_(0.5)
            blk.g_ff.fill_(0.5)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 32, (2, 24)), device=cuda)
    tokens[:, 0] = 32
    with torch.no_grad():
        step = exact_logits_stepper(model, batch=2)
        got = torch.stack([step(tokens[:, t], t) for t in range(24)], dim=1)
        cache = model.init_cache(2)
        want = torch.stack([model.decode_step(tokens[:, t], cache, t)[0] for t in range(24)],
                           dim=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

"""Port sampler (synthanatomy_tpu_torch/models/sampling.py) against the
JAX package's fused sampler, on a small prior of the paper form: ReZero
blocks, learned ('absolute') spatial tables, 'bos_replacement'
conditioning."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.models import sampling as js
from synthanatomy_tpu.models.performer import Performer as JPerformer
from synthanatomy_tpu_torch.interop import performer_from_jax
from synthanatomy_tpu_torch.models import sampling as ts
from synthanatomy_tpu_torch.models.ordering import Ordering
from synthanatomy_tpu_torch.models.performer import Performer as ts_performer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B, DIM, HEADS, DH, LH, WIN, M, DEPTH, VOCAB = 2, 128, 2, 64, 1, 12, 128, 2, 33
GRID = (2, 3, 4)  # 24 tokens: past the 12-token local window
CONDS = (3, 5)


@pytest.fixture(scope="module")
def paper_form():
    ordering = Ordering("raster_scan", 3, GRID)
    seq = int(np.prod(GRID))
    jm = JPerformer(
        num_tokens=VOCAB, max_seq_len=seq + 1, dim=DIM, depth=DEPTH,
        heads=HEADS, dim_head=DH, local_attn_heads=LH, local_window_size=WIN,
        nb_features=M, dtype=jnp.bfloat16, use_rezero=True,
        spatial_position_emb="absolute", spatial_shape=GRID, ordering=ordering,
        conditioning_num_tokens=CONDS, conditioning_type="bos_replacement",
    )
    variables = jax.jit(jm.init)(
        {"params": jax.random.key(0), "favor": jax.random.key(1)},
        jnp.zeros((1, 8), jnp.int32), [jnp.zeros((1,), jnp.int32)] * len(CONDS),
    )
    params = dict(jax.device_get(variables["params"]))
    for i in range(DEPTH):  # ReZero starts at identity: use real gains
        blk = dict(params[f"block_{i}"])
        blk["g_attn"] = np.asarray([0.7], np.float32)
        blk["g_ff"] = np.asarray([0.5], np.float32)
        params[f"block_{i}"] = blk
    variables = {"params": params, "favor": jax.device_get(variables["favor"])}
    tm = performer_from_jax(
        params, variables["favor"], DEPTH, device="cpu", heads=HEADS, dim_head=DH,
        local_attn_heads=LH, local_window_size=WIN, nb_features=M,
        use_rezero=True, spatial_position_emb="absolute", spatial_shape=GRID,
        ordering=ordering, conditioning_num_tokens=CONDS,
        conditioning_type="bos_replacement",
    )
    return ordering, jm, variables, tm


@pytest.mark.parametrize("weight_quant,ring_quant", [("int8", False), ("int4", True)])
def test_greedy_grids_equal_jax_fused(paper_form, weight_quant, ring_quant):
    ordering, jm, variables, tm = paper_form
    conds = [np.asarray([0, 2], np.int32), np.asarray([1, 4], np.int32)]
    jsampler = js.make_sampler(
        jm, ordering, batch=B, do_sample=False, fused=True,
        with_conditionings=True, ring_quant=ring_quant, weight_quant=weight_quant,
    )
    want = np.asarray(jsampler(variables, jax.random.key(0), [jnp.asarray(c) for c in conds]))
    tsampler = ts.make_sampler(
        tm, ordering, batch=B, do_sample=False, with_conditionings=True,
        ring_quant=ring_quant, weight_quant=weight_quant,
    )
    got = tsampler(None, [torch.from_numpy(c) for c in conds])
    assert got.dtype == torch.int32 and got.shape == (B,) + GRID
    np.testing.assert_array_equal(got.numpy(), want)


def test_position_table_matches_jax(paper_form):
    ordering, jm, variables, tm = paper_form
    n = int(np.prod(GRID))
    want = np.asarray(js.combined_position_table(jm, variables, n))
    got = ts.combined_position_table(tm, n)
    # same bf16 lookups and bf16 spatial sums: equal bits
    np.testing.assert_array_equal(got.detach().numpy(), want)


def test_stochastic_sampling_respects_top_k_and_bos(paper_form):
    ordering, _, _, tm = paper_form
    sampler = ts.make_sampler(tm, ordering, batch=B, top_k=3, with_conditionings=True)
    conds = [torch.tensor([0, 1]), torch.tensor([2, 3])]
    g1 = sampler(torch.Generator().manual_seed(0), conds)
    g2 = sampler(torch.Generator().manual_seed(0), conds)
    g3 = sampler(torch.Generator().manual_seed(1), conds)
    torch.testing.assert_close(g1, g2)  # same generator seed, same grid
    assert not torch.equal(g1, g3)
    assert int(g1.min()) >= 0 and int(g1.max()) < VOCAB - 1  # BOS never drawn


def test_top_k_and_greedy_policy_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 17)).astype(np.float32)
    for k in (None, 1, 5):
        np.testing.assert_array_equal(
            ts.top_k_logits(torch.from_numpy(logits), k).numpy(),
            np.asarray(js.top_k_logits(jnp.asarray(logits), k)),
        )
    np.testing.assert_array_equal(
        ts.sample_next_index(torch.from_numpy(logits), sample=False, temperature=0.7).numpy(),
        np.asarray(js.sample_next_index(jnp.asarray(logits), sample=False, temperature=0.7)),
    )


def test_unsupported_configuration_raises():
    """An all-local prior has no FAVOR head for the fused step: "auto"
    samples it through the exact path, ``fused=True`` refuses it, and a
    conditioning passed to a sampler built without them is refused."""
    ordering = Ordering("raster_scan", 3, GRID)
    tm = ts_performer(num_tokens=VOCAB, max_seq_len=int(np.prod(GRID)) + 1, dim=DIM, depth=1,
                      heads=HEADS, dim_head=DH, local_attn_heads=HEADS, local_window_size=WIN,
                      generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="fused"):
        ts.make_sampler(tm, ordering, batch=B, fused=True)
    sampler = ts.make_sampler(tm, ordering, batch=B, do_sample=False)
    assert not sampler.fused
    grid = sampler(None)
    assert grid.shape == (B,) + GRID and int(grid.max()) < VOCAB - 1
    with pytest.raises(ValueError):
        sampler(None, [torch.zeros(B)] * 2)

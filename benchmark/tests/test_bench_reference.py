"""The plain reference against the port at tiny sizes on the CPU, both in
float32 from the same drawn weights: the prior's logits, a train step's
loss, gradients and Adam update, and the decoder's volumes."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from benchmark.harness import program as P
from benchmark.harness import weights as W
from benchmark.reference import prior as ref_prior
from benchmark.reference import train as ref_train
from benchmark.reference import vqvae as ref_vqvae
from benchmark.tests.tiny import TINY_PRIOR, TINY_VQVAE

REPO = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
F32 = dict(compute_dtype="float32", attn_compute_dtype="float32", use_rezero=True,
           position_emb="absolute", spatial_position_emb="absolute",
           ordering_type="raster_scan", feature_redraw_interval=1000, learning_rate=1e-3,
           ff_mult=4, use_pallas_local_attn=True, use_pallas_favor_attn=True)


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "math", "statistics", "typing",
                                           "contextlib", "__future__"), (path.name, n)


@pytest.fixture(scope="module")
def prior():
    cfg = dict(TINY_PRIOR, **F32)
    model, _, shapes = P.build_prior(cfg, 7, CPU)
    return cfg, model, W.draw(shapes, 7, CPU)


def test_prior_logits_match_the_port(prior):
    cfg, model, p = prior
    seq = torch.randint(0, cfg["vocab_size"], (2, 24))
    x = ref_prior.teacher_inputs(seq, cfg["vocab_size"])
    model.eval()
    with torch.no_grad():
        got = model(x).float()
        want = ref_prior.logits(p, cfg, x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_train_steps_match_the_port(prior):
    from synthanatomy_tpu_torch.train.transformer_steps import (
        create_transformer_train_state,
        make_transformer_train_step,
    )

    cfg, _, _ = prior
    model, _, shapes = P.build_prior(cfg, 11, CPU)
    p0 = W.draw(shapes, 11, CPU)
    state = create_transformer_train_state(model, 5, learning_rate=cfg["learning_rate"])
    step = make_transformer_train_step(model)
    feeds = []
    for _ in range(2):
        seq = torch.randint(0, cfg["vocab_size"], (3, 24))
        feeds.append((ref_prior.teacher_inputs(seq, cfg["vocab_size"]), seq))
    losses = []
    for x, y in feeds:
        state, m = step(state, x, y, None, {"lr": cfg["learning_rate"]})
        losses.append(float(m["Loss"]))
    names = [k for k, _ in model.named_parameters()]
    ref = ref_train.train(p0, names, feeds, cfg["learning_rate"],
                          lambda q, x, y: ref_prior.ce_loss(q, cfg, x, y), rows=2)
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for k, prm in model.named_parameters():
        change = float(torch.linalg.vector_norm(prm.detach() - p0[k]))
        assert change == pytest.approx(ref["change"][k], rel=1e-3, abs=1e-7), k


def test_decoder_matches_the_port():
    cfg = dict(TINY_VQVAE, compute_dtype="float32", use_slim_residual=True,
               embedding_init=["normal"], decay=[0.5], commitment_cost=[0.25])
    model, shapes = P.build_vqvae(cfg, 3, CPU)
    p = W.draw(shapes, 3, CPU)
    idx = torch.randint(0, 31, (2, 2, 3, 4))
    with torch.no_grad():
        got = model.decode_samples([idx]).float()
        want = ref_vqvae.decode(p, cfg, idx)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_int8_weights_are_worked_out_as_the_port_packs_them(prior):
    from synthanatomy_tpu_torch.ops.fused_decode import pack_fused_params
    from synthanatomy_tpu_torch.ops.quant import quantize_int8

    cfg, model, p = prior
    packed = pack_fused_params(model, weight_quant="int8")
    q = ref_prior.int8_folded(p, cfg)
    wq, ws = quantize_int8(packed["_wout_f"][0])
    torch.testing.assert_close((wq.float() * ws).T, q["blocks.0.attn.to_out.weight"])
    wq, ws = packed["w1_q"][0], packed["w1_s"][0]
    torch.testing.assert_close((wq.float() * ws).T, q["blocks.0.ff.w1.weight"])

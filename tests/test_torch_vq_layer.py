"""The port's ``models/vq_layer.VectorQuantizerEMA`` against JAX's, on the
EMA state JAX initialised, carried by ``interop.vq_layer_from_jax``, on
the CPU (as ``tests/test_performer.py::test_vq_layer_api``): the
straight-through output and the commitment loss (1e-6), the EMA state
after a training call (1e-6), ``quantize`` (indices and one-hot equal,
codewords 1e-6), ``embed`` and the perplexity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.models.vq_layer import VectorQuantizerEMA as JLayer
from synthanatomy_tpu_torch.interop import vq_layer_from_jax
from synthanatomy_tpu_torch.models.vq_layer import VectorQuantizerEMA

SHAPES = {"2d": (2, 5, 5, 4), "3d": (2, 3, 4, 5, 4)}


def _layers(init):
    kw = dict(commitment_cost=0.3, decay=0.9, epsilon=1e-5)
    jl = JLayer(num_embeddings=16, embedding_dim=4, embedding_init=init, use_pallas=False, **kw)
    return jl, kw


def _close(a, b, atol, name):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=0,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("use_pallas", [None, False])
@pytest.mark.parametrize("init", ["normal", "kaiming_uniform"])
@pytest.mark.parametrize("rank", ["2d", "3d"])
def test_vq_layer_matches_jax(rank, init, use_pallas):
    jl, kw = _layers(init)
    # inputs on the codebook's scale, so that many codewords are used
    x = np.asarray(jax.random.normal(jax.random.key(0), SHAPES[rank])) * 0.5
    variables = jax.device_get(jl.init(jax.random.key(1), jnp.asarray(x)))
    tl = vq_layer_from_jax(variables, use_pallas=use_pallas, device="cpu", **kw)
    assert tl.ema.codebook.shape == (16, 4) and tl.decay == 0.9
    xt = torch.from_numpy(x)

    # evaluation: no state change
    jq, jloss = jl.apply(variables, jnp.asarray(x))
    tq, tloss = tl(xt)
    _close(tq.numpy(), jq, 1e-6, "q")
    _close(float(tloss), float(jloss), 1e-6, "loss")
    _close(tl.ema.codebook.numpy(), variables["vq"]["ema"].codebook, 0, "untouched codebook")

    # quantize and embed
    jflat, jone, jidx = jl.apply(variables, jnp.asarray(x), method=jl.quantize)
    tflat, tone, tidx = tl.quantize(xt)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tone.numpy(), np.asarray(jone))
    assert tflat.shape == (x.size // 4, 4) and tidx.shape == x.shape[:-1]
    _close(tflat.numpy(), jflat, 1e-6, "flat_q")
    _close(tl.embed(tidx).numpy(), jl.apply(variables, jidx, method=jl.embed), 1e-6, "embed")
    _close(float(tl.perplexity_fn(tidx)), float(jl.perplexity_fn(jidx)), 1e-5, "perplexity")

    # training: the EMA state updated in place, as JAX's mutable "vq"
    (jq, jloss), muts = jl.apply(variables, jnp.asarray(x), training=True, mutable=["vq"])
    tq, tloss = tl(xt, training=True)
    _close(tq.numpy(), jq, 1e-6, "q (training)")
    _close(float(tloss), float(jloss), 1e-6, "loss (training)")
    ema = muts["vq"]["ema"]
    for k in ("codebook", "cluster_size", "embed_avg"):
        _close(getattr(tl.ema, k).numpy(), getattr(ema, k), 1e-6, k)


def test_vq_layer_gradient_is_straight_through():
    tl = VectorQuantizerEMA(8, 3, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 3, generator=torch.Generator().manual_seed(1), requires_grad=True)
    q, loss = tl(x, training=True)
    (q.sum() + 0 * loss).backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert tl.ema.cluster_size.sum() > 0


def test_vq_layer_from_jax_takes_a_dict_state():
    jl, _ = _layers("normal")
    variables = jax.device_get(jl.init(jax.random.key(2), jnp.zeros((1, 3, 4))))
    state = variables["vq"]["ema"]
    as_dict = {"vq": {"ema": {k: np.asarray(getattr(state, k)) for k in state._fields}}}
    a = vq_layer_from_jax(variables, device="cpu")
    b = vq_layer_from_jax(as_dict, device="cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k

"""Port VQ-VAE decode (synthanatomy_tpu_torch/models/vqvae.py) against
the JAX package at f32: weights carried by interop.vqvae_from_jax, the
port's NCDHW output permuted to JAX's NDHWC."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthanatomy_tpu.models.vqvae import BaselineVQVAE as JVQVAE
from synthanatomy_tpu_torch.interop import vqvae_from_jax
from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE
from synthanatomy_tpu_torch.ops.vq import embed_indices

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

DOWN = ((4, 2, 1, 1),) * 2
UP = ((4, 2, 1, 0, 1),) * 2


@pytest.fixture(scope="module")
def vqvaes():
    jm = JVQVAE(n_levels=2, downsample_parameters=DOWN, upsample_parameters=UP,
                n_embed=32, embed_dim=8, n_channels=16, n_res_channels=16,
                n_res_layers=2, dtype=jnp.float32)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.key(2), jnp.zeros((1, 4, 4, 4, 1))))
    tm = vqvae_from_jax(variables["params"], variables["vq"], 2, 2,
                        downsample_parameters=DOWN, upsample_parameters=UP,
                        dtype=torch.float32, device="cpu")
    return jm, variables, tm


def test_decode_samples_matches_jax_f32(vqvaes):
    jm, variables, tm = vqvaes
    idx = np.random.default_rng(0).integers(0, 32, size=(2, 3, 4, 3)).astype(np.int32)
    want = np.asarray(jm.apply(variables, [jnp.asarray(idx)], method=jm.decode_samples))
    with torch.no_grad():
        got = tm.decode_samples([torch.from_numpy(idx)])
    assert got.shape == (2, 1, 12, 16, 12) and got.dtype == torch.float32
    # f32 on both sides; the convolutions sum in another order
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=1e-4, atol=1e-4)


def test_embed_indices_matches_codebook(vqvaes):
    _, variables, tm = vqvaes
    idx = torch.tensor([[0, 31], [5, 7]])
    cb = np.asarray(variables["vq"]["level_0"].codebook)
    np.testing.assert_array_equal(embed_indices(tm.vq, idx).numpy(), cb[idx.numpy()])


def test_module_names_follow_jax_tree(vqvaes):
    keys = set(vqvaes[2].state_dict())
    for k in ("decoder_in_conv.weight", "decoder_res.1.1.conv2.weight",
              "decoder_ups.1.weight", "encoder_convs.0.weight", "vq.codebook"):
        assert k in keys, k


def test_bf16_decode_close_and_encode_not_ported(vqvaes):
    jm, variables, tm32 = vqvaes
    tm = vqvae_from_jax(variables["params"], variables["vq"], 2, 2,
                        downsample_parameters=DOWN, upsample_parameters=UP, device="cpu")
    # f32 weights, as flax keeps them; the convolutions run in bf16
    assert tm.decoder_in_conv.weight.dtype == torch.float32
    assert tm.decoder_in_conv.compute_dtype == torch.bfloat16
    assert tm.vq.codebook.dtype == torch.float32  # VQ stays an f32 island
    idx = torch.randint(0, 32, (1, 3, 4, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        lo = tm.decode_samples([idx]).float()
        hi = tm32.decode_samples([idx])
    # bf16 convolutions: a few bf16 ulps of the output scale
    assert torch.linalg.norm(lo - hi) <= 0.05 * torch.linalg.norm(hi)
    # encode is ported: bf16 latents of the expected shape
    z = tm.encode(torch.zeros(1, 1, 16, 16, 16))[0]
    assert z.shape == (1, 8, 4, 4, 4) and z.dtype == torch.bfloat16


def test_seeded_init_is_reproducible():
    def make():
        return BaselineVQVAE(n_levels=2, downsample_parameters=DOWN,
                             upsample_parameters=UP, n_embed=8, embed_dim=4,
                             n_channels=8, n_res_channels=8, n_res_layers=1,
                             dtype=torch.float32, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    a, b = make().state_dict(), make().state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)

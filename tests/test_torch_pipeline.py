"""Port synthesis pipeline (synthanatomy_tpu_torch/pipeline.py) end to
end against the JAX package's make_synthesizer, and the port's import
boundary (no JAX)."""

import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from synthanatomy_tpu.models.ordering import Ordering
from synthanatomy_tpu.models.performer import Performer as JPerformer
from synthanatomy_tpu.models.vqvae import BaselineVQVAE as JVQVAE
from synthanatomy_tpu.pipeline import make_synthesizer as j_make_synthesizer
from synthanatomy_tpu_torch.interop import performer_from_jax, vqvae_from_jax
from synthanatomy_tpu_torch.pipeline import make_synthesizer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, GRID, N_EMBED = 2, (2, 3, 2), 32
DOWN = ((4, 2, 1, 1),) * 2
UP = ((4, 2, 1, 0, 1),) * 2


def test_make_synthesizer_matches_jax():
    ordering = Ordering("raster_scan", 3, GRID)
    seq = int(np.prod(GRID))
    perf_kw = dict(heads=2, dim_head=64, local_attn_heads=1, local_window_size=12,
                   nb_features=128)
    jp = JPerformer(num_tokens=N_EMBED + 1, max_seq_len=seq + 1, dim=128, depth=2,
                    dtype=jnp.bfloat16, **perf_kw)
    pvars = jax.device_get(jax.jit(jp.init)(
        {"params": jax.random.key(0), "favor": jax.random.key(1)},
        jnp.zeros((1, 8), jnp.int32)))
    jv = JVQVAE(n_levels=2, downsample_parameters=DOWN, upsample_parameters=UP,
                n_embed=N_EMBED, embed_dim=8, n_channels=16, n_res_channels=16,
                n_res_layers=1, dtype=jnp.float32)
    vvars = jax.device_get(jax.jit(jv.init)(jax.random.key(2), jnp.zeros((1, 4, 4, 4, 1))))

    j_synth = j_make_synthesizer(jp, jv, ordering, batch=B, do_sample=False,
                                 decode_batch=1)
    j_vols, j_grids = j_synth(pvars, vvars, jax.random.key(3))

    tp = performer_from_jax(pvars["params"], pvars["favor"], 2, device="cpu", **perf_kw)
    tv = vqvae_from_jax(vvars["params"], vvars["vq"], 2, 1,
                        downsample_parameters=DOWN, upsample_parameters=UP,
                        dtype=torch.float32, device="cpu")
    synth = make_synthesizer(tp, tv, ordering, batch=B, do_sample=False, decode_batch=1)
    vols, grids = synth()
    # both default to int8 weights and int8 rings: greedy grids agree exactly
    np.testing.assert_array_equal(grids.numpy(), np.asarray(j_grids))
    assert vols.shape == (B, 1, 8, 12, 8) and torch.isfinite(vols).all()
    # f32 decode on both sides, convolution sums in another order
    np.testing.assert_allclose(vols.permute(0, 2, 3, 4, 1).numpy(), np.asarray(j_vols),
                               rtol=1e-4, atol=1e-4)


def test_make_synthesizer_prepending_takes_exact_path():
    """A 'prepending'-conditioned prior is not the fused step's: "auto"
    routes it to the exact path, whose greedy grids equal JAX's."""
    ordering = Ordering("raster_scan", 3, GRID)
    seq = int(np.prod(GRID))
    perf_kw = dict(heads=2, dim_head=64, local_attn_heads=1, local_window_size=6,
                   nb_features=128, conditioning_num_tokens=(3,),
                   conditioning_type="prepending")
    conds = [np.asarray([0, 2], np.int32)]
    jp = JPerformer(num_tokens=N_EMBED + 1, max_seq_len=seq + 1, dim=128, depth=2,
                    dtype=jnp.float32, **perf_kw)
    pvars = jax.device_get(jax.jit(jp.init)(
        {"params": jax.random.key(0), "favor": jax.random.key(1)},
        jnp.zeros((1, 8), jnp.int32), [jnp.zeros((1,), jnp.int32)]))
    jv = JVQVAE(n_levels=2, downsample_parameters=DOWN, upsample_parameters=UP,
                n_embed=N_EMBED, embed_dim=8, n_channels=16, n_res_channels=16,
                n_res_layers=1, dtype=jnp.float32)
    vvars = jax.device_get(jax.jit(jv.init)(jax.random.key(2), jnp.zeros((1, 4, 4, 4, 1))))
    j_synth = j_make_synthesizer(jp, jv, ordering, batch=B, do_sample=False,
                                 with_conditionings=True, decode_batch=1)
    _, j_grids = j_synth(pvars, vvars, jax.random.key(3), [jnp.asarray(c) for c in conds])

    tp = performer_from_jax(pvars["params"], pvars["favor"], 2, device="cpu",
                            dtype=torch.float32, **perf_kw)
    tv = vqvae_from_jax(vvars["params"], vvars["vq"], 2, 1,
                        downsample_parameters=DOWN, upsample_parameters=UP,
                        dtype=torch.float32, device="cpu")
    synth = make_synthesizer(tp, tv, ordering, batch=B, do_sample=False,
                             with_conditionings=True, decode_batch=1)
    vols, grids = synth(None, [torch.from_numpy(c) for c in conds])
    np.testing.assert_array_equal(grids.numpy(), np.asarray(j_grids))
    assert vols.shape == (B, 1, 8, 12, 8) and torch.isfinite(vols).all()


def test_make_synthesizer_takes_jax_keywords():
    """The port's make_synthesizer has JAX's parameters, no more and no
    fewer, with the same defaults."""
    def params(fn):
        return {n: (p.kind, p.default) for n, p in inspect.signature(fn).parameters.items()}

    assert params(make_synthesizer) == params(j_make_synthesizer)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import synthanatomy_tpu_torch, synthanatomy_tpu_torch.pipeline, "
        "synthanatomy_tpu_torch.interop, synthanatomy_tpu_torch._build\n"
        "import synthanatomy_tpu_torch.ops.fused_decode, synthanatomy_tpu_torch.models.vqvae\n"
        "assert 'jax' not in sys.modules and 'flax' not in sys.modules, "
        "sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

"""SynthAnatomy on PyTorch + CUDA (NVIDIA Hopper).

The port of ``synthanatomy_tpu`` (the JAX reference, which stays beside
it unchanged).  This package imports ``torch`` and never ``jax``.  Its
layout mirrors the reference (``ops/``, ``models/``, ``pipeline.py``,
``interop.py``) so each counterpart is found by name.

Ported so far: the synthesis path — fused-kernel AR sampling of the
latent grid (``models/sampling.py`` over the hand-written CUDA decode
step in ``csrc/fused_decode.cu``) and VQ-VAE ``decode_samples`` — and
the prior's training path: ``Performer.forward``, ``losses/transformer``
and ``train/transformer_steps``, with the FAVOR+ and local-attention
kernels (forward and backward) in ``csrc/favor_attention.cu`` and
``csrc/local_attention.cu``, and every forward option of the Performer;
stage 1 (VQ-VAE training and latent extraction, ``csrc/vq_argmin.cu``
and ``csrc/res_stack.cu``); and the prior-training bench
(``tools/bench_transformer.py``), whose ``--splash-local`` runs the
local heads through the block-sparse kernels of
``csrc/local_attention_splash.cu``; the stage-1 CLI
(``python -m synthanatomy_tpu_torch.run_vqvae run --mode=training|
extracting|decoding``, over ``runners/vqvae.py``, ``data/``,
``train/checkpoints.py`` and the rest of the runner layer) and the
headline's JSON line (``python -m synthanatomy_tpu_torch.tools.bench``).
"""

__version__ = "0.1.0"

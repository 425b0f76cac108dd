"""Measure the fused residual-layer kernel against the module path at
the paper's hot shape (the 80×112×80 level-0 stacks of the VQ-VAE).

Port of ``tools/bench_res_stack.py``, with its flags and printed lines.
At (B, 128, 80, 112, 80) with C = R = 128, three slim layers:

  - "XLA module stack": the module path, ``models/vqvae.ResidualLayer``
    with the fused kernel off (cuDNN ``F.conv3d`` in bf16, then bias,
    relu and the residual);
  - "XLA module stack, NDHWC": the same on channels-last volumes (cuDNN's
    layout downstream of a fused stack in the model);
  - "fused": row 7, ``ops/res_stack.fused_residual_layer``
    (``csrc/res_stack.cu``), forward and backward kernels, on the memory
    format the model gives it (``kernel_layout``: channels-last on the
    tile route);

forward only and forward + backward (d(Σ y²) by autograd, gradients of
the weights and of x); the fused stack's ratio is printed against the
module stack on either layout.  Each time is the best of 3 runs of ``--reps``
stacks between CUDA events (the host clock with ``--cpu``, where the
plain versions run on the host); "exactness" compares the two stacks'
sums first.

    python -m synthanatomy_tpu_torch.tools.bench_res_stack [--batch=1 --reps=10 --fwd-only]
    python -m synthanatomy_tpu_torch.tools.bench_res_stack --cpu --shape 4,6,4 --reps 1

``main`` returns {(name, with_bwd): ms} for "module" (NCDHW) and "fused".
"""

from __future__ import annotations

import argparse

import torch

from synthanatomy_tpu_torch.models.vqvae import ResidualLayer
from synthanatomy_tpu_torch.ops.res_stack import (
    fused_residual_layer,
    kernel_layout,
    supports_fused_residual,
)
from synthanatomy_tpu_torch.tools._probe_util import device_name, elapsed_s, probe_device

C = R = 128
N_LAYERS = 3


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the host")
    p.add_argument("--fwd-only", action="store_true")
    p.add_argument("--shape", default="80,112,80",
                   help="D,H,W (default: the paper level-0 stack)")
    args = p.parse_args(argv)
    dev = probe_device(args.cpu)
    print(f"device: {device_name(dev)}")
    torch.backends.cudnn.allow_tf32 = False  # bf16 convolutions; no f32 is rounded to TF32

    D, H, W = (int(s) for s in args.shape.split(","))
    B = args.batch
    dt = torch.bfloat16
    torch.manual_seed(0)
    layers = [ResidualLayer(C, R, 0.0, slim=True, dtype=dt, use_fused=False, device=dev)
              for _ in range(N_LAYERS)]
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, C, D, H, W, generator=gen, device=dev).to(dt)
    if not supports_fused_residual(x.shape, R):
        raise ValueError(f"the fused kernel does not take {tuple(x.shape)}")

    def module_stack(xx):
        for m in layers:
            xx = m(xx)
        return xx

    def fused_stack(xx):
        for m in layers:
            xx = fused_residual_layer(xx, m.conv1.weight, m.conv1.bias, m.conv2.weight,
                                      m.conv2.bias)
        return xx

    # ---- exactness first (kernel vs module, same inputs) ----------------
    with torch.no_grad():
        y_ref = float(module_stack(x).float().sum())
        y_k = float(fused_stack(kernel_layout(x, R)).float().sum())
    rel = abs(y_k - y_ref) / (abs(y_ref) + 1e-6)
    print(f"exactness: sum ref={y_ref:.1f} fused={y_k:.1f} rel={rel:.2e}")

    # ---- timing ----------------------------------------------------------
    params = [t for m in layers for t in (m.conv1.weight, m.conv1.bias, m.conv2.weight,
                                          m.conv2.bias)]

    x_cl = x.contiguous(memory_format=torch.channels_last_3d)
    x_k = kernel_layout(x, R)  # the model hands its fused stacks this

    def timed(name, stack_fn, with_bwd, x):
        if with_bwd:
            def once():
                xx = x.detach().requires_grad_()
                loss = (stack_fn(xx).float() ** 2).sum()
                return torch.autograd.grad(loss, [xx, *params])
        else:
            def once():
                with torch.no_grad():
                    return stack_fn(x)

        once()  # warm
        best = min(elapsed_s(lambda: [once() for _ in range(args.reps)], dev) / args.reps
                   for _ in range(3))
        flop = 2 * B * D * H * W * C * R * 28 * N_LAYERS * (3 if with_bwd else 1)
        print(f"{name:24s} {'fwd+bwd' if with_bwd else 'fwd    '} "
              f"{best * 1e3:8.2f} ms  ({flop / best / 1e12:6.1f} TFLOP/s)")
        return best * 1e3

    out = {}
    for with_bwd in ([False] if args.fwd_only else [False, True]):
        t_x = out[("module", with_bwd)] = timed("XLA module stack", module_stack, with_bwd, x)
        t_cl = timed("XLA module stack, NDHWC", module_stack, with_bwd, x_cl)
        t_f = out[("fused", with_bwd)] = timed("fused", fused_stack, with_bwd, x_k)
        print(f"    -> fused vs XLA: {t_x / t_f:.2f}x (NCDHW), {t_cl / t_f:.2f}x (NDHWC)")
    return out


if __name__ == "__main__":
    main()

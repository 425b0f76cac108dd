"""Stage-1 (VQ-VAE) train and eval steps.

Port of ``synthanatomy_tpu/train/vqvae_steps.py``: one G forward (the
EMA codebook update rides it), the composite reconstruction loss plus
the weighted generator loss, the G update; then D(fake.detach()) and
D(real), the weighted D loss and the D update.  As in JAX:

- the adaptive adversarial weight ‖∇_last recon‖ / ‖∇_last gen‖ comes
  from a head-only gradient: the last decoder layer re-run on its kept
  input (``model.diagnostics["last_layer_input"]``), so the two norms
  cost no second backward through the network; the G gradient is then
  that of recon + w·gen in one backward;
- ``d_grouped_stats`` runs D once over [fake; real] with per-half batch
  statistics (``SplitBatchNorm``), else twice;
- ``train_generator=False`` freezes G and its codebook;
- Adam (β 0.9/0.999, eps 1e-8, as ``optax.adam``), learning rates set
  each step from ``sched["lr"]`` and ``sched["d_lr"]``.

The models train in place: the state holds them, their optimizers and
the generator that dropout and the slice drop of the perceptual losses
draw from.  The adaptive weight's head re-runs the loss with the
generator rewound, so it drops the same slices as the main loss, as
JAX's head reuses the same key.

Data parallelism (``process_group``; JAX's step over a data mesh): each
rank runs the step on its own batch, and the step equals the one-device
step on the ranks' batches concatenated in rank order.  The EMA
statistics and D's batch-norm moments are summed over the ranks in the
forward; the adaptive weight's two last-layer gradients are averaged
before their norms; G's and D's gradients are averaged in f32 after each
backward (one all-reduce of the flattened gradients per optimizer, which
also holds where DDP's reducer would not: two optimizers, gradients by
``torch.autograd.grad``, D frozen in G's pass); the metrics are averaged
as JAX's ``pmean``.  Each rank's ``generator`` is its own (the runner
seeds it with the rank), and ``create_vqvae_train_state(zero1=True)``
shards both Adam states (``parallel/sharding_rules.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from synthanatomy_tpu_torch.losses import vqvae as vqvae_losses
from synthanatomy_tpu_torch.losses.adversarial import discriminator_loss, generator_loss
from synthanatomy_tpu_torch.models.discriminator import BaselineDiscriminator
from synthanatomy_tpu_torch.models.vqvae import BaselineVQVAE
from synthanatomy_tpu_torch.parallel import distributed as D
from synthanatomy_tpu_torch.parallel.sharding_rules import adam

__all__ = [
    "VQVAETrainState",
    "create_vqvae_train_state",
    "make_vqvae_eval_step",
    "make_vqvae_train_step",
]


@dataclasses.dataclass
class VQVAETrainState:
    step: int
    model: BaselineVQVAE
    g_opt: torch.optim.Optimizer  # Adam, or Adam behind ZeRO-1
    generator: torch.Generator  # dropout and slice-drop draws (on the model's device)
    d_model: Optional[BaselineDiscriminator] = None
    d_opt: Optional[torch.optim.Optimizer] = None


def create_vqvae_train_state(model: BaselineVQVAE, seed: int = 0, *,
                             learning_rate: float = 3e-4,
                             d_model: Optional[BaselineDiscriminator] = None,
                             d_learning_rate: float = 5e-4,
                             device="cuda", zero1: bool = False,
                             process_group=None) -> VQVAETrainState:
    """Moves the models to ``device``; Adam over G's parameters (the
    codebook is buffers, updated by EMA) and over D's, each sharded over
    ``process_group`` with ``zero1``; a generator seeded from ``seed``."""
    model.to(device)
    d_opt = None
    kw = dict(zero1=zero1, process_group=process_group)
    if d_model is not None:
        d_model.to(device)
        d_opt = adam(d_model.parameters(), d_learning_rate, **kw)
    return VQVAETrainState(
        step=0, model=model, g_opt=adam(model.parameters(), learning_rate, **kw),
        generator=torch.Generator(device=device).manual_seed(seed),
        d_model=d_model, d_opt=d_opt)


def _loss_kwargs(loss_name, sched, lpips_params, rng) -> Dict[str, Any]:
    kw: Dict[str, Any] = {}
    if loss_name == "baur":
        kw["gdl_factor"] = sched.get("gdl_factor", 0.0)
    if vqvae_losses.loss_needs_lpips(loss_name):
        kw["lpips_params"] = lpips_params
        kw["rng"] = rng
    return kw


@contextlib.contextmanager
def _frozen(module):
    """D's parameters take no gradient from the generator's losses."""
    if module is None:
        yield
        return
    flags = [p.requires_grad for p in module.parameters()]
    for p in module.parameters():
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


def _set_lr(opt, lr):
    for group in opt.param_groups:
        group["lr"] = float(lr)


def make_vqvae_train_step(
    model: BaselineVQVAE,
    *,
    loss_name: str = "mse",
    d_model: Optional[BaselineDiscriminator] = None,
    generator_criterion: str = "least_square",
    discriminator_criterion: str = "least_square",
    adversarial_weight: float = 0.005,
    use_adaptive_weight: bool = False,
    adaptive_threshold: int = 0,
    adaptive_value: float = 1.0,
    train_generator: bool = True,
    d_grouped_stats: bool = False,
    process_group=None,
) -> Callable:
    """step(state, batch, sched, lpips_params=None) → (state, metrics).
    ``batch`` is (B, 1, D, H, W) in [0, 1]; ``sched`` holds 'lr', 'd_lr',
    'decay', 'commitment_cost', 'gdl_factor' and 'epoch'.  With a
    ``process_group`` it is this rank's part of the global batch (see
    the module docstring)."""
    group = process_group
    loss_fn = vqvae_losses.get_vqvae_loss(loss_name)
    adversarial = d_model is not None

    def step(state: VQVAETrainState, batch, sched, lpips_params=None):
        x = batch
        gen = state.generator
        metrics: Dict[str, torch.Tensor] = {}
        vq_before = None if train_generator else {
            k: v.clone() for k, v in state.model.vq.state_dict().items()}

        with _frozen(d_model):
            out = model(x, decay=sched["decay"], commitment_cost=sched["commitment_cost"],
                        training=True, generator=gen, process_group=group)
            loss_rng_state = gen.get_state()
            recon_loss, summaries = loss_fn(
                out, x, **_loss_kwargs(loss_name, sched, lpips_params, gen))
            recon = out["reconstruction"][0]
            if adversarial:
                gen_loss, gsum = generator_loss(d_model(recon.float(), training=False),
                                                criterion=generator_criterion,
                                                weight=adversarial_weight)
                summaries = {**summaries, **gsum}
            else:
                gen_loss = torch.zeros((), device=x.device)

            if adversarial and use_adaptive_weight:
                last = model.last_layer()
                recon_h = last(model.diagnostics["last_layer_input"].detach())
                head_rng = torch.Generator(device=gen.device)
                head_rng.set_state(loss_rng_state)
                out_h = {"reconstruction": [recon_h],
                         "quantization_losses": [torch.zeros((), device=x.device)]}
                r_l, _ = loss_fn(out_h, x, **_loss_kwargs(loss_name, sched, lpips_params,
                                                          head_rng))
                g_l, _ = generator_loss(d_model(recon_h.float(), training=False),
                                        criterion=generator_criterion, weight=adversarial_weight)
                (g_r_last,) = torch.autograd.grad(r_l, last.weight, retain_graph=True)
                (g_g_last,) = torch.autograd.grad(g_l, last.weight)
                D.average_((g_r_last, g_g_last), group)  # the global batch's, before the norms
                w = torch.clamp(torch.linalg.norm(g_r_last.reshape(-1))
                                / (torch.linalg.norm(g_g_last.reshape(-1)) + 1e-4), 0.0, 1e4)
                if sched["epoch"] < adaptive_threshold:
                    w = torch.full_like(w, adaptive_value)
                w = w.detach()
            else:
                w = torch.ones((), device=x.device)

            if train_generator:
                state.g_opt.zero_grad(set_to_none=True)
                (recon_loss + w * gen_loss if adversarial else recon_loss).backward()
                D.average_gradients(model.parameters(), group)
                _set_lr(state.g_opt, sched["lr"])
                state.g_opt.step()
            else:
                state.model.vq.load_state_dict(vq_before)

        metrics["Loss-Reconstruction-Total"] = recon_loss.detach()
        metrics.update({k: v.detach() for k, v in summaries.items()})
        metrics["VQ0-Perplexity"] = model.diagnostics["perplexity"]
        metrics["Adversarial-Weight"] = w

        if adversarial:
            fake = recon.detach().float()
            if d_grouped_stats:
                logits = d_model(torch.cat([fake, x.float()]), training=True, stat_groups=2,
                                 process_group=group)
                logits_fake, logits_real = logits.chunk(2)
            else:
                logits_fake = d_model(fake, training=True, process_group=group)
                logits_real = d_model(x.float(), training=True, process_group=group)
            dl, dsum = discriminator_loss(logits_fake, logits_real,
                                          criterion=discriminator_criterion,
                                          weight=adversarial_weight)
            d_loss = dl * w
            state.d_opt.zero_grad(set_to_none=True)
            d_loss.backward()
            D.average_gradients(d_model.parameters(), group)
            _set_lr(state.d_opt, sched["d_lr"])
            state.d_opt.step()
            metrics.update({k: v.detach() for k, v in dsum.items()})
            metrics["Loss-Discriminator-Total"] = d_loss.detach()
            metrics["Loss-Generator-Total"] = (recon_loss + gen_loss * w).detach()
        state.step += 1
        return state, D.average_metrics(metrics, group)

    return step


def make_vqvae_eval_step(model: BaselineVQVAE, *, loss_name: str = "mse") -> Callable:
    """step(state, batch, sched, lpips_params=None) → (reconstruction,
    metrics): eval-mode forward and loss, no state change (every slice
    kept by the perceptual losses)."""
    loss_fn = vqvae_losses.get_vqvae_loss(loss_name)

    @torch.no_grad()
    def step(state: VQVAETrainState, batch, sched, lpips_params=None):
        out = model(batch, decay=sched["decay"], commitment_cost=sched["commitment_cost"],
                    training=False)
        loss, summaries = loss_fn(out, batch,
                                  **_loss_kwargs(loss_name, sched, lpips_params, None))
        return out["reconstruction"][0], {"Loss": loss, **summaries}

    return step

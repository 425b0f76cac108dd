"""Prior training: ``train/transformer_steps.make_transformer_train_step``
on device-resident seeded latent grids.

Set-up builds the stage-2 CLI's prior with the benchmark's weights, the
train state (Adam at the configuration's learning rate) and the step,
and draws a pool of ``pool_batches`` × ``batch`` token rows on the device
from the seed (each token drawn from a Zipf law over the codebook, as
latent codes are used unevenly; every row differs).  Step i takes pool
batch i mod ``pool_batches``, BOS-shifted as the CLI's
``prepare_batch`` shifts it.  The pool holds more batches than a run
takes steps, so no row repeats within a run: a pool cycled within the
window is memorised, its gradients fall a thousandfold, and the last
step's comparison then reads round-off.  Set-up then drives the state through the
first ``check_steps`` steps with the window's own call and feed, which
warm every shape up, and records what the check compares: each step's
loss, each leaf's first gradient (Adam's first moment after one step ÷
(1 − β₁)) and each leaf's change over those steps.  The window goes on
from there with the same state.

Before each of its steps the window copies the parameters and Adam's
moments into one buffer (one ``_foreach_copy_``, the same work every
step), so that once it has closed the buffer holds the state its last
step started from.  The last step's record is its loss, each leaf's
gradient ((m_after − β₁ m_before) ÷ (1 − β₁)) and each leaf's change.

``prior_train_tok_per_s`` is the tokens of all the window's steps over
all its time, ended by ``synchronize()``; the host checks the clock
after each step without waiting for the device.

The check runs the reference (``reference/prior.py``, float32, TF32
off) with plain Adam, in micro-batches of ``reference_rows`` rows: from
the same weights through the first steps and batches, and, from the
program's own parameters and moments before the window's last step,
through that step and its batch.  It compares, for each, the worst
step's loss and the worst leaf's gradient norm, and the change norm of
the worst leaf over the first steps and of the median leaf over the last
(``reference/train.py``).
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark.harness import program as P
from benchmark.harness import weights as W
from benchmark.harness.core import Compared, Window
from benchmark.reference import prior as ref_prior
from benchmark.reference import train as ref_train
from benchmark.reference.precision import exact_f32


def token_pool(cfg: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """(pool_batches × batch, N) token rows, each token drawn from the
    Zipf law p(v) ∝ 1 / (rank(v) + 1)^s over the codebook, the ranks a
    permutation of the codebook drawn from the seed."""
    v = cfg["vocab_size"]
    n = 1
    for s in cfg["latent_shape"]:
        n *= s
    rows = int(traffic["pool_batches"]) * int(traffic["batch"])
    gen = torch.Generator(device=device).manual_seed(P.sub_seed(seed, "tokens"))
    rank = torch.randperm(v, generator=gen, device=device)
    probs = 1.0 / (rank.double() + 1.0) ** float(traffic["zipf_s"])
    draws = torch.multinomial(probs.float(), rows * n, replacement=True, generator=gen)
    return draws.reshape(rows, n)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.traffic = ctx.traffic
        self.device = ctx.device
        self.limits = ctx.cell.workload["limits"]
        self.batch = int(self.traffic["batch"])
        self.lr = float(self.cfg["learning_rate"])

    def _feed(self, i: int):
        r = (i % int(self.traffic["pool_batches"])) * self.batch
        return self.inputs[r:r + self.batch], self.targets[r:r + self.batch]

    def _step(self, i: int) -> torch.Tensor:
        inputs, targets = self._feed(i)
        self.state, metrics = self.step_fn(self.state, inputs, targets, None, {"lr": self.lr})
        return metrics["Loss"]

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from synthanatomy_tpu_torch.train.transformer_steps import (
            create_transformer_train_state,
            make_transformer_train_step,
        )

        seed, dev = self.ctx.seed, self.device
        self.model, _, self.shapes = P.build_prior(self.cfg, P.sub_seed(seed, "prior"), dev)
        self.state = create_transformer_train_state(
            self.model, P.sub_seed(seed, "state") % (2 ** 62), learning_rate=self.lr)
        self.step_fn = make_transformer_train_step(self.model)
        tokens = token_pool(self.cfg, self.traffic, seed, dev)
        self.inputs = ref_prior.teacher_inputs(tokens, self.cfg["vocab_size"])
        self.targets = tokens
        self.names = [k for k, _ in self.model.named_parameters()]
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        losses, grad1 = [], {}
        for i in range(int(self.traffic["check_steps"])):
            losses.append(self._step(i).detach().float())
            if i == 0:  # a step that never reached the optimizer left no moment
                for k, p in self.model.named_parameters():
                    m = self.state.optimizer.state.get(p, {}).get("exp_avg")
                    m = torch.zeros_like(p) if m is None else m
                    grad1[k] = torch.linalg.vector_norm(m.float() / (1.0 - beta1))
        w0 = W.draw(self.shapes, P.sub_seed(seed, "prior"), dev)
        change = {k: torch.linalg.vector_norm(p.detach().float() - w0[k])
                  for k, p in self.model.named_parameters()}
        del w0
        self.program = {"loss": [float(x) for x in losses],
                        "grad1": {k: float(v) for k, v in grad1.items()},
                        "change": {k: float(v) for k, v in change.items()}}
        self.next_step = len(losses)
        params = [p for _, p in self.model.named_parameters()]
        moments = [self.state.optimizer.state.get(p, {}) for p in params]
        self.live = params + [m.get(key, torch.zeros_like(p)) for key in ("exp_avg", "exp_avg_sq")
                              for p, m in zip(params, moments)]
        self.before = [torch.empty_like(x) for x in self.live]
        P.sync(dev)

    # -- the window -------------------------------------------------------------

    def window(self, seconds: float, tracer) -> Window:
        dev = self.device
        n_tok = self.inputs.shape[1]
        bad = torch.zeros((), dtype=torch.long, device=dev)
        steps = 0
        t0 = time.perf_counter()
        while True:
            with tracer.unit(steps):
                with torch.no_grad():
                    torch._foreach_copy_(self.before, self.live)
                loss = self._step(self.next_step + steps)
            bad += (~torch.isfinite(loss)).long()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        P.sync(dev)
        dt = time.perf_counter() - t0
        self.last = {"step": self.next_step + steps - 1, "loss": float(loss)}
        return Window({"prior_train_tok_per_s": steps * self.batch * n_tok / dt},
                      attempted=steps, failed=int(bad),
                      facts={"batch": self.batch, "seq": n_tok})

    def release(self) -> None:
        """Keep the last step's record and the state it started from,
        then free the program."""
        n = len(self.names)
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        live, before = self.live, self.before
        with torch.no_grad():
            self.last["grad1"] = {
                k: float(torch.linalg.vector_norm((live[n + i].float() - beta1 * before[n + i])
                                                  / (1.0 - beta1)))
                for i, k in enumerate(self.names)}
            self.last["change"] = {k: float(torch.linalg.vector_norm(live[i] - before[i]))
                                   for i, k in enumerate(self.names)}
        self.last["loss"] = [self.last["loss"]]
        self.start = {part: dict(zip(self.names, before[i * n:(i + 1) * n]))
                      for i, part in enumerate(("params", "m", "v"))}
        del self.model, self.state, self.step_fn, self.live, self.before

    # -- the check --------------------------------------------------------------

    def loss_fn(self, rnd=None):
        kw = {} if rnd is None else {"rnd": rnd}
        return lambda p, x, y: ref_prior.ce_loss(p, self.cfg, x, y, **kw)

    def reference_first(self, rnd=None, half: bool = False) -> dict:
        """The reference through the first steps from the benchmark's
        weights (``rnd``: a lower precision; ``half``: half of each batch
        left out)."""
        feeds = [self._feed(i) for i in range(len(self.program["loss"]))]
        if half:
            feeds = [(x[:x.shape[0] // 2], y[:y.shape[0] // 2]) for x, y in feeds]
        p0 = W.draw(self.shapes, P.sub_seed(self.ctx.seed, "prior"), self.device)
        return ref_train.train(p0, self.names, feeds, self.lr, self.loss_fn(rnd),
                               rows=int(self.traffic["reference_rows"]))

    def reference_last(self, rnd=None, half: bool = False) -> dict:
        """The reference through the window's last step, from the
        program's parameters and moments before it; the buffers (the
        FAVOR projections) are the benchmark's draw."""
        x, y = self._feed(self.last["step"])
        if half:
            x, y = x[:x.shape[0] // 2], y[:y.shape[0] // 2]
        p0 = W.draw(self.shapes, P.sub_seed(self.ctx.seed, "prior"), self.device)
        p0.update(self.start["params"])
        return ref_train.train(p0, self.names, [(x, y)], self.lr, self.loss_fn(rnd),
                               rows=int(self.traffic["reference_rows"]),
                               m0=self.start["m"], v0=self.start["v"], t0=self.last["step"])

    def gaps(self, first: dict, last: dict) -> dict:
        """The compared numbers of records ``first`` and ``last`` against
        the reference's."""
        at_first = ref_train.gaps(first, self.ref_first)
        at_last = ref_train.gaps(last, self.ref_last)
        out = {k: at_first[k] for k in ref_train.FIRST}
        out.update({name: at_last[k] for k, name in ref_train.LAST.items()})
        return out

    def check(self) -> list:
        with exact_f32():
            self.ref_first = self.reference_first()
            self.ref_last = self.reference_last()
        print(f"worst leaves, first steps: {ref_train.worst(self.program, self.ref_first)}; "
              f"last step: {ref_train.worst(self.last, self.ref_last)}", file=sys.stderr)
        gaps = self.gaps(self.program, self.last)
        return [Compared(k, v, float(self.limits[k])) for k, v in gaps.items()]

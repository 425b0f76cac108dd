"""Synthesis: closed-loop calls of ``pipeline.make_synthesizer``.

Set-up builds the prior and, from the configuration's ``decoder``, the
VQ-VAE, with the benchmark's weights, and makes a synthesizer at the
traffic's batch and temperature with the pipeline's defaults (the fused
decode step, int8 weights, int8 rings, decoding in sub-batches).  One
call warms up (weight packing, the CUDA graph, cuDNN's engines).

The window calls it back to back, each call waiting for the last, each
with a generator seeded from the run's seed and the call's number.  The
volumes stay on the device.  ``synth_vol_per_min`` is the volumes
completed over the time from the window's start to the end of its last
call: the call in flight when the time runs out is finished and counted.

One call drawn from the seed (reservoir sampling, decided before each
call) copies the logits each of its fused steps returns into a buffer
made in set-up, and keeps its grids.  The other calls run as the
program alone runs them: holding each call's own output tensors instead
made the allocator call ``cudaMalloc`` inside the calls (0.16-0.38 s of
a traced call), which slowed the window by ~8%.  The check, once the window has closed, over the 16 rows and 1400
positions of that call, against the reference prior teacher-forced on
the call's served grids with the int8 weights the step serves worked out
again: the widest gap by which the reference logit of the program's top
token lies below the reference's best, and the widest difference of a
logit; and the largest relative L2 error of a decoded volume against the
reference decoder's, over a sample of the window's volumes drawn from
the seed (one candidate row a call).
"""

from __future__ import annotations

import random
import sys
import time

import torch

from benchmark.harness import program as P
from benchmark.harness import weights as W
from benchmark.harness.core import Compared, Window
from benchmark.reference import prior as ref_prior
from benchmark.reference import vqvae as ref_vqvae
from benchmark.reference.precision import exact_f32


class StepRecorder:
    """Wraps ``sampling.fused_logits_stepper`` so that, while ``into`` is
    set, each step function it makes copies the logits of step t into
    ``into[t]``."""

    def __init__(self, make_stepper):
        self.make_stepper = make_stepper
        self.into = None

    def __call__(self, *args, **kw):
        step = self.make_stepper(*args, **kw)

        def recorded(tok, t):
            logits = step(tok, t)
            if self.into is not None:
                self.into[t].copy_(logits)
            return logits

        return recorded


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.traffic = ctx.traffic
        self.device = ctx.device
        self.dec_cfg = P.load_config(ctx.cell.root, self.cfg["decoder"])
        self.limits = ctx.cell.workload["limits"]

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from synthanatomy_tpu_torch.models import sampling
        from synthanatomy_tpu_torch.pipeline import make_synthesizer

        if self.cfg.get("weight_quant", "int8") != "int8":
            raise ValueError("make_synthesizer serves int8 weights")
        seed, dev, t = self.ctx.seed, self.device, self.traffic
        self.prior, ordering, self.prior_shapes = P.build_prior(
            self.cfg, P.sub_seed(seed, "prior"), dev)
        self.prior.eval()
        self.vqvae, self.vq_shapes = P.build_vqvae(self.dec_cfg, P.sub_seed(seed, "vqvae"), dev)
        self.vqvae.eval()
        self.vqvae.decode_samples = self.ctx.spans.wrap("pipeline.decode",
                                                         self.vqvae.decode_samples)
        self.sampling = sampling
        self.recorder = StepRecorder(sampling.fused_logits_stepper)
        sampling.fused_logits_stepper = self.recorder
        self.synthesize = make_synthesizer(
            self.prior, self.vqvae, ordering, batch=t["batch"], temperature=t["temperature"],
            decode_batch=t["decode_batch"], ring_quant=bool(self.cfg["use_int8_rings"]))
        n = 1
        for size in self.cfg["latent_shape"]:
            n *= size
        self.logits = torch.empty(n, t["batch"], self.cfg["vocab_size"] + 1, device=dev)
        self.gen = torch.Generator(device=dev)
        self.recorder.into = self.logits  # the warm-up call records too
        self.synthesize(self.gen.manual_seed(P.sub_seed(seed, "warm-up")))
        P.sync(dev)

    # -- the window -------------------------------------------------------------

    def window(self, seconds: float, tracer) -> Window:
        t, dev, seed = self.traffic, self.device, self.ctx.seed
        batch = int(t["batch"])
        rng = random.Random(P.sub_seed(seed, "sample"))
        self.kept = []
        bad = torch.zeros((), dtype=torch.long, device=dev)
        calls = 0
        ends = []
        t0 = time.perf_counter()
        while True:
            keep = rng.randrange(calls + 1) == 0
            self.recorder.into = self.logits if keep else None
            with tracer.unit(calls):
                vols, grids = self.synthesize(
                    self.gen.manual_seed(P.sub_seed(seed, f"call {calls}")))
                P.sync(dev)
            bad += (~torch.isfinite(vols.flatten(1))).any(1).sum()
            if keep:
                self.call_grids = grids
            row = rng.randrange(batch)
            slot = (len(self.kept) if len(self.kept) < int(t["volumes_checked"])
                    else rng.randrange(calls + 1))
            if slot < int(t["volumes_checked"]):
                item = (grids[row].clone(), vols[row].clone())
                if slot == len(self.kept):
                    self.kept.append(item)
                else:
                    self.kept[slot] = item
            del vols, grids
            calls += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        P.sync(dev)
        dt = time.perf_counter() - t0
        self.recorder.into = None
        print("call seconds: " + " ".join(f"{b - a:.4f}" for a, b in zip([0.0] + ends, ends)),
              file=sys.stderr)
        done = calls * batch
        db = min(int(t["decode_batch"]), batch)
        while batch % db:
            db -= 1  # the sub-batch make_synthesizer decodes in
        return Window({"synth_vol_per_min": done * 60.0 / dt}, attempted=done,
                      failed=int(bad),
                      facts={"batch": batch, "decode_batch": db,
                             "decoder": self.dec_cfg})

    def release(self) -> None:
        """Keep the kept call's logits (B, N, V), then free the program."""
        self.call_logits = self.logits.permute(1, 0, 2)
        self.sampling.fused_logits_stepper = self.recorder.make_stepper
        del self.prior, self.vqvae, self.synthesize, self.recorder

    # -- the check --------------------------------------------------------------

    def compare_logits(self, logits: torch.Tensor, seqs: torch.Tensor, rows: int = 4):
        """(token gap, logit error) of a program's logits (B, N, V) at the
        positions of ``seqs`` (B, N) against the reference's, teacher-forced
        on ``seqs`` in blocks of ``rows`` rows: the widest gap by which the
        reference logit of the program's top token lies below the
        reference's best, and the widest difference of a logit (BOS left
        out, as it is never served)."""
        bos = self.cfg["vocab_size"]
        p = ref_prior.int8_folded(
            W.draw(self.prior_shapes, P.sub_seed(self.ctx.seed, "prior"), self.device), self.cfg)
        gap = err = 0.0
        for lg, s in zip(logits.split(rows), seqs.split(rows)):
            ref = ref_prior.logits(p, self.cfg, ref_prior.teacher_inputs(s, bos))
            lg = lg.clone()
            lg[..., bos] = float("-inf")
            top = lg.argmax(-1)
            gap = max(gap, float(ref_prior.greedy_gaps(ref, top, bos).max()))
            keep = torch.arange(ref.shape[-1], device=ref.device) != bos
            err = max(err, float((lg - ref)[..., keep].abs().max()))
        return gap, err

    def check(self) -> list:
        with torch.no_grad(), exact_f32():
            gap, lerr = self.compare_logits(self.call_logits,
                                            ref_prior.tokens_from_grid(self.call_grids))
            wv = W.draw(self.vq_shapes, P.sub_seed(self.ctx.seed, "vqvae"), self.device)
            err = 0.0
            for grid, vol in self.kept:
                ref = ref_vqvae.decode(wv, self.dec_cfg, grid[None])[0]
                err = max(err, float(torch.linalg.vector_norm(vol.float() - ref)
                                     / torch.linalg.vector_norm(ref)))
        return [Compared(k, v, float(self.limits[k])) for k, v in
                (("token_logit_gap", gap), ("logit_err", lerr), ("volume_rel_err", err))]

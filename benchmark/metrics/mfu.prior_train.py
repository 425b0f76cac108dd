"""The prior train step's share of the chip's peak: the model operations
of the traced steps (``counts/prior.train_step_flops``: forward and
backward, no recompute, attention as its mathematics) ÷ the traced
window ÷ the peak of the configuration's precision (989 TFLOP/s bf16,
67 TFLOP/s float32 with TF32 off)."""

from benchmark.counts.prior import train_step_flops
from benchmark.harness.readers import operands, share_of_window


def read(run):
    flops = train_step_flops(run.config, run.facts["batch"], run.facts["seq"])
    peak = operands(run.config)[1]
    return share_of_window(run, lambda steps: steps * flops / peak)

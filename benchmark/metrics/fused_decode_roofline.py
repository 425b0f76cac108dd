"""The fused decode step's share of its roofline: Σ over the traced
tokens of the step's least time (``counts/prior.fused_step``: the block
weights at their served width, the FAVOR state, the window's ring slots)
÷ Σ the device time of its kernels (``csrc/fused_decode.cu``).  Each
token's step opens with one ``step_begin_kernel``; the traced calls run
every token position once, so the launches are spread evenly over them."""

from benchmark.counts.peaks import bound_s
from benchmark.counts.prior import fused_step, seq_len

KERNELS = ("step_begin_kernel", "gemv_kernel", "attention_kernel")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    steps = tr.count("step_begin_kernel")
    seconds = tr.device_seconds(KERNELS)
    if steps == 0 or seconds <= 0:
        return None
    cfg, b = run.config, run.facts["batch"]
    n = seq_len(cfg)
    wb = 4 if cfg.get("weight_quant") == "int4" else 8
    rb = 8 if cfg.get("use_int8_rings") else 16
    per_call = sum(bound_s(*fused_step(cfg, b, t, wb, rb)) for t in range(n))
    return 100.0 * per_call * steps / n / seconds

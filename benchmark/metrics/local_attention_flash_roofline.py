"""The banded local-attention kernels' share of their roofline
(``ops/local_attention_flash`` → ``csrc/local_attention.cu``): Σ over
the traced calls of each call's least time from shapes
(``counts/attention.local_forward`` / ``local_backward`` over the
causal window's real pairs, at the operands' precision) ÷ Σ the device time of the
local kernels.  A forward call is one ``local_fwd_kernel``
(``band_fwd_kernel`` for wide heads), a backward call opens with one
``local_bwd_dq_kernel`` (``band_bwd_dq_kernel``)."""

from benchmark.counts.attention import local_backward, local_forward
from benchmark.harness.readers import operands, roofline_pct

KERNELS = ("local_fwd_kernel", "local_bwd_dq_kernel", "local_bwd_dkv_kernel",
           "band_fwd_kernel", "band_bwd_dq_kernel", "band_bwd_dkv_kernel")


def read(run):
    c, f = run.config, run.facts
    elem, peak = operands(c, "attn_compute_dtype")
    shape = (f["batch"], c["local_attn_heads"], f["seq"], c["dim_head"],
             c["local_window_size"], elem)
    return roofline_pct(run, KERNELS, [
        (("local_fwd_kernel", "band_fwd_kernel"), local_forward(*shape)),
        (("local_bwd_dq_kernel", "band_bwd_dq_kernel"), local_backward(*shape))], peak)

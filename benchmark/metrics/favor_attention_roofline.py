"""The FAVOR+ kernels' share of their roofline (``ops/favor_attention``
→ ``csrc/favor_attention.cu``): Σ over the traced calls of each call's
least time from shapes (``counts/attention.favor_forward`` /
``favor_backward`` at the FAVOR heads, at the operands' precision) ÷ Σ the device
time of the FAVOR kernels.  A forward call opens with one
``favor_fwd_kernel`` (``head_fwd_kernel`` for wide heads), a backward
call with one ``favor_dq_kernel`` (``head_dq_kernel``), so a recomputed
forward counts its own work."""

from benchmark.counts.attention import favor_backward, favor_forward
from benchmark.harness.readers import operands, roofline_pct

KERNELS = ("favor_state_kernel", "favor_scan_kernel", "favor_fwd_kernel", "favor_dq_kernel",
           "favor_dkv_kernel", "head_fwd_kernel", "head_dq_kernel", "head_dkv_kernel")


def read(run):
    c, f = run.config, run.facts
    elem, peak = operands(c, "attn_compute_dtype")
    shape = (f["batch"], c["n_head"] - c["local_attn_heads"], f["seq"], c["dim_head"],
             c["nb_features"], elem)
    return roofline_pct(run, KERNELS, [
        (("favor_fwd_kernel", "head_fwd_kernel"), favor_forward(*shape)),
        (("favor_dq_kernel", "head_dq_kernel"), favor_backward(*shape))], peak)

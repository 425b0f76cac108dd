"""The fused residual layer's share of its roofline (``ops/res_stack``
→ ``csrc/res_stack.cu``, the tile route ``res_tile_fwd_kernel``), in
the pipeline's decode: Σ over the traced forward calls of each call's
least time from shapes (``counts/conv.residual_layer``: the 3³ and 1³
products of a slim layer) ÷ Σ their device time.

The decode fuses the residual layers of the levels with at least the
port's 500,000 voxels a volume (``models/vqvae.py``'s gate), each layer
one launch a decode sub-batch; where the trace's launches do not match
that count the calls cannot be told apart, and nothing is read."""

from benchmark.counts.conv import decoder_level_voxels, residual_layer
from benchmark.counts.peaks import bound_s

GATE_VOXELS = 500_000
KERNELS = ("res_tile_fwd_kernel",)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    launches = tr.count("res_tile_fwd_kernel")
    seconds = tr.device_seconds(KERNELS)
    f = run.facts
    dec = f["decoder"]
    fused = [lv for lv in decoder_level_voxels(dec, run.config["latent_shape"])
             if lv[2] >= GATE_VOXELS]
    subbatches = f["batch"] // f["decode_batch"] * int(f.get("traced_units", 0))
    expected = subbatches * len(fused) * dec["no_res_layers"]
    if launches == 0 or seconds <= 0 or launches != expected:
        return None
    least = subbatches * dec["no_res_layers"] * sum(
        bound_s(*residual_layer(f["decode_batch"], c, r, v)) for c, r, v in fused)
    return 100.0 * least / seconds

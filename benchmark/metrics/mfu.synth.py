"""The synthesis step's share of the chip's peak: the least time the
traced calls' work could take (every token of sampling, fused step and
head, ``counts/prior.decode_token``, and every volume's decode,
``counts/conv.vqvae_decode``, each the larger of its operations at the
bf16 peak and its bytes at the memory's rate) ÷ the traced window."""

from benchmark.counts.conv import vqvae_decode
from benchmark.counts.peaks import bound_s
from benchmark.counts.prior import decode_token, seq_len
from benchmark.harness.readers import share_of_window


def read(run):
    cfg, f = run.config, run.facts
    n = seq_len(cfg)
    wb = 4 if cfg.get("weight_quant") == "int4" else 8
    rb = 8 if cfg.get("use_int8_rings") else 16
    sampling = sum(bound_s(*decode_token(cfg, f["batch"], t, wb, rb)) for t in range(n))
    decode = bound_s(*vqvae_decode(f["decoder"], cfg["latent_shape"], f["batch"]))
    return share_of_window(run, lambda calls: calls * (sampling + decode))

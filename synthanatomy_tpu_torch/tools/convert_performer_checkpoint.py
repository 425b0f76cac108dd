"""Convert released transformer checkpoints (``performer-pytorch`` 1.0.11
state dicts wrapped by the reference Performer,
src/networks/transformers/performer.py:70-288) to the converters'
``.npz`` layout.

Port of ``tools/convert_performer_checkpoint.py``, writing the same file
as the JAX package's converter (flat flax names, Linear kernels (in,
out)).  The port reads it with ``interop.performer_state_dict_from_jax``
(``tools/import_checkpoint``).  The key map is suffix-regex based, so it
holds whatever wrapper nesting the consumed package inserts
(PreLayerNorm / PreScaleNorm / ReZero / Chunk add ``.fn`` levels):

  token_emb.weight                         → token_emb.embedding
  pos_emb.emb.weight                       → abs_pos_emb.embedding
  spatial_position_emb.{i}.emb.weight      → spatial_emb_{i}.embedding
  conditioning_emb.{i}.weight              → conditioning_emb_{i}.embedding
  ...layers.{L}.0...to_{q,k,v,out}.weight  → block_{L}.attn.to_*  (ᵀ)
  ...layers.{L}.0...norm.{weight,bias}     → block_{L}.norm_attn
  ...layers.{L}.0...g (ReZero)             → block_{L}.g_attn
  ...layers.{L}.1...w1/w2.{weight,bias}    → block_{L}.ff.w1/w2  (ᵀ)
  ...layers.{L}.1...norm.{weight,bias}     → block_{L}.norm_ff
  norm.{weight,bias} (final)               → final_norm
  to_out.{weight,bias} (head)              → to_out  (ᵀ)

Usage:
  python -m synthanatomy_tpu_torch.tools.convert_performer_checkpoint in.pt out.npz [--depth=N]
"""

from __future__ import annotations

import re
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np

__all__ = ["convert_performer_state_dict", "convert_performer_favor"]

_LAYER_RE = re.compile(r"\blayers\.(\d+)\.(\d)\.")


def convert_performer_favor(
    sd: Dict[str, np.ndarray], *, depth: int
) -> Dict[str, Any]:
    """Extract the per-layer FAVOR+ random-feature projection buffers
    (``...layers.{L}.0...projection_matrix``, registered torch buffers
    saved with the checkpoint) into the ``favor`` tree ``{block_L: {attn:
    {projection: (m, dh)}}}`` (the port's ``attn.projection`` buffers).

    Teacher-forced logit parity with a released checkpoint needs the
    same projections on both sides: a redraw at load would match only in
    distribution.  Returns {} when the checkpoint carries none (e.g.
    ``no_projection`` configs)."""
    favor: Dict[str, Any] = {}
    for key, v in sd.items():
        if not key.endswith("projection_matrix"):
            continue
        lm = _LAYER_RE.search(key)
        if lm is None or int(lm.group(2)) != 0:
            continue
        favor[f"block_{lm.group(1)}"] = {
            "attn": {"projection": np.asarray(v)}
        }
    return favor


def convert_performer_state_dict(
    sd: Dict[str, np.ndarray], *, depth: int
) -> Dict[str, Any]:
    """The reference state dict → the flax-named ``params`` tree."""
    params: Dict[str, Any] = {}

    def put(path, value):
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value)

    def linear_w(v):
        return np.transpose(np.asarray(v))  # (out,in) → (in,out)

    for key, v in sd.items():
        if key.endswith("token_emb.weight"):
            put(("token_emb", "embedding"), v)
            continue
        if re.search(r"\bpos_emb\.emb\.weight$", key):
            put(("abs_pos_emb", "embedding"), v)
            continue
        m = re.search(r"spatial_position_emb\.(\d+)\.emb\.weight$", key)
        if m:
            put((f"spatial_emb_{m.group(1)}", "embedding"), v)
            continue
        m = re.search(r"conditioning_emb\.(\d+)\.weight$", key)
        if m:
            put((f"conditioning_emb_{m.group(1)}", "embedding"), v)
            continue

        lm = _LAYER_RE.search(key)
        if lm:
            layer, slot = int(lm.group(1)), int(lm.group(2))
            block = f"block_{layer}"
            if slot == 0:  # attention sub-block
                m = re.search(r"to_(q|k|v|out)\.(weight|bias)$", key)
                if m:
                    name, kind = f"to_{m.group(1)}", m.group(2)
                    put(
                        (block, "attn", name, "kernel" if kind == "weight" else "bias"),
                        linear_w(v) if kind == "weight" else v,
                    )
                    continue
                m = re.search(r"norm\.(weight|bias)$", key)
                if m:
                    put(
                        (block, "norm_attn", "scale" if m.group(1) == "weight" else "bias"),
                        v,
                    )
                    continue
                if key.endswith(".g"):  # ReZero / ScaleNorm gain
                    put((block, "g_attn"), np.reshape(v, (1,)))
                    continue
            else:  # feed-forward sub-block
                m = re.search(r"(w1|w2)\.(weight|bias)$", key)
                if m:
                    put(
                        (block, "ff", m.group(1), "kernel" if m.group(2) == "weight" else "bias"),
                        linear_w(v) if m.group(2) == "weight" else v,
                    )
                    continue
                m = re.search(r"norm\.(weight|bias)$", key)
                if m:
                    put(
                        (block, "norm_ff", "scale" if m.group(1) == "weight" else "bias"),
                        v,
                    )
                    continue
                if key.endswith(".g"):
                    put((block, "g_ff"), np.reshape(v, (1,)))
                    continue
            continue

        if re.search(r"(^|\.)norm\.weight$", key):
            put(("final_norm", "scale"), v)
            continue
        if re.search(r"(^|\.)norm\.bias$", key):
            put(("final_norm", "bias"), v)
            continue
        if re.search(r"(^|\.)to_out\.weight$", key):
            put(("to_out", "kernel"), linear_w(v))
            continue
        if re.search(r"(^|\.)to_out\.bias$", key):
            put(("to_out", "bias"), v)
            continue
    return params


def main(argv: Optional[Sequence[str]] = None) -> None:
    from synthanatomy_tpu_torch.tools.convert_checkpoint import (
        flatten_tree,
        load_torch_state_dict,
    )

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        raise SystemExit("usage: convert_performer_checkpoint.py in.pt out.npz --depth=N")
    src, dst = argv[:2]
    depth = 24
    for tok in argv[2:]:
        if tok.startswith("--depth="):
            depth = int(tok.split("=")[1])
    sd = load_torch_state_dict(src)
    tree = {"params": convert_performer_state_dict(sd, depth=depth)}
    favor = convert_performer_favor(sd, depth=depth)
    if favor:  # an empty collection flattens to no key, as in JAX
        tree["favor"] = favor
    flat = flatten_tree(tree)
    np.savez(dst, **flat)
    print(f"wrote {dst} ({len(flat)} arrays)")


if __name__ == "__main__":
    main()

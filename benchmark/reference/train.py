"""Training in the reference, and the comparison of a program's steps
with it.

:func:`train` runs steps of plain Adam (β 0.9/0.999, ε 1e-8, the
update lr · m̂ / (√v̂ + ε)) on float32 leaves, each step's gradient of
the batch's mean loss summed over micro-batches of ``rows`` rows.  It
starts from the benchmark's weights with zero moments (a run's first
steps), or from a program's parameters and moments at step ``t0`` (the
window's last step).  It records each step's loss, each leaf's gradient
norm in the first step it takes and each leaf's change over the steps.

:func:`gaps` compares a program's record with the reference's by the
worst case: the step whose loss lies farthest from the reference's
(relative); the leaf whose gradient norm, and the leaf whose change
norm, lies farthest from the reference's, each measured against the
larger of that leaf's reference norm and the median leaf's.  Leaves
whose reference gradient is below a thousandth of the median leaf's move
under Adam by round-off alone; their change is not compared.

The window's last step compares the median leaf's change gap in place of
the worst leaf's.  Late in a run on unstructured tokens some leaves'
gradients (the later blocks' query and key weights) fall to a few
thousandths of the median leaf's, and their float32 round-off is then a
share of the gradient itself.  Adam divides each element by its own
scale, so that share passes whole into those leaves' change, and the
worst leaf's change gap swings from seed to seed by a hundredfold.  The
median leaf's does not; a step that leaves the state unchanged still
reads 1 on it.
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8
# a leaf's change is compared where its gradient is at least this share
# of the median leaf's
MOVED = 1e-3
# the numbers compared over the first steps, and over the window's last
# step under their names there
FIRST = ("loss_gap", "grad1_gap", "change_gap")
LAST = {"loss_gap": "last_loss_gap", "grad1_gap": "last_grad_gap",
        "change_median_gap": "last_change_median_gap"}

Feed = Tuple[torch.Tensor, torch.Tensor]


def adam_step(params: Dict[str, torch.Tensor], names: Sequence[str],
              m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor], t: int,
              feed: Feed, lr: float, loss_fn: Callable, rows: int):
    """Step ``t`` (from 1) of plain Adam, in place on ``params``, ``m``
    and ``v``; returns (the batch's loss, each leaf's gradient norm)."""
    x, y = feed
    n = x.shape[0]
    total = 0.0
    for r in range(0, n, rows):
        part = loss_fn(params, x[r:r + rows], y[r:r + rows]) * (min(rows, n - r) / n)
        part.backward()
        total += float(part.detach())
    b1, b2 = BETAS
    norms = {}
    with torch.no_grad():
        for k in names:
            g = params[k].grad
            norms[k] = float(torch.linalg.vector_norm(g))
            m[k].mul_(b1).add_(g, alpha=1 - b1)
            v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = m[k] / (1 - b1 ** t)
            vhat = v[k] / (1 - b2 ** t)
            params[k] -= lr * mhat / (torch.sqrt(vhat) + EPS)
            params[k].grad = None
    return total, norms


def train(p0: Dict[str, torch.Tensor], names: Sequence[str], feeds: List[Feed], lr: float,
          loss_fn: Callable, rows: int, *, m0: Optional[Dict[str, torch.Tensor]] = None,
          v0: Optional[Dict[str, torch.Tensor]] = None, t0: int = 0) -> dict:
    """Steps ``t0 + 1 ..`` over ``feeds`` from ``p0`` and the moments
    ``m0``, ``v0`` (zeros where not given)."""
    params = {k: x.clone() for k, x in p0.items()}
    for k in names:
        params[k].requires_grad_(True)
    m = {k: torch.zeros_like(params[k]) if m0 is None else m0[k].clone() for k in names}
    v = {k: torch.zeros_like(params[k]) if v0 is None else v0[k].clone() for k in names}
    losses, grad1 = [], {}
    for i, feed in enumerate(feeds):
        loss, norms = adam_step(params, names, m, v, t0 + i + 1, feed, lr, loss_fn, rows)
        losses.append(loss)
        if i == 0:
            grad1 = norms
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(params[k] - p0[k])) for k in names}
    return {"loss": losses, "grad1": grad1, "change": change}


def leaf_gaps(prog: dict, ref: dict) -> Dict[str, Dict[str, float]]:
    """Each compared leaf's first-gradient and change gap."""
    g_ref = ref["grad1"]
    med = statistics.median(g_ref.values())
    moved = [k for k, g in g_ref.items() if g >= MOVED * med]
    c_ref = ref["change"]
    med_c = statistics.median(c_ref[k] for k in moved)
    return {"grad1": {k: abs(prog["grad1"][k] - g) / max(g, med) for k, g in g_ref.items()},
            "change": {k: abs(prog["change"][k] - c_ref[k]) / max(c_ref[k], med_c)
                       for k in moved}}


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    leaves = leaf_gaps(prog, ref)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
            "grad1_gap": max(leaves["grad1"].values()),
            "change_gap": max(leaves["change"].values()),
            "change_median_gap": statistics.median(leaves["change"].values())}


def worst(prog: dict, ref: dict, n: int = 3) -> str:
    """The leaves that read the largest gaps, each with its reference
    gradient as a share of the median leaf's, and the median leaf's
    change gap, for the run's log."""
    out = []
    leaves = leaf_gaps(prog, ref)
    med = statistics.median(ref["grad1"].values())
    for kind, by_leaf in leaves.items():
        top = sorted(by_leaf.items(), key=lambda kv: -kv[1])[:n]
        out.append(f"{kind}: " + ", ".join(
            f"{k} {v:.3g} (program {prog[kind][k]:.4g}, reference {ref[kind][k]:.4g}, "
            f"gradient {ref['grad1'][k] / med:.3g} of the median)"
            for k, v in top))
    out.append(f"median change gap {statistics.median(leaves['change'].values()):.3g}")
    return "; ".join(out)

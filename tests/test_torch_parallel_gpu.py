"""The EMA statistics' cross-rank reduction on the card, on both routes
of ``ops/vq.quantize_ema``: the plain one-hot statistics and row 4's
``nearest_codeword_stats`` kernel (``FUSED_EMA_STATS``), in a one-rank
gloo group over CUDA tensors, against the same update without a group
(tolerance 1e-5 of the largest magnitude: the two routes sum in other
orders); and a two-rank gloo job on card 0 whose ranks each hold half of
a batch, against one process on the whole batch.

Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_parallel_gpu.py

Every test is marked ``gpu`` and skips without a CUDA card.
"""

import os
import sys

import pytest
import torch
import torch.distributed as dist

from synthanatomy_tpu_torch.ops import vq

pytestmark = pytest.mark.gpu

N, K, DIM = 4200, 2048, 32  # the paper's B3 latents against its codebook


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _inputs(card, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(K, DIM, generator=g)
    x = w[torch.randint(0, K, (N,), generator=g)] + 0.3 * torch.randn(N, DIM, generator=g)
    return x.to(card), w.to(card)


def _update(x, w, fused, group):
    state = vq.VQState(K, DIM, device=x.device)
    state.codebook.copy_(w)
    state.embed_avg.copy_(w)
    old, vq.FUSED_EMA_STATS = vq.FUSED_EMA_STATS, fused
    try:
        _, _, idx, _ = vq.quantize_ema(state, x, decay=0.5, commitment_cost=0.25,
                                       training=True, process_group=group)
    finally:
        vq.FUSED_EMA_STATS = old
    return idx, {k: v.clone() for k, v in state.state_dict().items()}


@pytest.mark.parametrize("fused", [False, True], ids=["plain-stats", "row4-stats"])
def test_quantize_ema_reduces_over_a_one_rank_group(card, one_rank, fused):
    x, w = _inputs(card)
    before = vq.nearest_codeword_stats.launches
    idx, got = _update(x, w, fused, one_rank)
    assert vq.nearest_codeword_stats.launches - before == int(fused)
    want_idx, want = _update(x, w, fused, None)
    assert torch.equal(idx, want_idx)
    for k, v in want.items():
        err = float((got[k] - v).abs().max())
        assert err <= 1e-5 * max(float(v.abs().max()), 1e-6), (k, err)


_RANK = r"""
import os, sys, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from synthanatomy_tpu_torch.ops import vq
from synthanatomy_tpu_torch.parallel import distributed as D
D.maybe_initialize_distributed(backend="gloo")
vq.FUSED_EMA_STATS = sys.argv[3] == "1"
x, w = torch.load(sys.argv[2])
r = dist.get_rank()
state = vq.VQState(w.shape[0], w.shape[1], device="cuda")
state.codebook.copy_(w.cuda()); state.embed_avg.copy_(w.cuda())
vq.quantize_ema(state, x.chunk(2)[r].cuda(), decay=0.5, commitment_cost=0.25, training=True,
                process_group=dist.group.WORLD)
torch.save({k: v.cpu() for k, v in state.state_dict().items()}, sys.argv[2] + f".{r}")
dist.destroy_process_group()
"""


@pytest.mark.parametrize("fused", [False, True], ids=["plain-stats", "row4-stats"])
def test_two_ranks_on_one_card_update_as_one_process(card, tmp_path, fused):
    from synthanatomy_tpu_torch.parallel.distributed import launch

    x, w = _inputs(card, seed=1)
    path = str(tmp_path / "inputs.pt")
    torch.save((x.cpu(), w.cpu()), path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    launch([sys.executable, "-c", _RANK, repo, path, str(int(fused))], 2, timeout=120)
    _, want = _update(x, w, fused, None)
    ranks = [torch.load(f"{path}.{r}") for r in range(2)]
    for k, v in want.items():
        assert torch.equal(ranks[0][k], ranks[1][k]), k
        err = float((ranks[0][k] - v.cpu()).abs().max())
        assert err <= 1e-5 * max(float(v.abs().max()), 1e-6), (k, err)

"""Multi-process initialisation and the collectives of the DP steps.

Port of ``synthanatomy_tpu/parallel/distributed.py``: where JAX calls
``jax.distributed.initialize()``, the port reads torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; the reference's DDP convention, run_vqvae.py:831-846)
and calls ``torch.distributed.init_process_group`` once: NCCL for a run
on the cards (rank r on ``cuda:LOCAL_RANK``), gloo for ``--device=cpu``.
A process started without that environment is a single-device run and
sets nothing up.

The DP steps reduce with explicit collectives, as JAX's ``shard_map``
steps ``pmean`` and ``psum`` over the data axis: one all-reduce of the
flattened f32 gradients per optimizer (:func:`average_gradients`), one
of the step's metrics (:func:`average_metrics`), one of an evaluation's
(:func:`sample_weighted_means`) and, where statistics
over the global batch enter the forward (the EMA codebook counts,
batch-norm moments), :func:`all_reduce_sum`, which autograd
differentiates.  :func:`megatron_f` and :func:`megatron_g` are
Megatron's conjugate operators, which the Performer's attention and FF
place around their split products under tensor parallelism.
:func:`stack_over_ranks` gathers the ranks' tensors
exactly, on every rank (the TP and PP states, SP's prefix states) or on
the group's rank 0 alone, one tensor at a time (the runner's checkpoints
under TP and PP).
:func:`pipe_send_recv` moves a pipeline stage's activations to the next
rank and their cotangents back (JAX's ``ppermute`` over the pipe axis).
:func:`fold_in` is JAX's ``fold_in(key, axis_index)`` for a
``torch.Generator``.  :func:`launch` starts N rank processes with
torchrun's environment on this host (the tests, ``chip_smoke.py`` and
``tools/dryrun_multigpu.py`` use it where torchrun is not at hand).
"""

from __future__ import annotations

import logging
import os
import socket
import subprocess
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "all_reduce_sum",
    "any_rank",
    "average_",
    "average_gradients",
    "average_metrics",
    "backend_is_nccl",
    "barrier",
    "default_group",
    "fold_in",
    "gather_to_rank0",
    "group_info",
    "launch",
    "launched",
    "local_rank",
    "maybe_initialize_distributed",
    "megatron_f",
    "megatron_g",
    "pipe_send_recv",
    "ranks_agree",
    "sample_weighted_means",
    "stack_over_ranks",
    "sum_",
]

_log = logging.getLogger(__name__)
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether this process was started by torchrun (or :func:`launch`)."""
    return all(v in os.environ for v in _ENV)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def maybe_initialize_distributed(device=None, *, backend: Optional[str] = None) -> bool:
    """Set up the default process group once when torchrun's environment
    is present; returns whether the job has several ranks.

    ``device`` is the run's ``--device``: ``"cpu"`` takes gloo, anything
    else NCCL on ``cuda:LOCAL_RANK``, which must exist.  ``backend``
    overrides that choice (gloo also carries CUDA tensors: two ranks on
    one card, which NCCL refuses).  One all-reduce follows the set-up, so
    a backend that cannot connect raises here and not at the first step.
    A process without that environment is a no-op (False)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if not launched():
        return False
    if backend is None:
        backend = "gloo" if str(device) == "cpu" else "nccl"
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    probe_device = torch.device("cpu")
    if backend == "nccl":
        local = local_rank()
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA card: pass --device=cpu to run the ranks on "
                               "the CPU over gloo")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} has no card: this host has "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(local)
        probe_device = torch.device("cuda", local)
    dist.init_process_group(backend, rank=rank, world_size=world)
    probe = torch.ones(1, device=probe_device)
    dist.all_reduce(probe)
    if int(probe.item()) != world:
        raise RuntimeError(f"{backend} all-reduce over {world} ranks gave {probe.item()}")
    _log.info("torch.distributed (%s) initialised: rank %d of %d", backend, rank, world)
    return world > 1


def default_group():
    """The world group when a process group is set up, else None (no
    reduction: a single-device run)."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def group_info(group=None) -> Tuple[int, int]:
    """(rank, world size) of ``group``; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def barrier(group=None) -> None:
    if group is None:
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of ``t``, differentiable: the gradient of each
    rank's input is the sum of the ranks' output gradients."""
    return _AllReduceSum.apply(t, group)


class _F(torch.autograd.Function):
    """Megatron's ``f``: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _G(torch.autograd.Function):
    """Megatron's ``g``: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def megatron_f(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group``'s ranks of their partial products, closing a
    column/row-parallel pair; its gradient passes through unchanged."""
    return _F.apply(x, group)


def megatron_g(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, opening a column/row-parallel pair; its gradient is
    summed over ``group``'s ranks, so the replicated stream before it
    gets the whole gradient on every rank."""
    return _G.apply(x, group)


def average_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over the ranks, in place: one
    all-reduce of the tensors flattened in f32."""
    _reduce_(tensors, group, mean=True)


def sum_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its sum over the ranks, in place (JAX's
    ``psum``): one all-reduce of the tensors flattened in f32."""
    _reduce_(tensors, group, mean=False)


def _reduce_(tensors: Sequence[torch.Tensor], group, *, mean: bool) -> None:
    tensors = list(tensors)
    if group is None or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.detach().copy_(flat[offset:offset + n].view_as(t))
        offset += n


def average_gradients(params: Iterable[torch.nn.Parameter], group) -> None:
    """Mean of every gradient over the ranks: the gradient of the mean
    loss over the global batch when every rank holds as many samples."""
    average_([p.grad for p in params if p.grad is not None], group)


def average_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The step's scalar metrics averaged over the ranks (JAX's ``pmean``
    of the summaries), in one all-reduce."""
    if group is None or not metrics:
        return metrics
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).detach().float().reshape(())
                        for k in keys])
    dist.all_reduce(vals, group=group)
    vals /= dist.get_world_size(group)
    return dict(zip(keys, vals.unbind(0)))


def any_rank(flag: bool, group, device) -> bool:
    """Whether ``flag`` is set on any rank (``flag`` itself without a
    group): ranks that must take the same branch, such as a preemption
    checkpoint, agree on it first."""
    if group is None:
        return flag
    t = _host_if_gloo(torch.tensor([float(flag)], device=device), group)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def sample_weighted_means(batch_means: Dict[str, Sequence[torch.Tensor]],
                          sizes: Sequence[int], group, device) -> Dict[str, float]:
    """Each metric's mean over the samples of every rank: the batches'
    means (0-d tensors, one per batch of ``sizes``) weighted by their
    sizes, summed over the ranks in one all-reduce.  A rank may hold
    fewer batches than another, or none."""
    keys = list(batch_means)
    n = torch.tensor(list(sizes), dtype=torch.float32, device=device)
    sums = torch.stack([torch.dot(torch.stack(list(batch_means[k])), n) if len(sizes)
                        else n.sum() for k in keys] + [n.sum()])
    dist.all_reduce(sums, group=group)
    return {k: float(sums[i] / sums[-1]) for i, k in enumerate(keys)}


def backend_is_nccl(group=None) -> bool:
    return dist.get_backend(group) == "nccl"


def _host_if_gloo(t: torch.Tensor, group) -> torch.Tensor:
    """gloo's gather and min/max reductions take host tensors."""
    return t if backend_is_nccl(group) else t.cpu()


def ranks_agree(tensors: Sequence[torch.Tensor], group) -> bool:
    """Whether every rank holds bit-identical ``tensors``: their element-wise
    max over the ranks equals their min."""
    if group is None:
        return True
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    hi = _host_if_gloo(flat, group).clone()
    lo = hi.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    return bool(torch.equal(hi, lo))


def gather_to_rank0(t: torch.Tensor, group) -> Optional[torch.Tensor]:
    """The ranks' ``t`` concatenated in rank order on rank 0 (on ``t``'s
    device), None on the others."""
    rank, world = group_info(group)
    if group is None:
        return t
    local = _host_if_gloo(t.contiguous(), group)
    parts = [torch.empty_like(local) for _ in range(world)] if rank == 0 else None
    dist.gather(local, parts, dst=dist.get_global_rank(group, 0), group=group)
    return torch.cat(parts).to(t.device) if rank == 0 else None


def stack_over_ranks(tensors: Sequence[torch.Tensor], group, *,
                     root_only: bool = False) -> Optional[List[torch.Tensor]]:
    """Each of ``tensors`` (alike in number, shapes and dtypes on the
    ranks) stacked over ``group``'s ranks in rank order, ``(n, *shape)``.

    On every rank (the default): one sum all-reduce of a zero buffer in
    which each rank writes its tensors at its slot (f32 for the floats of
    32 bits or fewer, else one a dtype).  Adding zeros is exact, and a sum
    all-reduce carries CUDA tensors over gloo too (its gather takes host
    tensors); under NCCL the buffer is on the rank's card.

    ``root_only``: on the group's rank 0 alone, in host memory, and None
    on the other ranks, which allocate nothing for it: one gather a
    tensor, in its own dtype (exact); under NCCL rank 0's card holds one
    tensor's n shares at a time before they move to the host, and gloo
    gathers host tensors."""
    if root_only:
        return _stack_to_root(tensors, group)
    rank, n = group_info(group)
    if group is None:
        return [t.unsqueeze(0) for t in tensors]

    def wire(t):
        return torch.float32 if t.is_floating_point() and t.element_size() <= 4 else t.dtype

    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for dtype in dict.fromkeys(wire(t) for t in tensors):
        idx = [i for i, t in enumerate(tensors) if wire(t) == dtype]
        dev = (torch.device("cuda", torch.cuda.current_device()) if backend_is_nccl(group)
               else tensors[idx[0]].device)
        size = sum(tensors[i].numel() for i in idx)
        flat = torch.zeros(n, size, dtype=dtype, device=dev)
        off = 0
        for i in idx:
            t = tensors[i]
            flat[rank, off:off + t.numel()].copy_(t.detach().reshape(-1))
            off += t.numel()
        dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            t = tensors[i]
            out[i] = flat[:, off:off + t.numel()].reshape((n,) + tuple(t.shape)).to(
                t.device, t.dtype)
            off += t.numel()
    return out


def _stack_to_root(tensors: Sequence[torch.Tensor], group) -> Optional[List[torch.Tensor]]:
    rank, n = group_info(group)
    if group is None:
        return [t.detach().cpu().unsqueeze(0) for t in tensors]
    dev = (torch.device("cuda", torch.cuda.current_device()) if backend_is_nccl(group)
           else torch.device("cpu"))
    root = dist.get_global_rank(group, 0)
    out: Optional[List[torch.Tensor]] = [] if rank == 0 else None
    for t in tensors:
        local = t.detach().to(dev).contiguous()
        if rank == 0:
            parts = torch.empty((n,) + tuple(local.shape), dtype=local.dtype, device=dev)
            dist.gather(local, list(parts.unbind(0)), dst=root, group=group)
            out.append(parts.cpu())
        else:
            dist.gather(local, None, dst=root, group=group)
    return out


def pipe_send_recv(send: Optional[torch.Tensor], recv: Optional[torch.Tensor], group, *,
                   backward: bool = False) -> None:
    """One boundary of a pipeline over ``group``'s ranks in rank order:
    ``send`` goes to the next rank, and ``recv`` (a contiguous tensor the
    caller allocates) is filled from the previous one; ``backward``: a
    cotangent, to the previous rank and from the next.  Either may be
    None: the pipe is no ring, so its first rank receives nothing forward
    and its last sends nothing.  The send and the receive are posted
    together in one ``batch_isend_irecv`` (no order of the ranks can
    deadlock), as ``ops.local_attention._ShiftRight`` does; over gloo the
    tensors go through the host, whose memory its point-to-point
    transport reads."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    step = -1 if backward else 1
    host = not backend_is_nccl(group)

    def peer(offset):
        if not 0 <= rank + offset < world:
            raise ValueError(f"rank {rank} of a {world}-stage pipe has no rank {rank + offset}")
        return dist.get_global_rank(group, rank + offset)

    ops, landing = [], recv
    if send is not None:
        buf = (send.detach().cpu() if host else send.detach()).contiguous()
        ops.append(dist.P2POp(dist.isend, buf, peer(step), group))
    if recv is not None:
        if host:
            landing = torch.empty(recv.shape, dtype=recv.dtype)
        ops.append(dist.P2POp(dist.irecv, landing, peer(-step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if landing is not recv:
        recv.copy_(landing)


def fold_in(generator: Optional[torch.Generator], rank: int) -> Optional[torch.Generator]:
    """A new generator on ``generator``'s device, seeded from one draw of
    ``generator`` and ``rank``: ranks holding equal generators get
    independent streams, and each advances its own equally."""
    if generator is None:
        return None
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device))
    mixed = (seed ^ ((rank + 1) * 0x9E3779B97F4A7C15)) & (2 ** 63 - 1)
    return torch.Generator(device=generator.device).manual_seed(mixed)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], nprocs: int, *, env: Optional[Dict[str, str]] = None,
           timeout: Optional[float] = None, cwd: Optional[str] = None) -> None:
    """Run ``argv`` as ``nprocs`` rank processes on this host with
    torchrun's environment (rendezvous on a free local port) and wait for
    them.  Raises if one exits non-zero, killing the others, or if they
    outlive ``timeout`` seconds."""
    port = _free_port()
    base = dict(os.environ if env is None else env)
    procs = []
    try:
        for r in range(nprocs):
            e = dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(nprocs),
                     LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port))
            procs.append(subprocess.Popen(list(argv), env=e, cwd=cwd))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} exited with code {bad[0][1]}")
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"{nprocs} ranks outlived {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()

"""The collectives of sequence parallelism, written out (the JAX package
gets them from GSPMD and `jax.lax.ppermute`).

* `ring_shift`   sends tensors to rank + 1 and receives the same shapes from
                 rank - 1, through `dist.batch_isend_irecv`;
* `all_reduce_`  sums tensors over the group in place, in buckets;
* `broadcast_`   copies rank 0's tensors to every rank in place.

Under a staged group (gloo over CUDA tensors: ranks that share a card) each
collective copies its tensors into pinned host buffers, runs there and
copies the result back: gloo moves host memory. `ring_shift.bytes` counts
the bytes each call sends, so a run can report what its ring moved.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from edgerunner_tpu_torch.parallel.mesh import SequenceParallel

BUCKET_BYTES = 64 * 2 ** 20  # all-reduce bucket


def _to_host(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Pinned host copies of CUDA tensors, complete on return."""
    hosts = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in xs]
    for h, x in zip(hosts, xs):
        h.copy_(x, non_blocking=True)
    torch.cuda.current_stream(xs[0].device).synchronize()
    return hosts


def ring_shift(xs: Sequence[torch.Tensor], sp: SequenceParallel) -> List[torch.Tensor]:
    """Each x goes to rank + 1; returns the tensors rank - 1 sent, in order.
    Every rank of the group must call it with the same shapes and dtypes."""
    if sp.size == 1:
        return list(xs)
    xs = [x.contiguous() for x in xs]
    nxt = dist.get_global_rank(sp.group, (sp.rank + 1) % sp.size)
    prv = dist.get_global_rank(sp.group, (sp.rank - 1) % sp.size)
    send = _to_host(xs) if sp.staged else xs
    recv = [torch.empty(x.shape, dtype=x.dtype, device=x.device, pin_memory=sp.staged)
            for x in send]
    ops = [dist.P2POp(dist.isend, x, nxt, sp.group) for x in send]
    ops += [dist.P2POp(dist.irecv, x, prv, sp.group) for x in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    ring_shift.bytes += sum(x.numel() * x.element_size() for x in xs)
    if sp.staged:
        return [r.to(x.device, non_blocking=True) for r, x in zip(recv, xs)]
    return recv


ring_shift.bytes = 0


def _buckets(xs: Sequence[torch.Tensor]):
    """Runs of tensors of one dtype of about BUCKET_BYTES each."""
    run, size = [], 0
    for x in xs:
        if run and (x.dtype != run[0].dtype or size + x.numel() * x.element_size() > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(x)
        size += x.numel() * x.element_size()
    if run:
        yield run


@torch.no_grad()
def all_reduce_(xs: Sequence[torch.Tensor], sp: SequenceParallel) -> None:
    """Sum each tensor over the group, in place, bucket by bucket."""
    if sp.size == 1:
        return
    for run in _buckets(xs):
        flat = torch.cat([x.reshape(-1) for x in run])
        buf = _to_host([flat])[0] if sp.staged else flat
        dist.all_reduce(buf, group=sp.group)
        if sp.staged:
            flat.copy_(buf)
        offset = 0
        for x in run:
            x.copy_(flat[offset:offset + x.numel()].view_as(x))
            offset += x.numel()


@torch.no_grad()
def broadcast_(xs: Sequence[torch.Tensor], sp: SequenceParallel) -> None:
    """Rank 0's values of each tensor on every rank, in place."""
    if sp.size == 1:
        return
    src = dist.get_global_rank(sp.group, 0)
    for x in xs:
        buf = _to_host([x])[0] if sp.staged else x
        dist.broadcast(buf, src, group=sp.group)
        if sp.staged:
            x.copy_(buf)


def assert_same_on_every_rank(value: torch.Tensor, what: str, sp: SequenceParallel) -> None:
    """Raise unless the scalar `value` (on this rank's device) is equal on
    every rank: its max and its min over the group agree, in f64."""
    if sp.size == 1:
        return
    both = torch.stack([value, -value]).double()
    if dist.get_backend(sp.group) == "gloo":
        both = both.cpu()
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=sp.group)
    if both[0].item() != -both[1].item():
        raise RuntimeError(f"{what} differs between the sp ranks "
                           f"(max {both[0].item()}, min {-both[1].item()})")

"""The collectives of data and sequence parallelism, written out (the JAX
package gets them from GSPMD and `jax.lax.ppermute`).

* `ring_shift`   sends tensors to rank + 1 and receives the same shapes from
                 rank - 1 of the group, through `dist.batch_isend_irecv`;
* `all_reduce_`  sums tensors over the group in place, in buckets;
* `broadcast_`   copies the group's rank 0's tensors to every rank in place;
* `dp_total`     the sum of a per-dp-group value over the dp groups;
* `all_gather`   every rank's copy of a tensor, in rank order;
* `gather_list` / `gather_to_first`  the ranks' tensors on the group's
                 rank 0, as a list or concatenated;
* `ep_sum` / `ep_sum_grad`  expert parallelism's two ops with explicit
                 autograd (models/moe.py): the first sums its input over
                 the ep group and passes the gradient through; the second
                 passes its input through and sums the gradient over the
                 group;
* `copy_to_tp` / `reduce_from_tp`  Megatron's two (f and g): before a
                 column-parallel layer the identity with its gradient
                 summed over the tp group, after a row-parallel layer the
                 sum over the group with the gradient passed through;
* `gather_from_tp`  the ranks' column shards concatenated along the last
                 dimension, each rank's gradient its own columns' (the
                 vocabulary-parallel logits);
* `lora_down_tp`  x @ A of a LoRA adapter whose A is whole on every tp rank
                 and whose B is split: the gradient that reaches A is
                 summed over the group, the one that reaches x is not;
* `send_` / `recv_`  a tensor to and from one rank of a group (the
                 pipeline's stages).

Under a staged group (gloo over CUDA tensors: ranks that share a card) each
collective copies its tensors into pinned host buffers, runs there and
copies the result back: gloo moves host memory. `ring_shift.bytes` counts
the bytes each call sends, `all_reduce_.bytes` those each call sums and
`ep_sum.bytes` those that the two ep ops sum and `reduce_from_tp.bytes`
those that the tp ops sum or gather (parts of all_reduce_'s), and
`send_.bytes` those that the pipeline's stages send, so a run can report
what its collectives moved.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from edgerunner_tpu_torch.parallel.mesh import DataParallel, Group, SequenceParallel

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
        all_reduce_.bytes += flat.numel() * flat.element_size()
        if sp.staged:
            flat.copy_(buf)
        offset = 0
        for x in run:
            x.copy_(flat[offset:offset + x.numel()].view_as(x))
            offset += x.numel()


all_reduce_.bytes = 0


def dp_total(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """The sum over the dp groups of a scalar `x` that every sp rank of a
    group holds alike (a label count, a row count): its sum over the ranks
    that hold this rank's parameters (`dp.data`, dp × sp of them) divided
    by sp, exact for integers. A new tensor; `x` is left as it is."""
    total = x.detach().reshape(1).clone()
    all_reduce_([total], dp.data)
    per = dp.sp_size  # ranks per dp group in `data`, which hold x alike
    total = total // per if not total.is_floating_point() else total / per
    return total[0]


@torch.no_grad()
def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `x` (same shape and dtype on each), in the group's rank
    order, on x's device."""
    if group.size == 1:
        return [x]
    x = x.contiguous()
    buf = _to_host([x])[0] if group.staged else x
    outs = [torch.empty_like(buf) for _ in range(group.size)]
    dist.all_gather(outs, buf, group=group.group)
    return [o.to(x.device) for o in outs] if group.staged else outs


@torch.no_grad()
def gather_list(x: torch.Tensor, group) -> Optional[List[torch.Tensor]]:
    """The group's tensors `x` (same shape on each), in rank order, as CPU
    tensors on the group's rank 0; None on the others. `x` may lie on the
    host (a tp split joined there, gathered next over pp or ep): under
    NCCL, which moves device memory only, it goes to this rank's card."""
    if group.size == 1:
        return [x.detach().cpu()]
    buf = x.detach().contiguous()
    if group.staged or dist.get_backend(group.group) == "gloo":
        buf = buf.cpu()
    elif buf.device.type == "cpu":
        buf = buf.cuda()
    dst = dist.get_global_rank(group.group, 0)
    outs = [torch.empty_like(buf) for _ in range(group.size)] if group.rank == 0 else None
    dist.gather(buf, outs, dst=dst, group=group.group)
    return [o.cpu() for o in outs] if group.rank == 0 else None


def gather_to_first(x: torch.Tensor, group) -> Optional[torch.Tensor]:
    """The group's tensors `x` (same shape on each) concatenated along dim
    0 in rank order, as a CPU tensor on the group's rank 0; None on the
    others."""
    parts = gather_list(x, group)
    return None if parts is None else torch.cat(parts)


class _Sum(torch.autograd.Function):
    """Forward: the sum of x over the group; backward: the identity. `op`
    is the public function whose byte counter it adds to."""

    @staticmethod
    def forward(ctx, x, group, op):
        y = x.clone()
        all_reduce_([y], group)
        op.bytes += y.numel() * y.element_size()
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    """Forward: the identity; backward: the sum of the gradient over the
    group."""

    @staticmethod
    def forward(ctx, x, group, op):
        ctx.group, ctx.op = group, op
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce_([g], ctx.group)
        ctx.op.bytes += g.numel() * g.element_size()
        return g, None, None


def _trivial(group: Optional[Group]) -> bool:
    return group is None or group.size == 1


def ep_sum(x: torch.Tensor, ep: Optional[Group]) -> torch.Tensor:
    """x summed over the ep group (each rank's partial combine of its own
    experts); the gradient passes through unchanged, as every rank holds
    the same downstream. x itself without ep."""
    return x if _trivial(ep) else _Sum.apply(x, ep, ep_sum)


ep_sum.bytes = 0


def ep_sum_grad(x: torch.Tensor, ep: Optional[Group]) -> torch.Tensor:
    """x unchanged, with its gradient summed over the ep group: what enters
    a rank's local experts (the tokens, the gates), whose gradient each rank
    holds only for its own experts' share."""
    return x if _trivial(ep) else _SumGrad.apply(x, ep, ep_sum)


def copy_to_tp(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """Megatron's f: x unchanged, its gradient summed over the tp group. It
    stands before a column-parallel layer, whose ranks each send back the
    gradient of their own columns only."""
    return x if _trivial(tp) else _SumGrad.apply(x, tp, reduce_from_tp)


def reduce_from_tp(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """Megatron's g: the sum over the tp group of each rank's partial
    product (a row-parallel layer's); the gradient passes through, as every
    rank holds the same downstream."""
    return x if _trivial(tp) else _Sum.apply(x, tp, reduce_from_tp)


reduce_from_tp.bytes = 0


class _GatherLast(torch.autograd.Function):
    """Forward: the group's x concatenated along the last dim in rank
    order; backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.rank, ctx.n = tp.rank, x.shape[-1]
        parts = all_gather(x, tp)
        reduce_from_tp.bytes += x.numel() * x.element_size() * tp.size
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n].contiguous(), None


def gather_from_tp(x: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """The tp ranks' column shards of a column-parallel output (the logits
    over a vocabulary shard each) concatenated along the last dimension;
    each rank's gradient is its own columns'."""
    return x if _trivial(tp) else _GatherLast.apply(x, tp)


class _LoraDown(torch.autograd.Function):
    """u = x @ a, with the gradient of `a` summed over the group and the
    gradient of x left this rank's."""

    @staticmethod
    def forward(ctx, x, a, tp):
        ctx.save_for_backward(x, a)
        ctx.tp = tp
        return x @ a.to(x.dtype)  # under autocast, in its dtype

    @staticmethod
    def backward(ctx, du):
        x, a = ctx.saved_tensors
        dx = (du @ a.t().to(du.dtype)).to(x.dtype)
        du = du.clone()
        all_reduce_([du], ctx.tp)
        reduce_from_tp.bytes += du.numel() * du.element_size()
        da = x.reshape(-1, x.shape[-1]).t().to(du.dtype) @ du.reshape(-1, du.shape[-1])
        return dx, da.to(a.dtype), None


def lora_down_tp(x: torch.Tensor, a: torch.Tensor, tp: Optional[Group]) -> torch.Tensor:
    """A column-parallel LoRA layer's x @ lora_a: `a` is whole on every tp
    rank and `x` went through `copy_to_tp`, while the rank's lora_b holds
    only its columns. So the gradient of u = x @ a is this rank's share: it
    goes to x as it is (copy_to_tp sums it) and to `a` summed over the
    group, so that a's gradient is whole, and the same, on every rank."""
    return x @ a if _trivial(tp) else _LoraDown.apply(x, a, tp)


@torch.no_grad()
def broadcast_(xs: Sequence[torch.Tensor], sp: Group, src: int = 0) -> None:
    """The group's rank `src`'s values of each tensor on every rank, in
    place."""
    if sp.size == 1:
        return
    src = dist.get_global_rank(sp.group, src)
    for x in xs:
        buf = _to_host([x])[0] if sp.staged else x
        dist.broadcast(buf, src, group=sp.group)
        if sp.staged:
            x.copy_(buf)


@torch.no_grad()
def send_(x: torch.Tensor, dst: int, group: Group) -> None:
    """x to the group's rank `dst` (blocking)."""
    x = x.contiguous()
    buf = _to_host([x])[0] if group.staged else x
    dist.send(buf, dist.get_global_rank(group.group, dst), group=group.group)
    send_.bytes += x.numel() * x.element_size()


send_.bytes = 0


@torch.no_grad()
def recv_(shape, dtype, device, src: int, group: Group) -> torch.Tensor:
    """A tensor of `shape` and `dtype` from the group's rank `src`, on
    `device`."""
    buf = torch.empty(shape, dtype=dtype, device="cpu" if group.staged else device,
                      pin_memory=group.staged)
    dist.recv(buf, dist.get_global_rank(group.group, src), group=group.group)
    return buf.to(device, non_blocking=True) if group.staged else buf


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

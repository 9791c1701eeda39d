"""Ring attention: exact attention over a sequence sharded across the ranks
of an sp group (edgerunner_tpu/ops/ring_attention.py:40-103, :173).

Each rank holds the shards q/k/v [B, S, H, D] of positions
[rank * S, (rank + 1) * S). Its K/V shard travels around the ring, rank to
rank + 1 (parallel/collectives.py `ring_shift`), while every rank attends
its queries to the shard it holds and merges the partial results in f32 in
log space by their lse, as `_merge` does. The per-block attention is TPU
row 5, `flash_attention_lse` (ops/flash_attention.py): the forward kernel
for a CUDA tensor, the plain version for a CPU tensor. No block materialises
an [S, S] score matrix on the card.

Causal: step 0 is the rank's own diagonal block (causal); after s shifts a
rank holds shard rank - s, fully visible if s <= rank and fully in the
future otherwise. The skip is a host `if`, so a dead block launches nothing.

`RingAttention` is a `torch.autograd.Function` and not left to autograd,
because the collectives must be the same on every rank in the forward and in
the backward. Autograd of the shifts would give rank 0, whose shifted K/V
feed only dead blocks, no backward shifts to issue while rank 1 waits on
them: the job would hang. Here every rank issues R - 1 shifts of (K, V) in
the forward and, in the backward, R - 1 shifts of (K, V, dK, dV) and one
last shift of (dK, dV) that brings each shard's gradient home, dead blocks
included.

The backward's algebra. Let O and lse be the merged output and row
log-sum-exp, o_b and lse_b block b's, so O = sum_b w_b o_b with
w_b = exp(lse_b - lse). JAX's autodiff of the merges hands block b the
cotangents do_b = w_b dO and dlse_b = w_b (rowsum(dO * o_b) - rowsum(dO * O)).
The block's backward forms ds = p_b * (dp_b - (delta_b - dlse_b)) with
p_b = exp(s - lse_b), dp_b = do_b V_b^T and delta_b = rowsum(do_b * o_b),
so delta_b - dlse_b = w_b rowsum(dO * O). Then w_b cancels:
p_b w_b = exp(s - lse) = P, the merged probabilities, and
ds = P * (dO V_b^T - rowsum(dO * O)). That is the backward kernel called
with the merged O and lse, dO and no dlse: `flash_attention_lse_bwd` per
live block, dq summed over blocks, dK/dV summed as they travel.
"""

from __future__ import annotations

import torch

from edgerunner_tpu_torch.ops.flash_attention import flash_attention_lse, flash_attention_lse_bwd
from edgerunner_tpu_torch.parallel.collectives import ring_shift
from edgerunner_tpu_torch.parallel.mesh import SequenceParallel

__all__ = ["RingAttention", "ring_attention", "ring_self_attention"]


def _merge(o_run, lse_run, o_blk, lse_blk):
    """Merge two normalised partial results in log space
    (ring_attention.py:40-51): o_* [B, S, H, D] (o_run f32), lse_* [B, S, H]
    f32. A block without live keys carries lse ~ -1e30 and weight 0."""
    m = torch.maximum(lse_run, lse_blk)
    wa = torch.exp(lse_run - m)
    wb = torch.exp(lse_blk - m)
    denom = wa + wb
    o = o_run * wa[..., None] + o_blk.float() * wb[..., None]
    return o / denom[..., None], m + torch.log(denom)


def _live(causal: bool, step: int, rank: int) -> bool:
    """Whether the shard held after `step` shifts is visible to this rank."""
    return not causal or step <= rank


class RingAttention(torch.autograd.Function):
    """Exact attention of local shards q/k/v [B, S, H, D] over the sp group
    `sp`; returns the local output shard [B, S, H, D]."""

    @staticmethod
    def forward(ctx, q, k, v, sp: SequenceParallel, causal: bool):
        o, lse = flash_attention_lse(q, k, v, causal=causal)
        o_run = o.float()
        k_cur, v_cur = k, v
        for step in range(1, sp.size):
            k_cur, v_cur = ring_shift([k_cur, v_cur], sp)
            if _live(causal, step, sp.rank):
                o_blk, lse_blk = flash_attention_lse(q, k_cur, v_cur, causal=False)
                o_run, lse = _merge(o_run, lse, o_blk, lse_blk)
        out = o_run.to(q.dtype)
        ctx.sp, ctx.causal = sp, causal
        ctx.save_for_backward(q, k, v, out, lse.contiguous())
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        sp, causal = ctx.sp, ctx.causal
        do = do.contiguous()
        dq = torch.zeros_like(q, dtype=torch.float32)
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(v, dtype=torch.float32)
        k_cur, v_cur = k, v
        for step in range(sp.size):
            if step:
                k_cur, v_cur, dk, dv = ring_shift([k_cur, v_cur, dk, dv], sp)
            if _live(causal, step, sp.rank):
                dq_b, dk_b, dv_b = flash_attention_lse_bwd(
                    q, k_cur, v_cur, out, lse, do, causal=causal and step == 0)
                dq += dq_b
                dk += dk_b
                dv += dv_b
        # after R - 1 shifts each rank holds the accumulators of shard
        # rank + 1: one more shift brings every shard's gradient home
        dk, dv = ring_shift([dk, dv], sp)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q, k, v, sp: SequenceParallel, *, causal: bool = True):
    """Differentiable ring attention of local shards (ring_attention.py:54)."""
    return RingAttention.apply(q, k, v, sp, causal)


def ring_self_attention(q, k, v, sp: SequenceParallel, *, causal: bool = True):
    """Full arrays [B, N, H, D] on every rank in, exact attention of the
    whole sequence out (ring_attention.py:173): each rank attends its shard
    of N through the ring, and the shards' outputs are gathered. N must
    divide over the group. For tests and the smoke run; gradients reach
    q, k and v through the rank's own shard."""
    shards = [sp.shard(x).contiguous() for x in (q, k, v)]
    return _Gather.apply(ring_attention(*shards, sp, causal=causal), sp)


class _Gather(torch.autograd.Function):
    """Concatenate every rank's shard along dim 1; the gradient of the
    whole is cut back to the rank's own shard."""

    @staticmethod
    def forward(ctx, x, sp: SequenceParallel):
        ctx.sp = sp
        parts = [x.contiguous()]
        held = parts[0]
        for _ in range(1, sp.size):
            (held,) = ring_shift([held], sp)
            parts.append(held)
        # after s shifts a rank holds the shard of rank - s
        order = sorted(range(sp.size), key=lambda s: (sp.rank - s) % sp.size)
        return torch.cat([parts[s] for s in order], dim=1)

    @staticmethod
    def backward(ctx, grad):
        return ctx.sp.shard(grad).contiguous(), None

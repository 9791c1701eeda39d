"""Mixture-of-Experts decoder MLP of the port (edgerunner_tpu/models/moe.py:41-97).

`--moe_experts E` replaces each decoder layer's fc1/ReLU/fc2 with E experts
of that shape, stacked as [E, ...] parameters (`w1` [E, C, F], `b1` [E, F],
`w2` [E, F, C], `b2` [E, C]), and a router `router` (Linear C -> E). The
routing is the JAX package's GShard dense dispatch, computed exactly:

* the router runs in f32 (its weights stay f32 in a bf16 model, and under
  autocast its product is taken with autocast off), softmax, top-k with
  ties to the lower expert index (`jax.lax.top_k`'s order: a stable
  descending sort), the k gates renormalised to sum to 1;
* each expert takes at most cap = max(1, ceil(K · N / E · capacity_factor))
  tokens, N the tokens routed together; queue positions follow a cumulative
  count in k-major order (every token's first choice before any second
  choice), and an assignment past its expert's capacity is dropped (its
  gate mass is absent from the combine);
* the experts run in the compute dtype; the Switch load-balance loss
  E · Σ_e f_e · P_e (f_e the share of first choices, P_e the mean
  probability) is returned beside the output, and the training loss adds
  `moe_aux_weight` × its mean over the layers (models/lmm.py).

Two formulations of the dispatch, one routing: `combine_onehot`, the JAX
package's one-hot einsums over [N, E, cap] (the plain version: CPU tensors,
`use_kernels=False` and the tests), and `combine_index`, which moves rows
by index: a gather of the tokens into [E, cap, C], the experts as batched
products, and a gather of each assignment's expert output, weighted by its
gate in a batched product. At the train batch (N = 12,294, E 4, K 2, cap
7,684) the one-hot tensors would take 1.5-3 GB each and their products as
many operations as the experts; the JAX package computes them outside any
Pallas kernel, so neither formulation is a kernel. A CUDA tensor takes
`combine_index`, with no host synchronisation.

The set of tokens routed together is the caller's: the whole training
batch (padding and condition tokens included), the prefill's [B, P], a
decode step's B rows, a verify pass's B × T, an engine segment's slots,
a pipeline's microbatch (models/shape_opt.py). Under a dp or sp context
(parallel/mesh.py) the training step routes the global batch, as the JAX
step does over its mesh (GSPMD routes the whole sequence; only the
attention is shard_mapped): N and the capacity are those of every rank's
tokens, and each token's queue position counts the same choice of every
token before it in (dp group, row, sp shard, position) order, from an
all-gather of the ranks' per-row counts (`route`); the aux loss is this
rank's share.

Expert parallelism (`ep`, a parallel/mesh.py `ExpertParallel`): this rank
holds experts [ep.rank · E/ep, (ep.rank + 1) · E/ep) and routes every token
of its group as the others do. What enters its experts (the tokens, the
gates) goes through `ep_sum_grad`, whose backward sums the gradient over
the group, and its partial combine through `ep_sum`, which sums it; so
every rank of the group holds the whole output and the whole gradient of
every non-expert parameter, and its experts' own.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from edgerunner_tpu_torch.parallel.collectives import all_gather, ep_sum, ep_sum_grad
from edgerunner_tpu_torch.parallel.mesh import (
    DataParallel,
    ExpertParallel,
    SequenceParallel,
    active_data_parallel,
    active_sequence_parallel,
)

EXPERT_PARAMS = ("w1", "b1", "w2", "b2")


def is_expert_param(name: str) -> bool:
    """Whether a parameter name is a stacked expert weight (sharded over ep)."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in EXPERT_PARAMS


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest probabilities per row, ties to the
    lower index, as jax.lax.top_k orders them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, top: int, capacity_factor: float,
          dp: Optional[DataParallel] = None, sp: Optional[SequenceParallel] = None,
          with_aux: bool = True, rows: int = 1) -> dict:
    """The routing of N tokens, `rows` rows of N / rows positions each, from
    their f32 router logits [N, E] (moe.py:58-71): probs [N, E], gate
    [N, K] (renormalised), idx [N, K], pos [N, K] (queue position in the
    expert idx), keep [N, K] (pos < cap), cap, and with `with_aux` the aux
    loss (this rank's share under `dp` or `sp`), else None.

    The JAX step routes its whole batch, whatever shards it: the tokens in
    (dp group, row, sp shard, position) order. So under `dp` or `sp` each
    rank's (row, k, expert) counts are gathered over the ranks that hold
    the batch's other rows and positions (`dp.data`, or the sp group: the
    order d · sp + s), and a token's queue position starts after every
    earlier choice of the whole batch (k-major), then the same choice of
    the earlier dp groups, of the earlier rows of its group, and of its
    row's earlier shards."""
    N, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, top)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = F.one_hot(idx, E).view(rows, N // rows, top, E)       # [B, T, K, E]
    counts = onehot.sum(1)                                         # [B, K, E]
    group = dp.data if dp is not None else sp
    if group is None:
        every = counts[None, None]
    else:
        # every rank routes as many tokens: the trainer pads the dp groups'
        # rows to one length, as the JAX step's global batch has one
        dp_size, sp_size = (dp.size, dp.sp_size) if dp is not None else (1, sp.size)
        every = torch.stack(all_gather(counts, group)).view(dp_size, sp_size, *counts.shape)
    d = 0 if dp is None else dp.rank
    s = 0 if sp is None else sp.rank
    total = every.sum((0, 1, 2))                                   # [K, E]
    group_rows = every[d].sum(0)                                   # [B, K, E]
    offset = (total.cumsum(0) - total + every[:d].sum((0, 1, 2))
              + group_rows.cumsum(0) - group_rows + every[d, :s].sum(0))
    n_all = every.shape[0] * every.shape[1] * N
    cap = max(1, int(math.ceil(top * n_all / E * capacity_factor)))
    # the cumulative count includes the token itself
    pos = (onehot.cumsum(1) + offset[:, None]).view(N, top, E).gather(-1, idx[..., None])[..., 0]
    pos = pos - 1
    aux = None
    if with_aux:  # Switch loss: E * sum_e(share of first choices * mean probability)
        if group is None:
            aux = E * torch.sum(total[0].float() / N * probs.mean(0))
        else:
            aux = E * torch.sum(total[0].float() / n_all * (probs.sum(0) / n_all))
    return {"probs": probs, "gate": gate, "idx": idx, "pos": pos, "keep": pos < cap,
            "cap": cap, "aux": aux}


def _experts(xe, w1, b1, w2, b2):
    """The experts on their queues xe [E, cap, C] in the compute dtype (xe's,
    or autocast's), each bias added in the product's dtype."""
    he = torch.bmm(xe, w1.to(xe.dtype))
    he = F.relu(he + b1.to(he.dtype)[:, None])
    ye = torch.bmm(he, w2.to(he.dtype))
    return ye + b2.to(ye.dtype)[:, None]


def combine_onehot(xf, r: dict, w1, b1, w2, b2, first: int = 0):
    """The plain version: the JAX package's one-hot dispatch and combine
    [N, E, cap] and einsums (moe.py:72-90), over the experts
    [first, first + w1.shape[0]). Returns [N, C] in the compute dtype."""
    E_loc, cap = w1.shape[0], r["cap"]
    local = r["idx"] - first
    inside = r["keep"] & (local >= 0) & (local < E_loc)
    onehot = F.one_hot(local.clamp(0, E_loc - 1), E_loc).float() * inside[..., None]
    slot = onehot[..., None] * F.one_hot(r["pos"].clamp(0, cap - 1), cap).float()[:, :, None]
    dispatch = slot.sum(1)                                         # [N, E, cap]
    combine = (r["gate"][..., None, None] * slot).sum(1)           # [N, E, cap]
    xe = torch.einsum("nec,nd->ecd", dispatch.to(xf.dtype), xf)
    ye = _experts(xe, w1, b1, w2, b2)
    return torch.einsum("nec,ecd->nd", combine.to(ye.dtype), ye)


def combine_index(xf, r: dict, w1, b1, w2, b2, first: int = 0):
    """The same function by index: each kept assignment of the experts
    [first, first + w1.shape[0]) to its slot e · cap + pos, the tokens
    gathered into [E, cap, C] (empty slots read a zero row), the experts as
    batched products, each assignment's output gathered back and weighted
    by its gate in one batched product over the k choices (the gates in
    the compute dtype, as the JAX combine casts them). No host sync."""
    N, C = xf.shape
    E_loc, cap = w1.shape[0], r["cap"]
    dump = E_loc * cap                                             # the slot of dropped ones
    if E_loc == r["probs"].shape[1]:
        slot = torch.where(r["keep"], r["idx"] * cap + r["pos"], dump)   # [N, K]
    else:
        local = r["idx"] - first
        inside = r["keep"] & (local >= 0) & (local < E_loc)
        slot = torch.where(inside, local * cap + r["pos"], dump)
    K = slot.shape[1]
    src = torch.full((dump + 1,), N, dtype=torch.long, device=xf.device)
    src.scatter_(0, slot.reshape(-1), torch.arange(N * K, device=xf.device) // K)
    xe = F.pad(xf, (0, 0, 0, 1))[src[:dump]].view(E_loc, cap, C)
    ye = _experts(xe, w1, b1, w2, b2)
    picked = F.pad(ye.reshape(dump, C), (0, 0, 0, 1))[slot]        # [N, K, C]
    return torch.bmm(r["gate"].to(ye.dtype)[:, None], picked)[:, 0]


class MoEMLP(nn.Module):
    """The routed MLP (moe.py:41-97): forward(x [B, T, C]) -> (y [B, T, C]
    in the compute dtype, aux loss scalar, or None without `with_aux`: the
    decode paths and the eval loss leave it out, as the JAX package's sow
    outside training does). With `ep`, this rank's E / ep experts only. `use_kernels=False`, or a CPU tensor, takes the plain
    one-hot formulation; `dispatch` ('index' or 'onehot') forces one."""

    def __init__(self, hidden_dim: int, intermediate_dim: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25, *, use_kernels: bool = True,
                 ep: Optional[ExpertParallel] = None, device=None, dtype=None):
        super().__init__()
        self.num_experts, self.top_k, self.capacity_factor = num_experts, top_k, capacity_factor
        self.use_kernels = use_kernels
        self.ep = ep if ep is not None and ep.size > 1 else None
        size = 1 if self.ep is None else self.ep.size
        if num_experts % size:
            raise ValueError(f"{num_experts} experts do not divide over {size} ep ranks")
        local = num_experts // size
        self.first = 0 if self.ep is None else self.ep.rank * local
        self.dispatch: Optional[str] = None
        kw = dict(device=device, dtype=dtype)
        C, F_ = hidden_dim, intermediate_dim
        # the router in f32 whatever the model's dtype (moe.py:58-63)
        self.router = nn.Linear(C, num_experts, device=device, dtype=torch.float32)
        self.w1 = nn.Parameter(torch.empty(local, C, F_, **kw))
        self.b1 = nn.Parameter(torch.zeros(local, F_, **kw))
        self.w2 = nn.Parameter(torch.empty(local, F_, C, **kw))
        self.b2 = nn.Parameter(torch.zeros(local, C, **kw))

    @torch.no_grad()
    def init_experts(self, gen: torch.Generator, std: float = 0.02):
        """N(0, std) expert kernels and zero biases, drawn for all E experts
        and sliced to this rank's, so that any ep draws the same weights."""
        for p in (self.w1, self.w2):
            full = torch.empty((self.num_experts,) + p.shape[1:], dtype=p.dtype,
                               device=gen.device).normal_(0.0, std, generator=gen)
            p.copy_(full[self.first:self.first + p.shape[0]])
        self.b1.zero_()
        self.b2.zero_()

    def _logits(self, xf):
        """The router's logits in f32, with autocast off where it is on."""
        if not torch.is_autocast_enabled(xf.device.type):
            return F.linear(xf.float(), self.router.weight, self.router.bias)
        with torch.autocast(xf.device.type, enabled=False):
            return F.linear(xf.float(), self.router.weight, self.router.bias)

    def forward(self, x, with_aux: bool = True):
        B, T, C = x.shape
        xf = x.reshape(B * T, C)
        r = route(self._logits(xf), self.top_k, self.capacity_factor, active_data_parallel(),
                  active_sequence_parallel(), with_aux, rows=B)
        mode = self.dispatch or ("index" if self.use_kernels and x.is_cuda else "onehot")
        combine = combine_index if mode == "index" else combine_onehot
        r["gate"] = ep_sum_grad(r["gate"], self.ep)
        y = combine(ep_sum_grad(xf, self.ep), r, self.w1, self.b1, self.w2, self.b2,
                    self.first)
        return ep_sum(y, self.ep).reshape(B, T, C), r["aux"]

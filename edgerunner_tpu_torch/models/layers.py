"""Shared building blocks of the port (edgerunner_tpu/models/layers.py:28-217).

Parameter names follow the reference state_dict naming that
tools/export_reference_ckpt.py emits, so the reference checkpoints load with
`strict=True`. Every LayerNorm uses eps 1e-5; the GEGLU feed-forward uses the
tanh GELU that `jax.nn.gelu` defaults to.

`LoRALinear` is the JAX package's `LoRADense` (layers.py:28-64): a linear
layer with a low-rank adapter beside its weight and bias, `lora_a` [in, r]
and `lora_b` [r, out] in the JAX package's layout (N(0, 0.02) and zeros at
first, so a fresh adapter changes nothing), y = xWᵀ + b + (xA)B · α/r.
`merge_lora_state` folds the adapters of a state dict into its weights
(`merge_lora_tree`, layers.py:66-95).

Tensor parallelism (`tp`, a parallel/mesh.py `TensorParallel`), Megatron's
layout as the JAX package's `TP_RULES` (mesh.py:147-168) name it for the
modules called self_attn or att, fc1/fc2, GEGLU's fc_in/fc_out and
lm_head: an attention module holds H / tp of its
heads (its q/k/v projections' columns, the rows of its out_proj), an MLP
F / tp of its columns (fc1's or fc_in's, whose [h | gates] columns each
rank takes its share of, and the rows of fc2 or fc_out). The input of a
column-parallel layer goes through `copy_to_tp` and the output of a
row-parallel one through `reduce_from_tp` (parallel/collectives.py), its
bias added once after the sum (`column_linear`, `row_linear`). A module
whose heads or columns do not divide by tp stays whole (`tp_for`). Each
split parameter carries its (dimension, groups) as `tp_split`, which the
trainer's saves and loads read. LoRA's adapters follow their base
kernel's split: lora_b of a column layer, lora_a of a row layer. The
DiT's attn1/attn2 and the MoE router and experts stay whole, as no rule
names them (ep shards the experts).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from edgerunner_tpu_torch.ops.attention import attention, attention_reference
from edgerunner_tpu_torch.parallel.collectives import (
    copy_to_tp,
    lora_down_tp,
    reduce_from_tp,
)

LN_EPS = 1e-5


def tp_for(tp, *sizes: int):
    """`tp` when it has more than one rank and every one of `sizes` (head
    counts, column counts) divides by its size; else None: the module
    stays whole on every rank."""
    if tp is None or tp.size == 1 or any(n % tp.size for n in sizes):
        return None
    return tp


@torch.no_grad()
def normal_(t: torch.Tensor, mean: float, std: float, gen: torch.Generator) -> torch.Tensor:
    """`t` filled with N(mean, std) draws from `gen`, made on the generator's
    device: a tensor in host memory takes the values it would take there."""
    if t.device == gen.device:
        return t.normal_(mean, std, generator=gen)
    return t.copy_(torch.empty(t.shape, dtype=t.dtype, device=gen.device)
                   .normal_(mean, std, generator=gen))


def mark_split(p: nn.Parameter, dim: int, parts: int = 1) -> nn.Parameter:
    """Record on `p` that it is this rank's share along `dim` (in `parts`
    groups) of the whole tensor (parallel/mesh.py `tp_slice`)."""
    p.tp_split = (dim, parts)
    return p


def split_columns(lin: nn.Linear, parts: int = 1) -> nn.Linear:
    """Mark a column-parallel layer's weight, bias and lora_b."""
    mark_split(lin.weight, 0, parts)
    if lin.bias is not None:
        mark_split(lin.bias, 0, parts)
    if isinstance(lin, LoRALinear):
        mark_split(lin.lora_b, 1)
    return lin


def split_rows(lin: nn.Linear) -> nn.Linear:
    """Mark a row-parallel layer's weight and lora_a (its bias stays whole)."""
    mark_split(lin.weight, 1)
    if isinstance(lin, LoRALinear):
        mark_split(lin.lora_a, 0)
    return lin


def column_linear(lin: nn.Linear, x, tp):
    """A column-parallel layer on x, which went through `copy_to_tp`: this
    rank's columns. A LoRA adapter's lora_a, whole on every rank, takes its
    gradient summed over the group (`lora_down_tp`)."""
    if tp is None or not isinstance(lin, LoRALinear):
        return lin(x)
    y = F.linear(x, lin.weight, lin.bias)
    return y + lora_down_tp(x, lin.lora_a, tp) @ lin.lora_b.to(y.dtype) * lin.scale


def row_linear(lin: nn.Linear, x, tp):
    """A row-parallel layer on this rank's columns x: the partial products
    summed over the group, then the bias, once. A LoRA adapter's x @
    lora_a is summed before its lora_b, whole on every rank, so that
    lora_b's gradient is whole too."""
    if tp is None:
        return lin(x)
    y = reduce_from_tp(F.linear(x, lin.weight), tp)
    if isinstance(lin, LoRALinear):
        u = reduce_from_tp(x @ lin.lora_a.to(x.dtype), tp)
        y = y + u @ lin.lora_b.to(u.dtype) * lin.scale
    return y if lin.bias is None else y + lin.bias.to(y.dtype)


def attention_fn(use_kernels: bool):
    """The dispatching attention (kernel on CUDA tensors), or the plain
    version everywhere when a caller asks for the reference path."""
    return attention if use_kernels else attention_reference


class LoRALinear(nn.Linear):
    """nn.Linear with the adapters `lora_a` [in, rank] and `lora_b` [rank,
    out] in the same module, so that a dense checkpoint merges into it (the
    adapters missing, kept at their init) and the weight keeps its name."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 rank: int = 8, alpha: float = 16.0, device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device=device, dtype=dtype)
        self.rank, self.alpha = rank, alpha
        self.lora_a = nn.Parameter(torch.empty(in_features, rank, device=device, dtype=dtype))
        self.lora_b = nn.Parameter(torch.zeros(rank, out_features, device=device, dtype=dtype))

    @torch.no_grad()
    def init_adapters(self, gen: torch.Generator, std: float = 0.02):
        normal_(self.lora_a, 0.0, std, gen)
        self.lora_b.zero_()

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def forward(self, x):
        y = super().forward(x)
        return y + (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype) * self.scale


def linear_cls(lora_rank: int = 0, lora_alpha: float = 16.0):
    """The decoder projections' layer: nn.Linear, or LoRALinear under
    lora_rank (edgerunner_tpu/models/shape_opt.py:33-48)."""
    if not lora_rank:
        return nn.Linear
    return functools.partial(LoRALinear, rank=lora_rank, alpha=lora_alpha)


def merge_lora_state(state: dict, alpha: float = 16.0) -> dict:
    """{name: array} with every adapter folded into its weight, W += (AB ·
    α/r)ᵀ in f32 in the JAX order (k + (a @ b) · (α / r), layers.py:88-93;
    the port's weight is the kernel transposed), and the adapters dropped:
    a dense (lora_rank 0) state dict. The rank is read off lora_a; pass the
    lora_alpha the adapters were trained with."""
    out = {}
    for name, value in state.items():
        if name.endswith((".lora_a", ".lora_b")):
            continue
        prefix = name[:-len(".weight")] if name.endswith(".weight") else None
        if prefix is not None and prefix + ".lora_a" in state:
            a = torch.as_tensor(np.asarray(state[prefix + ".lora_a"]), dtype=torch.float32)
            b = torch.as_tensor(np.asarray(state[prefix + ".lora_b"]), dtype=torch.float32)
            k = torch.as_tensor(np.asarray(value), dtype=torch.float32).t()
            merged = k + torch.matmul(a, b) * (alpha / a.shape[-1])
            value = merged.t().numpy().astype(np.asarray(state[name]).dtype)
        out[name] = value
    return out


class SelfAttention(nn.Module):
    """Fused-QKV multi-head self-attention. Under `tp` each rank holds its
    heads of q, k and v alike: its share of each third of qkv_proj's
    columns."""

    def __init__(self, dim: int, hidden_dim: int, num_heads: int,
                 output_dim: Optional[int] = None, causal: bool = False, *,
                 use_kernels: bool = True, tp=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.tp = tp_for(tp, num_heads, hidden_dim)
        n = 1 if self.tp is None else self.tp.size
        self.num_heads, self.causal = num_heads // n, causal
        self.attend = attention_fn(use_kernels)
        self.qkv_proj = nn.Linear(dim, 3 * hidden_dim // n, **kw)
        self.out_proj = nn.Linear(hidden_dim // n, output_dim or hidden_dim, **kw)
        if self.tp is not None:
            split_columns(self.qkv_proj, 3)
            split_rows(self.out_proj)

    def forward(self, x, lengths=None):
        B, N, _ = x.shape
        H = self.num_heads
        q, k, v = self.qkv_proj(copy_to_tp(x, self.tp)).reshape(B, N, 3 * H, -1).chunk(3, dim=2)
        o = self.attend(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=self.causal, q_len=lengths, kv_len=lengths)
        return row_linear(self.out_proj, o.reshape(B, N, -1), self.tp)


class CrossAttention(nn.Module):
    """Q from x, K/V from context; under `tp` this rank's heads."""

    def __init__(self, query_dim: int, context_dim: int, hidden_dim: int,
                 num_heads: int, output_dim: Optional[int] = None, *,
                 use_kernels: bool = True, tp=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.tp = tp_for(tp, num_heads, hidden_dim)
        n = 1 if self.tp is None else self.tp.size
        self.num_heads = num_heads // n
        self.attend = attention_fn(use_kernels)
        self.q_proj = nn.Linear(query_dim, hidden_dim // n, **kw)
        self.k_proj = nn.Linear(context_dim, hidden_dim // n, **kw)
        self.v_proj = nn.Linear(context_dim, hidden_dim // n, **kw)
        self.out_proj = nn.Linear(hidden_dim // n, output_dim or hidden_dim, **kw)
        if self.tp is not None:
            for lin in (self.q_proj, self.k_proj, self.v_proj):
                split_columns(lin)
            split_rows(self.out_proj)

    def forward(self, x, context, q_len=None, kv_len=None):
        B, N, _ = x.shape
        M = context.shape[1]
        H = self.num_heads
        x, context = copy_to_tp(x, self.tp), copy_to_tp(context, self.tp)
        o = self.attend(self.q_proj(x).reshape(B, N, H, -1),
                        self.k_proj(context).reshape(B, M, H, -1),
                        self.v_proj(context).reshape(B, M, H, -1),
                        causal=False, q_len=q_len, kv_len=kv_len)
        return row_linear(self.out_proj, o.reshape(B, N, -1), self.tp)


class GEGLU(nn.Module):
    """h, gates = split(x); h * gelu_tanh(gates) (reference: point.py:68-84)."""

    def forward(self, x):
        h, gates = x.chunk(2, dim=-1)
        return h * F.gelu(gates, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward: net.0 (fc_in), net.1 (GEGLU), net.2 (fc_out).
    Under `tp` each rank holds its share of fc_in's h and gates columns
    alike, and those rows of fc_out."""

    def __init__(self, dim: int, mult: int = 4, *, tp=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.tp = tp_for(tp, dim * mult)
        n = 1 if self.tp is None else self.tp.size
        self.net = nn.Sequential(nn.Linear(dim, dim * mult * 2 // n, **kw), GEGLU(),
                                 nn.Linear(dim * mult // n, dim, **kw))
        if self.tp is not None:
            split_columns(self.net[0], 2)
            split_rows(self.net[2])

    def forward(self, x):
        if self.tp is None:
            return self.net(x)
        return row_linear(self.net[2], self.net[1](self.net[0](copy_to_tp(x, self.tp))),
                          self.tp)


def maybe_checkpoint(remat: bool, fn, *args):
    """fn(*args), under gradient checkpointing when `remat` is on and a
    gradient is being recorded (the port's `nn.remat`): the activations inside
    fn are recomputed in the backward pass instead of kept. The default
    `preserve_rng_state` replays dropout identically."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class ResCrossAttBlock(nn.Module):
    """Pre-LN residual cross-attention block (reference: point.py:108-126);
    `remat` checkpoints the whole block (edgerunner_tpu/models/layers.py:196-217)."""

    def __init__(self, dim: int, num_heads: int, *, use_kernels: bool = True,
                 remat: bool = False, tp=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.remat = remat
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.att = CrossAttention(dim, dim, dim, num_heads,
                                  use_kernels=use_kernels, tp=tp, **kw)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.mlp = FeedForward(dim, tp=tp, **kw)

    def _body(self, x, context):
        x = x + self.att(self.ln1(x), context)
        return x + self.mlp(self.ln2(x))

    def forward(self, x, context):
        return maybe_checkpoint(self.remat, self._body, x, context)

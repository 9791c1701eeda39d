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

LN_EPS = 1e-5


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
        self.lora_a.normal_(0.0, std, generator=gen)
        self.lora_b.zero_()

    def forward(self, x):
        y = super().forward(x)
        return y + (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype) * (self.alpha / self.rank)


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
    """Fused-QKV multi-head self-attention."""

    def __init__(self, dim: int, hidden_dim: int, num_heads: int,
                 output_dim: Optional[int] = None, causal: bool = False, *,
                 use_kernels: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads, self.causal = num_heads, causal
        self.attend = attention_fn(use_kernels)
        self.qkv_proj = nn.Linear(dim, 3 * hidden_dim, **kw)
        self.out_proj = nn.Linear(hidden_dim, output_dim or hidden_dim, **kw)

    def forward(self, x, lengths=None):
        B, N, _ = x.shape
        H = self.num_heads
        q, k, v = self.qkv_proj(x).reshape(B, N, 3 * H, -1).chunk(3, dim=2)
        o = self.attend(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=self.causal, q_len=lengths, kv_len=lengths)
        return self.out_proj(o.reshape(B, N, -1))


class CrossAttention(nn.Module):
    """Q from x, K/V from context."""

    def __init__(self, query_dim: int, context_dim: int, hidden_dim: int,
                 num_heads: int, output_dim: Optional[int] = None, *,
                 use_kernels: bool = True, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.attend = attention_fn(use_kernels)
        self.q_proj = nn.Linear(query_dim, hidden_dim, **kw)
        self.k_proj = nn.Linear(context_dim, hidden_dim, **kw)
        self.v_proj = nn.Linear(context_dim, hidden_dim, **kw)
        self.out_proj = nn.Linear(hidden_dim, output_dim or hidden_dim, **kw)

    def forward(self, x, context, q_len=None, kv_len=None):
        B, N, _ = x.shape
        M = context.shape[1]
        H = self.num_heads
        o = self.attend(self.q_proj(x).reshape(B, N, H, -1),
                        self.k_proj(context).reshape(B, M, H, -1),
                        self.v_proj(context).reshape(B, M, H, -1),
                        causal=False, q_len=q_len, kv_len=kv_len)
        return self.out_proj(o.reshape(B, N, -1))


class GEGLU(nn.Module):
    """h, gates = split(x); h * gelu_tanh(gates) (reference: point.py:68-84)."""

    def forward(self, x):
        h, gates = x.chunk(2, dim=-1)
        return h * F.gelu(gates, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward: net.0 (fc_in), net.1 (GEGLU), net.2 (fc_out)."""

    def __init__(self, dim: int, mult: int = 4, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.net = nn.Sequential(nn.Linear(dim, dim * mult * 2, **kw), GEGLU(),
                                 nn.Linear(dim * mult, dim, **kw))

    def forward(self, x):
        return self.net(x)


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
                 remat: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.remat = remat
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.att = CrossAttention(dim, dim, dim, num_heads,
                                  use_kernels=use_kernels, **kw)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.mlp = FeedForward(dim, **kw)

    def _body(self, x, context):
        x = x + self.att(self.ln1(x), context)
        return x + self.mlp(self.ln2(x))

    def forward(self, x, context):
        return maybe_checkpoint(self.remat, self._body, x, context)

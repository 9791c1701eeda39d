"""Shared building blocks of the port (edgerunner_tpu/models/layers.py:102-217).

Parameter names follow the reference state_dict naming that
tools/export_reference_ckpt.py emits, so the reference checkpoints load with
`strict=True`. Every LayerNorm uses eps 1e-5; the GEGLU feed-forward uses the
tanh GELU that `jax.nn.gelu` defaults to.
"""

from __future__ import annotations

from typing import Optional

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

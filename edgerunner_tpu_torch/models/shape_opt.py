"""ShapeOPT, the port's post-LN OPT decoder (edgerunner_tpu/models/shape_opt.py:180-719).

Learned absolute positions from 0, post-LN blocks LN(x + attn(x)) and
LN(x + fc2(relu(fc1(x)))), an `lm_head` without bias. Three modes:

* ``forward``  full-sequence teacher forcing, causal, with prefix `lengths`;
               in training, residual dropout and per-layer gradient
               checkpointing, and the shifted cross-entropy loss;
* ``prefill``  runs the prompt and returns per-layer packed caches
               [B, max_len, hidden] (zero past the prompt);
* ``step``     one token: writes its K/V row at `index` into the caches,
               then attends over rows [0, index].

Unlike the JAX package, whose arrays are immutable, ``step`` writes the
caches in place: they are preallocated once by ``prefill`` and reused by
every step, so a step moves no cache bytes beyond the attention's reads.
Only the non-quantised paths are ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edgerunner_tpu_torch.models.layers import LN_EPS, attention_fn, maybe_checkpoint
from edgerunner_tpu_torch.ops.decode_attention import (
    fused_decode_attention,
    fused_decode_attention_reference,
)

Caches = Tuple[List[torch.Tensor], List[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class ShapeOPTConfig:
    vocab_size: int = 518
    max_position_embeddings: int = 2048
    hidden_dim: int = 1024
    intermediate_dim: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    dropout: float = 0.1
    init_std: float = 0.02
    pad_token_id: int = 0
    # gradient checkpointing of each decoder layer in training
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_attention_heads


class OPTAttention(nn.Module):
    """Separate q/k/v/out projections with bias (reference: modeling_opt.py:164-167)."""

    def __init__(self, c: ShapeOPTConfig, *, use_kernels: bool = True,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = c.num_attention_heads
        self.attend = attention_fn(use_kernels)
        self.decode = (fused_decode_attention if use_kernels
                       else fused_decode_attention_reference)
        self.q_proj = nn.Linear(c.hidden_dim, c.hidden_dim, **kw)
        self.k_proj = nn.Linear(c.hidden_dim, c.hidden_dim, **kw)
        self.v_proj = nn.Linear(c.hidden_dim, c.hidden_dim, **kw)
        self.out_proj = nn.Linear(c.hidden_dim, c.hidden_dim, **kw)

    def _heads(self, x):
        B, N, C = x.shape
        return x.reshape(B, N, self.num_heads, C // self.num_heads)

    def forward(self, h, lengths=None):
        B, N, _ = h.shape
        o = self.attend(self._heads(self.q_proj(h)), self._heads(self.k_proj(h)),
                        self._heads(self.v_proj(h)), causal=True, q_len=lengths,
                        kv_len=lengths)
        return self.out_proj(o.reshape(B, N, -1))

    def prefill(self, h):
        """Causal attention over the prompt; returns (out, k, v) with k/v in
        the packed [B, P, hidden] layout of the cache."""
        B, P, _ = h.shape
        kf, vf = self.k_proj(h), self.v_proj(h)
        o = self.attend(self._heads(self.q_proj(h)), self._heads(kf),
                        self._heads(vf), causal=True)
        return self.out_proj(o.reshape(B, P, -1)), kf, vf

    def step(self, h, k_cache, v_cache, index: int):
        """h [B, 1, C]; writes this token's K/V row at `index` in place."""
        k_cache[:, index] = self.k_proj(h)[:, 0]
        v_cache[:, index] = self.v_proj(h)[:, 0]
        o = self.decode(self.q_proj(h)[:, 0], k_cache, v_cache, index,
                        num_heads=self.num_heads)
        return self.out_proj(o)[:, None]


class OPTDecoderLayer(nn.Module):
    """Post-LN OPT block (reference: modeling_opt.py:263-288)."""

    def __init__(self, c: ShapeOPTConfig, *, use_kernels: bool = True,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = OPTAttention(c, use_kernels=use_kernels, **kw)
        self.self_attn_layer_norm = nn.LayerNorm(c.hidden_dim, eps=LN_EPS, **kw)
        self.fc1 = nn.Linear(c.hidden_dim, c.intermediate_dim, **kw)
        self.fc2 = nn.Linear(c.intermediate_dim, c.hidden_dim, **kw)
        self.final_layer_norm = nn.LayerNorm(c.hidden_dim, eps=LN_EPS, **kw)
        self.dropout = c.dropout

    def _mlp(self, h, train: bool = False):
        m = F.dropout(self.fc2(F.relu(self.fc1(h))), self.dropout, training=train)
        return self.final_layer_norm(h + m)

    def forward(self, h, lengths=None, train: bool = False):
        """Residual dropout on the attention and MLP branches in training
        (edgerunner_tpu/models/shape_opt.py:412-426)."""
        a = F.dropout(self.self_attn(h, lengths), self.dropout, training=train)
        return self._mlp(self.self_attn_layer_norm(h + a), train)

    def prefill(self, h):
        a, k, v = self.self_attn.prefill(h)
        return self._mlp(self.self_attn_layer_norm(h + a)), k, v

    def step(self, h, k_cache, v_cache, index: int):
        a = self.self_attn.step(h, k_cache, v_cache, index)
        return self._mlp(self.self_attn_layer_norm(h + a))


class ShapeOPTDecoder(nn.Module):
    """Token + learned-position embedding, stacked OPT layers
    (reference: modeling_opt.py:307-426)."""

    def __init__(self, c: ShapeOPTConfig, *, use_kernels: bool = True,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.remat = c.remat
        self.embd = nn.Embedding(c.vocab_size, c.hidden_dim, **kw)
        self.embed_positions = nn.Embedding(c.max_position_embeddings, c.hidden_dim, **kw)
        self.layers = nn.ModuleList(
            OPTDecoderLayer(c, use_kernels=use_kernels, **kw)
            for _ in range(c.num_hidden_layers))

    def forward(self, inputs_embeds, lengths=None, train: bool = False):
        """With `cfg.remat`, each layer is checkpointed
        (edgerunner_tpu/models/shape_opt.py:524-538)."""
        if not inputs_embeds.is_floating_point():
            inputs_embeds = self.embd(inputs_embeds)
        T = inputs_embeds.shape[1]
        h = inputs_embeds + self.embed_positions.weight[:T]
        for layer in self.layers:
            h = maybe_checkpoint(self.remat, layer, h, lengths, train)
        return h

    def prefill(self, inputs_embeds, max_len: int):
        """Returns (hidden [B, P, C], caches): per-layer lists of
        [B, max_len, hidden] K and V buffers, zero past the prompt."""
        B, P, C = inputs_embeds.shape
        h = inputs_embeds + self.embed_positions.weight[:P]
        ks, vs = [], []
        for layer in self.layers:
            h, k, v = layer.prefill(h)
            for cache, rows in ((ks, k), (vs, v)):
                buf = torch.zeros((B, max_len, C), dtype=h.dtype, device=h.device)
                buf[:, :P] = rows
                cache.append(buf)
        return h, (ks, vs)

    def step(self, token_ids, caches: Caches, index: int):
        """token_ids [B, 1] at position `index`; updates the caches in place."""
        h = self.embd(token_ids) + self.embed_positions.weight[index]
        for layer, k, v in zip(self.layers, *caches):
            h = layer.step(h, k, v, index)
        return h


class ShapeOPT(nn.Module):
    """Decoder + LM head (reference: modeling_opt.py:429-517)."""

    def __init__(self, c: ShapeOPTConfig, *, use_kernels: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.cfg = c
        self.model = ShapeOPTDecoder(c, use_kernels=use_kernels, device=device,
                                     dtype=dtype)
        self.lm_head = nn.Linear(c.hidden_dim, c.vocab_size, bias=False,
                                 device=device, dtype=dtype)

    def forward(self, inputs_embeds, lengths=None, labels=None, train: bool = False):
        """Teacher-forcing logits [B, T, V]; with `labels`, (logits, loss)
        (edgerunner_tpu/models/shape_opt.py:673-686)."""
        logits = self.lm_head(self.model(inputs_embeds, lengths, train))
        if labels is None:
            return logits
        return logits, shifted_cross_entropy(logits, labels)

    def embed_tokens(self, ids):
        return self.model.embd(ids)

    def prefill(self, inputs_embeds, max_len: int):
        """Returns (next-token logits [B, 1, V], caches)."""
        h, caches = self.model.prefill(inputs_embeds, max_len)
        return self.lm_head(h[:, -1:]), caches

    def step(self, token_ids, caches: Caches, index: int):
        return self.lm_head(self.model.step(token_ids, caches, index))


def shifted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          shift: int = 1) -> torch.Tensor:
    """Mean cross-entropy of logits[:, :-shift] against labels[:, shift:] in
    f32 (or wider), ignoring label -100 (edgerunner_tpu/models/shape_opt.py:707-719)."""
    shift_logits = logits[:, :-shift].to(torch.promote_types(logits.dtype, torch.float32))
    shift_labels = labels[:, shift:].long()
    valid = shift_labels != -100
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, shift_labels, 0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)

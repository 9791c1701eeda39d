"""ShapeOPT, the port's post-LN OPT decoder (edgerunner_tpu/models/shape_opt.py:180-719).

Learned absolute positions from 0, post-LN blocks LN(x + attn(x)) and
LN(x + fc2(relu(fc1(x)))), an `lm_head` without bias. Four modes:

* ``forward``      full-sequence teacher forcing, causal, with prefix
                   `lengths`; in training, residual dropout and per-layer
                   gradient checkpointing, and the shifted cross-entropy loss;
* ``prefill``      runs the prompt and returns per-layer caches of max_len
                   rows (zero past the prompt);
* ``step``         one token per row at one position `index`: writes its
                   cache row, then attends over rows [0, index];
* ``verify_step``  T tokens per row at per-row positions `index_vec` [B] (a
                   device tensor): writes T cache rows per row, then query t
                   attends over rows [0, index_vec[b] + t]. The serving
                   engine decodes through it with T = 1.

Per layer the two cache lists hold K and V [B, max_len, hidden] in the
model's dtype or, with `kv_quant`, the quantised values and their bf16
scale plane [B, max_len, 128] (ops/kv_quant.py): int8 [B, max_len,
2·hidden] (K ++ V), or with `kv_bits` 4 packed int4 [B, max_len, hidden],
with per-row scales or `kv_group` lanes per scale; with `kv_rotate` the
rows are stored rotated per head, q is rotated before the decode kernel
and its output rotated back after it. All as in the JAX package.

With `mtp_heads` > 0 the decoder carries the multi-token-prediction draft
heads `mtp_{k}` (zero-initialised Linear(hidden, hidden) blocks feeding the
shared `lm_head`; head k predicts the token 2+k positions ahead), trained
with an auxiliary shifted cross-entropy and used by speculative decoding.

Unlike the JAX package, whose arrays are immutable,
``step`` and ``verify_step`` write the caches in place: they are
preallocated once by ``prefill`` and reused by every step, so a step moves
no cache bytes beyond the attention's reads and its own rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edgerunner_tpu_torch.models.layers import LN_EPS, attention_fn, maybe_checkpoint
from edgerunner_tpu_torch.ops import decode_attention as DA
from edgerunner_tpu_torch.ops import kv_quant as KQ
from edgerunner_tpu_torch.parallel.collectives import dp_total
from edgerunner_tpu_torch.parallel.mesh import active_data_parallel, active_sequence_parallel

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
    # quantised KV cache (values + a bf16 scale plane) for decoding: int8,
    # or with kv_bits 4 packed int4 with per-row scales or kv_group lanes
    # per scale; kv_rotate rotates K/V rows per head before quantising
    kv_quant: bool = False
    kv_bits: int = 8
    kv_group: int = 0
    kv_rotate: bool = False
    # multi-token-prediction draft heads for speculative decoding (0 = none)
    mtp_heads: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_attention_heads


def _kv_quantize(c: ShapeOPTConfig, kf, vf):
    """Quantise K and V rows [B, T, hidden] into the cache's layout: (values
    [B, T, 2·hidden] int8 or [B, T, hidden] int4, scale plane [B, T, 128]),
    rotated first under kv_rotate (shape_opt.py:122-151)."""
    if c.kv_rotate:
        kf = KQ.rotate_rows(kf, c.num_attention_heads)
        vf = KQ.rotate_rows(vf, c.num_attention_heads)
    pack = KQ.pack_scales
    if c.kv_bits == 4 and c.kv_group:
        (kq, ks), (vq, vs) = (KQ.quantize_rows_int4_grouped(x, c.kv_group) for x in (kf, vf))
        pack = KQ.pack_scales_grouped
    elif c.kv_bits == 4:
        (kq, ks), (vq, vs) = KQ.quantize_rows_int4(kf), KQ.quantize_rows_int4(vf)
    else:
        (kq, ks), (vq, vs) = KQ.quantize_rows(kf), KQ.quantize_rows(vf)
    return torch.cat([kq, vq], dim=-1), pack(ks, vs)


def _rows_update(cache, rows, index_vec):
    """Write rows [B, T, C] into cache [B, L, C] at per-row offsets index_vec
    [B] in place, on the device (shape_opt.py:172-177). Like JAX's
    dynamic_update_slice, an offset is clamped to [0, L - T]."""
    B, T = rows.shape[:2]
    start = index_vec.long().clamp(0, cache.shape[1] - T)
    cols = start[:, None] + torch.arange(T, device=cache.device)
    cache[torch.arange(B, device=cache.device)[:, None], cols] = rows.to(cache.dtype)


class OPTAttention(nn.Module):
    """Separate q/k/v/out projections with bias (reference: modeling_opt.py:164-167)."""

    def __init__(self, c: ShapeOPTConfig, *, use_kernels: bool = True,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = c
        self.num_heads = c.num_attention_heads
        self.kv_quant = c.kv_quant
        self.attend = attention_fn(use_kernels)
        # one-query and multi-query decode over the cache's kind: the kernels'
        # wrappers, or their plain versions on every device
        kind = ("_q4" if c.kv_bits == 4 else "_q8") if c.kv_quant else ""
        suffix = "" if use_kernels else "_reference"
        self.decode, self.decode_multi = (
            getattr(DA, f"fused_decode_attention{kind}{multi}{suffix}")
            for multi in ("", "_multi"))
        self.decode_kw = {"num_heads": c.num_attention_heads}
        if kind == "_q4":
            self.decode_kw["group"] = c.kv_group
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

    def _write_rows(self, h, k_cache, v_cache, index_vec):
        """Write the K/V rows of h [B, T, C] at per-row offsets, quantised
        under kv_quant (the caches are then the values and the plane)."""
        kf, vf = self.k_proj(h), self.v_proj(h)
        if self.kv_quant:
            kf, vf = _kv_quantize(self.cfg, kf, vf)
        _rows_update(k_cache, kf, index_vec)
        _rows_update(v_cache, vf, index_vec)

    def _attend(self, decode, q, k_cache, v_cache, index):
        """The decode call, with q rotated before it and its output rotated
        back after it under kv_rotate, each cast back to q's dtype
        (shape_opt.py:244-249, :271-273, :306-309, :328-329)."""
        rotate = self.kv_quant and self.cfg.kv_rotate
        if rotate:
            q = KQ.rotate_rows(q, self.num_heads).to(q.dtype)
        o = decode(q, k_cache, v_cache, index, **self.decode_kw)
        if rotate:
            o = KQ.rotate_rows(o, self.num_heads, inverse=True).to(q.dtype)
        return o

    def step(self, h, k_cache, v_cache, index: int, pos):
        """h [B, 1, C] at position `index` (a host int); `pos` is the step's
        int32 [B] position vector on the device, which every decode kernel
        reads. Writes this token's cache row in place (under kv_quant
        quantised, at `pos`), then attends over rows [0, index]."""
        if self.kv_quant:
            self._write_rows(h, k_cache, v_cache, pos)
        else:
            k_cache[:, index] = self.k_proj(h)[:, 0]
            v_cache[:, index] = self.v_proj(h)[:, 0]
        o = self._attend(self.decode, self.q_proj(h)[:, 0], k_cache, v_cache, pos)
        return self.out_proj(o)[:, None]

    def verify_step(self, h, k_cache, v_cache, index_vec):
        """h [B, T, C], the embeds of T tokens per row at positions
        index_vec[b] .. index_vec[b]+T-1 (int32 [B] on the device): writes
        their cache rows in place, then query t attends over rows
        [0, index_vec[b] + t] (shape_opt.py:289-358)."""
        self._write_rows(h, k_cache, v_cache, index_vec)
        o = self._attend(self.decode_multi, self.q_proj(h), k_cache, v_cache, index_vec)
        return self.out_proj(o)


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

    def step(self, h, k_cache, v_cache, index: int, pos):
        a = self.self_attn.step(h, k_cache, v_cache, index, pos)
        return self._mlp(self.self_attn_layer_norm(h + a))

    def verify_step(self, h, k_cache, v_cache, index_vec):
        a = self.self_attn.verify_step(h, k_cache, v_cache, index_vec)
        return self._mlp(self.self_attn_layer_norm(h + a))


class ShapeOPTDecoder(nn.Module):
    """Token + learned-position embedding, stacked OPT layers
    (reference: modeling_opt.py:307-426)."""

    def __init__(self, c: ShapeOPTConfig, *, use_kernels: bool = True,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = c
        self.remat = c.remat
        self.kv_quant = c.kv_quant
        self.embd = nn.Embedding(c.vocab_size, c.hidden_dim, **kw)
        self.embed_positions = nn.Embedding(c.max_position_embeddings, c.hidden_dim, **kw)
        self.layers = nn.ModuleList(
            OPTDecoderLayer(c, use_kernels=use_kernels, **kw)
            for _ in range(c.num_hidden_layers))

    def forward(self, inputs_embeds, lengths=None, train: bool = False):
        """With `cfg.remat`, each layer is checkpointed
        (edgerunner_tpu/models/shape_opt.py:524-538). Under an sp context
        the positions of the full length T are added, then the rank keeps
        its shard [rank * T/R, (rank + 1) * T/R): every layer runs on it
        (LayerNorm and MLP per token, attention as the ring), and the hidden
        states returned are the shard's."""
        if not inputs_embeds.is_floating_point():
            inputs_embeds = self.embd(inputs_embeds)
        T = inputs_embeds.shape[1]
        h = inputs_embeds + self.embed_positions.weight[:T]
        sp = active_sequence_parallel()
        if sp is not None:
            h = sp.shard(h)
        for layer in self.layers:
            h = maybe_checkpoint(self.remat, layer, h, lengths, train)
        return h

    def prefill(self, inputs_embeds, max_len: int):
        """Returns (hidden [B, P, C], caches): per-layer lists of K and V
        [B, max_len, hidden] buffers, or under kv_quant of the quantised
        values and bf16 planes [B, max_len, 128], zero past the prompt."""
        B, P, C = inputs_embeds.shape
        h = inputs_embeds + self.embed_positions.weight[:P]
        ks, vs = [], []
        for layer in self.layers:
            h, k, v = layer.prefill(h)
            if self.kv_quant:
                k, v = _kv_quantize(self.cfg, k, v)
            for cache, rows in ((ks, k), (vs, v)):
                buf = torch.zeros((B, max_len) + rows.shape[2:], dtype=rows.dtype,
                                  device=h.device)
                buf[:, :P] = rows
                cache.append(buf)
        return h, (ks, vs)

    def step(self, token_ids, caches: Caches, index: int):
        """token_ids [B, 1] at position `index`; updates the caches in place.
        Every decode kernel takes the position from the device: the step
        builds that vector once for all layers, whatever the cache's kind."""
        h = self.embd(token_ids) + self.embed_positions.weight[index]
        pos = torch.full((token_ids.shape[0],), index, dtype=torch.int32, device=h.device)
        for layer, k, v in zip(self.layers, *caches):
            h = layer.step(h, k, v, index, pos)
        return h

    def verify_step(self, token_ids, caches: Caches, index_vec):
        """token_ids [B, T] at per-row positions index_vec [B] .. + T-1 (an
        int32 tensor on the device); one pass for all T tokens, causal within
        them (shape_opt.py:627-647). Updates the caches in place; returns
        hidden [B, T, C]."""
        T = token_ids.shape[1]
        pos = index_vec.long()[:, None] + torch.arange(T, device=index_vec.device)
        h = self.embd(token_ids) + self.embed_positions.weight[pos]
        for layer, k, v in zip(self.layers, *caches):
            h = layer.verify_step(h, k, v, index_vec)
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
        # the draft heads mtp_0 .. (shape_opt.py:657-663), zero at first so
        # that each starts as the base head's distribution
        for k in range(c.mtp_heads):
            head = nn.Linear(c.hidden_dim, c.hidden_dim, device=device, dtype=dtype)
            nn.init.zeros_(head.weight)
            nn.init.zeros_(head.bias)
            self.add_module(f"mtp_{k}", head)

    @property
    def mtp_proj(self) -> list:
        return [getattr(self, f"mtp_{k}") for k in range(self.cfg.mtp_heads)]

    def mtp_logits(self, h) -> list:
        """Draft-head logits of hidden states h [..., C]: one [..., V] tensor
        per head; head k predicts the token 2+k positions ahead of h's
        (shape_opt.py:665-671)."""
        return [self.lm_head(h + F.silu(p(h)).to(h.dtype)) for p in self.mtp_proj]

    def forward(self, inputs_embeds, lengths=None, labels=None, train: bool = False):
        """Teacher-forcing logits [B, T, V]; with `labels`, (logits, loss,
        loss_mtp): loss_mtp averages the draft heads' shifted cross-entropies
        (shift 2+k), None without heads (edgerunner_tpu/models/shape_opt.py:673-690)."""
        h = self.model(inputs_embeds, lengths, train)
        logits = self.lm_head(h)
        if labels is None:
            return logits
        # under sp, h and logits hold the rank's positions from `offset`
        sp = active_sequence_parallel()
        offset = 0 if sp is None else sp.rank * h.shape[1]
        loss_mtp = None
        if self.mtp_proj:
            aux = [shifted_cross_entropy(lg, labels, shift=2 + k, offset=offset)
                   for k, lg in enumerate(self.mtp_logits(h))]
            loss_mtp = sum(aux) / len(aux)
        return logits, shifted_cross_entropy(logits, labels, offset=offset), loss_mtp

    def embed_tokens(self, ids):
        return self.model.embd(ids)

    def prefill(self, inputs_embeds, max_len: int, with_hidden: bool = False):
        """Returns (next-token logits [B, 1, V], caches), and with
        `with_hidden` the last position's hidden state [B, 1, C] after them
        (speculative decoding drafts from it)."""
        h, caches = self.model.prefill(inputs_embeds, max_len)
        out = (self.lm_head(h[:, -1:]), caches)
        return out + (h[:, -1:],) if with_hidden else out

    def step(self, token_ids, caches: Caches, index: int):
        return self.lm_head(self.model.step(token_ids, caches, index))

    def verify_step(self, token_ids, caches: Caches, index_vec, with_hidden: bool = False):
        """Logits [B, T, V] of T tokens per row at per-row positions, and with
        `with_hidden` their hidden states [B, T, C] (shape_opt.py:700-705);
        updates the caches in place."""
        h = self.model.verify_step(token_ids, caches, index_vec)
        return (self.lm_head(h), h) if with_hidden else self.lm_head(h)


def shifted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          shift: int = 1, offset: int = 0) -> torch.Tensor:
    """Mean cross-entropy of logits[:, :-shift] against labels[:, shift:] in
    f32 (or wider), ignoring label -100 (edgerunner_tpu/models/shape_opt.py:707-719).

    Sharded (sequence parallelism): `logits` [B, S, V] are those of positions
    [offset, offset + S) of the full labels [B, T], which every rank holds.
    Position p is scored against labels[p + shift] where that lies inside T,
    and the sum is divided by the count of valid labels[:, shift:] over the
    whole sequence, so that the ranks' losses add up to the unsharded loss.
    Under a dp context (parallel/mesh.py) the count is that of every dp
    group's rows (one scalar all-reduce), so that the dp groups' losses add
    up to the loss of their whole batch, as the JAX step takes it; a mean of
    each group's mean would weigh rows by their group's label count.
    """
    T = labels.shape[1]
    shift_labels = labels[:, offset + shift:min(offset + logits.shape[1] + shift, T)].long()
    shift_logits = logits[:, :shift_labels.shape[1]].to(
        torch.promote_types(logits.dtype, torch.float32))
    valid = shift_labels != -100
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, shift_labels, 0)[..., None])[..., 0]
    count = (labels[:, shift:] != -100).sum()
    dp = active_data_parallel()
    if dp is not None:
        count = dp_total(count, dp)
    return torch.where(valid, nll, 0.0).sum() / count.clamp(min=1)

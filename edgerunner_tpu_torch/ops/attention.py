"""Attention of the PyTorch port: plain versions and the dispatch.

The port's counterpart of edgerunner_tpu/ops/attention.py:28-189. Padding is
expressed as prefix lengths (`q_len` / `kv_len`, one int per row), masked
logits are NEG_INF = -1e30, causal masking applies only when N == M, and
rows past `q_len` are zeroed. Shapes follow the JAX package: q [B, N, H, D],
k/v [B, M, H, D].

`attention` is differentiable: it sends a CUDA tensor to the hand-written
flash-attention kernels, the forward and, for its gradient, the backward
(ops/flash_attention.py `FlashAttention`), and a CPU tensor to their plain
versions. While the trainer has installed a sequence-parallel context
(parallel/mesh.py `sequence_parallel`), causal self-attention runs as a ring
over the sp ranks instead (ops/ring_attention.py `ring_attention`), as the
JAX dispatch's sp branch does (attention.py:151-177).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _length_mask(lengths: torch.Tensor, size: int) -> torch.Tensor:
    """lengths [B] -> bool [B, size], True inside the prefix."""
    return torch.arange(size, device=lengths.device)[None] < lengths[:, None]


def attention_reference_lse(q, k, v, *, causal: bool = False,
                            q_len: Optional[torch.Tensor] = None,
                            kv_len: Optional[torch.Tensor] = None):
    """Masked softmax attention in f32 (or wider), and its row log-sum-exp.

    Returns (out [B, N, H, D] in q's dtype with rows past q_len zeroed,
    lse [B, N, H] in the compute dtype). The plain version of the
    flash-attention kernel.
    """
    B, N, H, D = q.shape
    M = k.shape[1]
    if causal and N != M:
        raise ValueError(f"causal attention needs N == M, got {N} and {M}")
    ct = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.to(ct), k.to(ct)) / math.sqrt(D)
    if causal:
        cols = torch.arange(M, device=q.device)
        keep = cols[None, :] <= torch.arange(N, device=q.device)[:, None]
        logits = logits.masked_fill(~keep[None, None], NEG_INF)
    if kv_len is not None:
        keep = _length_mask(kv_len, M)[:, None, None, :]
        logits = logits.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)                      # [B, H, N]
    out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1), v.to(ct))
    if q_len is not None:
        out = torch.where(_length_mask(q_len, N)[:, :, None, None], out, 0.0)
    return out.to(q.dtype), lse.permute(0, 2, 1)


def attention_reference(q, k, v, *, causal: bool = False,
                        q_len: Optional[torch.Tensor] = None,
                        kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked softmax attention; the ground truth for the kernels
    (edgerunner_tpu/ops/attention.py:33-67)."""
    return attention_reference_lse(q, k, v, causal=causal, q_len=q_len,
                                   kv_len=kv_len)[0]


def decode_attention(q, k_cache, v_cache, cur_index) -> torch.Tensor:
    """One-token attention against a static KV cache
    (edgerunner_tpu/ops/attention.py:70-93).

    q [B, 1, H, D]; caches [B, L, H, D]; cur_index: int or [B], the number
    of valid cache rows. Returns [B, 1, H, D].
    """
    B, L, H, D = k_cache.shape
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k_cache.float()) / math.sqrt(D)
    idx = torch.as_tensor(cur_index, device=q.device).expand(B)
    logits = logits.masked_fill(~_length_mask(idx, L)[:, None, None, :], NEG_INF)
    out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1),
                       v_cache.float())
    return out.to(q.dtype)


def decode_attention_multi(q, k_cache, v_cache, base_index) -> torch.Tensor:
    """T-token attention against a static KV cache at per-row positions
    (edgerunner_tpu/ops/attention.py:95-121): the T new rows are already
    written at base_index .. base_index+T-1.

    q [B, T, H, D]; caches [B, L, H, D]; base_index: int or [B]. Query t of
    row b attends cache columns <= base_index[b] + t. Returns [B, T, H, D].
    """
    B, L, H, D = k_cache.shape
    T = q.shape[1]
    logits = torch.einsum("bthd,bmhd->bhtm", q.float(), k_cache.float()) / math.sqrt(D)
    idx = torch.as_tensor(base_index, device=q.device).expand(B)
    cols = torch.arange(L, device=q.device)
    last = idx[:, None] + torch.arange(T, device=q.device)[None]     # [B, T]
    keep = cols[None, None, :] <= last[:, :, None]                     # [B, T, L]
    logits = logits.masked_fill(~keep[:, None], NEG_INF)
    out = torch.einsum("bhtm,bmhd->bthd", torch.softmax(logits, dim=-1),
                       v_cache.float())
    return out.to(q.dtype)


def attention(q, k, v, *, causal: bool = False,
              q_len: Optional[torch.Tensor] = None,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatching, differentiable attention entry point: the flash-attention
    kernels for a CUDA tensor, their plain versions for a CPU tensor; under
    an sp context, causal self-attention of local shards runs as a ring."""
    from edgerunner_tpu_torch.ops.flash_attention import FlashAttention
    from edgerunner_tpu_torch.parallel.mesh import active_sequence_parallel

    sp = active_sequence_parallel()
    if sp is not None and causal and q.shape[1] == k.shape[1]:
        from edgerunner_tpu_torch.ops.ring_attention import ring_attention

        # the length masks are dropped, as the JAX branch drops them: padding
        # is a suffix and attention is causal, so every query that a loss
        # reads attends valid positions only; rows past q_len hold values
        # that the cross-entropy's -100 labels ignore
        return ring_attention(q, k, v, sp, causal=True)
    return FlashAttention.apply(q, k, v, causal, q_len, kv_len)

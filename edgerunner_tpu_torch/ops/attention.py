"""Attention of the PyTorch port: plain versions and the dispatch.

The port's counterpart of edgerunner_tpu/ops/attention.py:28-189. Padding is
expressed as prefix lengths (`q_len` / `kv_len`, one int per row), masked
logits are NEG_INF = -1e30, causal masking applies only when N == M, and
rows past `q_len` are zeroed. Shapes follow the JAX package: q [B, N, H, D],
k/v [B, M, H, D].

`attention` sends a CUDA tensor to the hand-written flash-attention kernel
(ops/flash_attention.py) and a CPU tensor to `attention_reference`. The
sequence-parallel ring branch of the JAX dispatch is not ported yet.
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
    """Masked softmax attention in f32, and its row log-sum-exp.

    Returns (out [B, N, H, D] in q's dtype with rows past q_len zeroed,
    lse [B, N, H] f32). The plain version of the flash-attention kernel.
    """
    B, N, H, D = q.shape
    M = k.shape[1]
    if causal and N != M:
        raise ValueError(f"causal attention needs N == M, got {N} and {M}")
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / math.sqrt(D)
    if causal:
        cols = torch.arange(M, device=q.device)
        keep = cols[None, :] <= torch.arange(N, device=q.device)[:, None]
        logits = logits.masked_fill(~keep[None, None], NEG_INF)
    if kv_len is not None:
        keep = _length_mask(kv_len, M)[:, None, None, :]
        logits = logits.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)                      # [B, H, N]
    out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1), v.float())
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


def attention(q, k, v, *, causal: bool = False,
              q_len: Optional[torch.Tensor] = None,
              kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatching attention entry point: the flash-attention kernel for a
    CUDA tensor, `attention_reference` for a CPU tensor."""
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, causal=causal, q_len=q_len, kv_len=kv_len)[0]

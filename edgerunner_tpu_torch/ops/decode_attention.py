"""Decode attention over the packed KV cache: the wrapper of the
hand-written CUDA kernel (csrc/decode_attention.cu) and its plain version.

Replaces the TPU kernel `fused_decode_attention`
(edgerunner_tpu/ops/decode_attention_pallas.py:139). On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it runs the plain
version. The kernel is bound by bytes (see the source's note).
"""

from __future__ import annotations

import torch

from edgerunner_tpu_torch.ops import _build
from edgerunner_tpu_torch.ops.attention import decode_attention
from edgerunner_tpu_torch.ops.flash_attention import DTYPE_CODES, HEAD_DIMS

__all__ = ["fused_decode_attention", "fused_decode_attention_reference"]

# cache positions per block of the split-KV pass
CHUNK = 256


def fused_decode_attention_reference(q, k_cache, v_cache, index: int, *,
                                     num_heads: int) -> torch.Tensor:
    """The plain version: q [B, hidden] attends over cache rows [0, index]
    of k/v [B, L, hidden] per head, in f32. Returns [B, hidden] in q's dtype."""
    B, L, hd = k_cache.shape
    H, D = num_heads, hd // num_heads
    n = index + 1
    out = decode_attention(q.reshape(B, 1, H, D),
                           k_cache[:, :n].reshape(B, n, H, D),
                           v_cache[:, :n].reshape(B, n, H, D), n)
    return out.reshape(B, hd)


def fused_decode_attention(q, k_cache, v_cache, index: int, *,
                           num_heads: int) -> torch.Tensor:
    """q [B, hidden]; caches [B, L, hidden] already holding the new token's
    k/v at row `index` (a host int). Returns out [B, hidden], attending over
    cache rows [0, index] only."""
    B, L, hd = k_cache.shape
    H = num_heads
    D = hd // H
    index = int(index)
    if q.shape != (B, hd) or v_cache.shape != k_cache.shape or hd != H * D:
        raise ValueError(f"shapes q {tuple(q.shape)}, caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} with {H} heads do not fit")
    if not 0 <= index < L:
        raise ValueError(f"index {index} outside the cache length {L}")
    if q.device.type == "cpu":
        return fused_decode_attention_reference(q, k_cache, v_cache, index,
                                                num_heads=num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"fused_decode_attention takes f32 or bf16, got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"fused_decode_attention has kernels for head dims "
                         f"{HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")
    splits = -(-(index + 1) // CHUNK)
    part_o = torch.empty((splits, B, H, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((2, splits, B, H), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        part_o.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
        B, L, H, D, index, CHUNK, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_fwd")
    fused_decode_attention.launches += 1
    return out


fused_decode_attention.launches = 0

"""Flash-attention forward: the wrapper of the hand-written CUDA kernel
(csrc/flash_fwd.cu) and its plain version.

Replaces the TPU kernels `_fwd` / `_fwd_t` reached from
edgerunner_tpu/ops/flash_attention.py:1336 (`flash_attention`). On a CUDA
tensor the wrapper launches the kernel or raises; on a CPU tensor it runs
the plain version, `attention_reference_lse`. The kernel is bound by
operations at the main path's shapes (see the source's note).
"""

from __future__ import annotations

from typing import Optional

import torch

from edgerunner_tpu_torch.ops import _build
from edgerunner_tpu_torch.ops.attention import attention_reference_lse

__all__ = ["flash_attention", "flash_attention_reference"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 96)

# the plain version: same function, f32 math, no kernel
flash_attention_reference = attention_reference_lse


def _lengths(x: Optional[torch.Tensor], B: int, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    x = torch.as_tensor(x, device=device).to(torch.int32).contiguous()
    if x.shape != (B,):
        raise ValueError(f"length vector must have shape ({B},), got {tuple(x.shape)}")
    return x


def flash_attention(q, k, v, *, causal: bool = False,
                    q_len: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None):
    """q [B,N,H,D], k/v [B,M,H,D] -> (out [B,N,H,D], lse [B,N,H] f32).

    Keys past `kv_len` are masked, causal masking needs N == M, and output
    rows past `q_len` are zeroed.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, q_len=q_len,
                                         kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, N, H, D = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if causal and N != M:
        raise ValueError(f"causal attention needs N == M, got {N} and {M}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes f32 or bf16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention has kernels for head dims {HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")
    q_len = _lengths(q_len, B, q.device)
    kv_len = _lengths(kv_len, B, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, N, H), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        0 if q_len is None else q_len.data_ptr(),
        0 if kv_len is None else kv_len.data_ptr(),
        B, N, M, H, D, DTYPE_CODES[q.dtype], int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0

"""Per-row int8 KV-cache quantisation of the port (edgerunner_tpu/ops/kv_quant.py:28-50).

Each cache row is stored as int8 values with one absmax/127 scale. The K
and V rows of a position are packed side by side, int8 [B, T, 2·hidden]
(K in [0, hidden), V in [hidden, 2·hidden)), and their two scales share one
bf16 plane [B, T, SCALE_LANES]: lane 0 holds the K scale, lane 1 the V
scale, and lanes 2-127 repeat the K scale as filler. The layouts are the
JAX package's exactly, so that caches compare bit for bit. The scale
rounds to bf16 in the plane: dequantisation multiplies by the bf16 scale,
while quantisation divided by the f32 one, as in the JAX package.
"""

from __future__ import annotations

import torch

SCALE_LANES = 128


def quantize_rows(x: torch.Tensor):
    """x [..., hidden] float -> (int8 values [..., hidden], f32 scales
    [..., 1]): scale = max(absmax, 1e-6) / 127 and the values round half to
    even, in f32."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6) / 127.0
    vals = torch.clamp(torch.round(xf / scale), -127, 127)
    return vals.to(torch.int8), scale


def pack_scales(k_scale: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """[..., 1] K and V scales -> one bf16 [..., 128] plane (lane 0 = K,
    lane 1 = V, the K scale elsewhere)."""
    lanes = torch.arange(SCALE_LANES, device=k_scale.device)
    return torch.where(lanes == 1, v_scale, k_scale).to(torch.bfloat16)


def dequantize_rows(vals: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.bfloat16, lane: int = 0) -> torch.Tensor:
    """The inverse of `quantize_rows` with the packed [..., 128] plane:
    `lane` 0 for K, 1 for V."""
    return (vals.float() * scales[..., lane:lane + 1].float()).to(dtype)


def dequantize_cache(kv_vals: torch.Tensor, scales: torch.Tensor, dtype=torch.float32):
    """(K, V) [..., hidden] in `dtype` of the int8 cache's values [...,
    2·hidden] and plane (edgerunner_tpu/models/shape_opt.py:154-169
    `_kv_dequantize`, int8)."""
    hd = kv_vals.shape[-1] // 2
    return (dequantize_rows(kv_vals[..., :hd], scales, dtype, 0),
            dequantize_rows(kv_vals[..., hd:], scales, dtype, 1))

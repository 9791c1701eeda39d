"""KV-cache quantisation of the port (edgerunner_tpu/ops/kv_quant.py:28-185).

Three cache kinds, each the JAX package's layout exactly, so that caches
compare bit for bit:

* int8 (`kv_bits` 8): each row is int8 values with one absmax/127 scale. The
  K and V rows of a position are packed side by side, int8 [B, T, 2·hidden]
  (K in [0, hidden), V in [hidden, 2·hidden)), and their two scales share
  one bf16 plane [B, T, SCALE_LANES]: lane 0 holds the K scale, lane 1 the V
  scale, and lanes 2-127 repeat the K scale as filler.
* int4 (`kv_bits` 4): values in [-7, 7] with one absmax/7 scale per row,
  two to a byte. Byte j of a packed row holds lanes j (low nibble) and
  j + hidden/2 (high nibble) of the whole row, so a packed row is hidden/2
  bytes; K's packed row fills bytes [0, hidden/2) of the cache row and V's
  the bytes after it, int8 [B, T, hidden]. The plane is the int8 kind's.
* grouped int4 (`kv_group` > 0): one absmax/7 scale per `group` contiguous
  lanes, G = hidden / group <= 64 of them per row; the plane holds K's G
  scales at lanes [0, G) and V's at [V_GROUP_BASE, V_GROUP_BASE + G), zeros
  elsewhere.

Scales round to bf16 in the plane: dequantisation multiplies by the bf16
scale, while quantisation divided by the f32 one, as in the JAX package.

With `kv_rotate`, K and V rows are rotated per head by fixed orthogonal
matrices before they are quantised (`rotate_rows`): the logits are exactly
invariant when q is rotated too, and the attention output is rotated back.
The matrices come from numpy alone (`_rotations_np`, seeded with
ROTATION_SEED), so they are the JAX package's bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SCALE_LANES = 128
V_GROUP_BASE = 64
ROTATION_SEED = 0xE5C0


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


# ----------------------------------------------------------------- rotation --

@functools.lru_cache(maxsize=8)
def _rotations_np(num_heads: int, head_dim: int) -> np.ndarray:
    """Per-head orthogonal matrices [H, D, D] in f32: the QR of a standard
    normal draw from default_rng(ROTATION_SEED), its columns' signs fixed by
    R's diagonal (edgerunner_tpu/ops/kv_quant.py:66-80)."""
    rng = np.random.default_rng(ROTATION_SEED)
    mats = np.empty((num_heads, head_dim, head_dim), np.float32)
    for h in range(num_heads):
        a = rng.standard_normal((head_dim, head_dim))
        q, r = np.linalg.qr(a)
        mats[h] = (q * np.sign(np.diag(r))[None, :]).astype(np.float32)
    return mats


def rotate_rows(x: torch.Tensor, num_heads: int, inverse: bool = False) -> torch.Tensor:
    """Per-head rotation of packed rows x [..., H·D], in f32: y_h = x_h R_h,
    or x_h R_h^T with `inverse`."""
    hd = x.shape[-1]
    d = hd // num_heads
    if d * num_heads != hd:
        raise ValueError(f"hidden {hd} does not split into {num_heads} heads")
    R = torch.from_numpy(_rotations_np(num_heads, d)).to(x.device)
    xh = x.float().reshape(*x.shape[:-1], num_heads, d)
    eq = "...hd,hed->...he" if inverse else "...hd,hde->...he"
    return torch.einsum(eq, xh, R).reshape(x.shape)


# --------------------------------------------------------------------- int4 --

def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Integers [..., hidden] in [-7, 7] -> int8 [..., hidden/2]: byte j holds
    lane j in its low nibble and lane j + hidden/2 in its high one. The int32
    byte (0-255) is cast to int8 by wrapping, as JAX casts it."""
    q = q.to(torch.int32)
    half = q.shape[-1] // 2
    packed = (q[..., :half] & 0xF) | ((q[..., half:] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8)


def quantize_rows_int4(x: torch.Tensor):
    """x [..., hidden] float (hidden even) -> (packed int8 [..., hidden/2],
    f32 scales [..., 1]): scale = max(absmax, 1e-6) / 7, values rounded half
    to even and clipped to [-7, 7], in f32."""
    if x.shape[-1] % 2:
        raise ValueError(f"int4 rows need an even width, got {x.shape[-1]}")
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6) / 7.0
    return _pack_int4(torch.clamp(torch.round(xf / scale), -7, 7)), scale


def unpack_int4(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """int8 [..., hidden/2] packed nibbles -> [..., hidden] values in lane
    order, sign-extended and unscaled."""
    w = packed.to(torch.int32)
    lo = ((w & 0xF) ^ 8) - 8
    hi = (((w >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(dtype)


def dequantize_rows_int4(packed: torch.Tensor, scales: torch.Tensor,
                         dtype=torch.bfloat16, lane: int = 0) -> torch.Tensor:
    """The inverse of `quantize_rows_int4` with the packed plane (`lane` 0
    for K, 1 for V) or a raw [..., 1] scale."""
    s = scales[..., lane:lane + 1] if scales.shape[-1] > 1 else scales
    return (unpack_int4(packed) * s.float()).to(dtype)


def check_group(hd: int, group: int):
    """Raise unless `group` lanes per scale fit a row of width hd in the
    plane (edgerunner_tpu/ops/kv_quant.py:145-148)."""
    if group <= 0 or hd % group or hd % 2:
        raise ValueError(f"kv_group {group} must divide the even width {hd}")
    if hd // group > V_GROUP_BASE:
        raise ValueError(f"{hd // group} group scales of {group} lanes exceed the "
                         f"{V_GROUP_BASE} lanes of the plane")


def quantize_rows_int4_grouped(x: torch.Tensor, group: int):
    """x [..., hidden] -> (packed int8 [..., hidden/2], f32 scales [..., G]),
    one absmax/7 scale per `group` contiguous lanes."""
    hd = x.shape[-1]
    check_group(hd, group)
    xg = x.float().reshape(*x.shape[:-1], hd // group, group)
    scale = torch.clamp(xg.abs().amax(dim=-1), min=1e-6) / 7.0
    q = torch.clamp(torch.round(xg / scale[..., None]), -7, 7)
    return _pack_int4(q.reshape(x.shape)), scale


def pack_scales_grouped(k_scale: torch.Tensor, v_scale: torch.Tensor) -> torch.Tensor:
    """[..., G] K and V group scales -> one bf16 [..., 128] plane (K at lanes
    [0, G), V at [64, 64 + G), zeros elsewhere)."""
    G = k_scale.shape[-1]
    plane = torch.zeros((*k_scale.shape[:-1], SCALE_LANES), dtype=torch.float32,
                        device=k_scale.device)
    plane[..., :G] = k_scale.float()
    plane[..., V_GROUP_BASE:V_GROUP_BASE + G] = v_scale.float()
    return plane.to(torch.bfloat16)


def dequantize_rows_int4_grouped(packed: torch.Tensor, plane: torch.Tensor, group: int,
                                 dtype=torch.bfloat16, lane: int = 0) -> torch.Tensor:
    """The inverse of `quantize_rows_int4_grouped` with the grouped plane:
    `lane` 0 for K (base lane 0), 1 for V (base lane 64)."""
    vals = unpack_int4(packed)
    G = vals.shape[-1] // group
    base = V_GROUP_BASE if lane == 1 else 0
    s = plane[..., base:base + G].float().repeat_interleave(group, dim=-1)
    return (vals * s).to(dtype)


def dequantize_cache(kv_vals: torch.Tensor, scales: torch.Tensor, dtype=torch.float32,
                     bits: int = 8, group: int = 0):
    """(K, V) [..., hidden] in `dtype` of a quantised cache's values and
    plane: int8 [..., 2·hidden], or with `bits` 4 packed int4 [..., hidden]
    with per-row scales or `group` lanes per scale
    (edgerunner_tpu/models/shape_opt.py:154-169 `_kv_dequantize`)."""
    half = kv_vals.shape[-1] // 2
    k, v = kv_vals[..., :half], kv_vals[..., half:]
    if bits == 8:
        return dequantize_rows(k, scales, dtype, 0), dequantize_rows(v, scales, dtype, 1)
    if group:
        return (dequantize_rows_int4_grouped(k, scales, group, dtype, 0),
                dequantize_rows_int4_grouped(v, scales, group, dtype, 1))
    return dequantize_rows_int4(k, scales, dtype, 0), dequantize_rows_int4(v, scales, dtype, 1)

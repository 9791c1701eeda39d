"""Decode attention over the packed KV cache: the wrappers of the
hand-written CUDA kernels and their plain versions.

* `fused_decode_attention` (csrc/decode_attention.cu, kernel B) replaces the
  TPU kernel `fused_decode_attention`
  (edgerunner_tpu/ops/decode_attention_pallas.py:139): one query per row.
* `fused_decode_attention_multi` (csrc/decode_attention_multi.cu, kernel D)
  replaces `fused_decode_attention_multi` (:585): T queries per row over a
  bf16/f32 cache.
* `fused_decode_attention_q8_multi`, `fused_decode_attention_q8`,
  `fused_decode_attention_q4_multi` and `fused_decode_attention_q4`
  (csrc/decode_attention_quant.cu, kernel D's quantised kinds) replace
  `fused_decode_attention_q8_multi` (:866), `fused_decode_attention_q8`
  (:445), `fused_decode_attention_q4_multi` (:824) and
  `fused_decode_attention_q4` (:401): T queries per row over the int8 cache
  or the int4 cache (per-row or grouped scales) with its scale plane
  (ops/kv_quant.py).

Every kernel takes its positions from an int32 [B] tensor on the device (a
host int is filled into one on the device); the wrappers never read a
position on the host. Kernel B and every kind of kernel D run on a
persistent grid that splits the live work evenly and merge their partial
sums inside the same launch, through a scratch and a ticket buffer that the
wrapper allocates once per configuration and stream and keeps (`_scratch`).
Kernel D takes its queries in passes of up to three (`query_passes`), each
pass reading the cache once.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version. The kernels are bound by bytes (see the sources'
notes): the int4 kind reads `hidden` bytes of nibbles per cached position
plus 4 bytes of the plane with per-row scales, or 4·G with G group scales.
"""

from __future__ import annotations

import math
import threading

import torch

from edgerunner_tpu_torch.ops import _build
from edgerunner_tpu_torch.ops.attention import decode_attention, decode_attention_multi
from edgerunner_tpu_torch.ops.flash_attention import DTYPE_CODES, HEAD_DIMS
from edgerunner_tpu_torch.ops.kv_quant import (
    SCALE_LANES,
    V_GROUP_BASE,
    check_group,
    dequantize_cache,
)

__all__ = ["fused_decode_attention", "fused_decode_attention_multi",
           "fused_decode_attention_multi_reference", "fused_decode_attention_q4",
           "fused_decode_attention_q4_multi", "fused_decode_attention_q4_multi_reference",
           "fused_decode_attention_q4_reference", "fused_decode_attention_q8",
           "fused_decode_attention_q8_multi", "fused_decode_attention_q8_multi_reference",
           "fused_decode_attention_q8_reference", "fused_decode_attention_reference",
           "int4_pairs", "multi_slot_floats", "multi_tickets", "query_passes",
           "quant_slot_floats"]

# queries per row that the multi-query kernels take
MAX_T = 8
# queries kernel D takes per pass over the cache (its registers)
QUERIES_PER_PASS = 3
# the int4 kind also takes head dim 32 (a head straddling the nibble halves)
INT4_HEAD_DIMS = (32,) + HEAD_DIMS


def query_passes(T: int) -> tuple:
    """(passes, queries per pass) of kernel D (every kind) for T queries:
    one pass up to QUERIES_PER_PASS, else ceil(T / 3) passes of equal size
    (the last may carry queries past T, which are computed and not written).
    Each pass reads the cache once."""
    passes = -(-T // QUERIES_PER_PASS)
    return passes, -(-T // passes)


def int4_pairs(num_heads: int, head_dim: int) -> bool:
    """Whether the int4 kernel takes heads h and h + H/2 as one item: they
    share their bytes (low and high nibbles) when H is even. Head dim 32
    runs one head per item."""
    return num_heads % 2 == 0 and head_dim != 32


def _slot_floats(streams: int, head_dim: int) -> int:
    """Floats of one partial in a persistent kernel's scratch: per softmax
    stream (head of an item, query of a pass) the f32 sums of p*v
    (head_dim), the max and the sum of p; padded to 16 bytes."""
    return -(-streams * (head_dim + 2) // 4) * 4


def multi_slot_floats(head_dim: int, T: int) -> int:
    """Floats of one partial in kernel D's bf16/f32 scratch: its streams
    are the queries of a pass."""
    return _slot_floats(query_passes(T)[1], head_dim)


def multi_tickets(B: int, num_heads: int, T: int) -> int:
    """Tickets of kernel D's bf16/f32 launch: one per (row, pass, head)."""
    return B * query_passes(T)[0] * num_heads


def quant_slot_floats(bits: int, num_heads: int, head_dim: int, T: int) -> int:
    """Floats of one partial in the quantised kernel's scratch: its streams
    are the heads of an item times the queries of a pass."""
    heads = 2 if bits == 4 and int4_pairs(num_heads, head_dim) else 1
    return _slot_floats(heads * query_passes(T)[1], head_dim)


# (kernel, configuration, device, stream) -> [scratch, ticket, warps]; the
# worker threads of a decode fleet fill it together, under the lock
_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.Lock()


def _scratch(key, device, stream: int, slot_floats: int, tickets: int, warps_of):
    """The scratch of a persistent-grid kernel: two partial slots of
    `slot_floats` floats per warp of its grid (`warps_of()` asks the
    library) and `tickets` int32 counters that start at 0 and that every
    launch leaves at 0. Allocated once per configuration, device and stream
    and kept; the tickets grow with the batch."""
    k = (key, slot_floats, device, stream)
    with _SCRATCH_LOCK:
        entry = _SCRATCH.get(k)
        if entry is None:
            warps = warps_of()
            if warps <= 0:
                raise RuntimeError(f"{key}: no kernel instance ({warps})")
            entry = [torch.empty(warps * 2 * slot_floats, dtype=torch.float32, device=device),
                     torch.zeros(0, dtype=torch.int32, device=device), warps]
            _SCRATCH[k] = entry
        if entry[1].numel() < tickets:
            entry[1] = torch.zeros(tickets, dtype=torch.int32, device=device)
        return list(entry)


def fused_decode_attention_reference(q, k_cache, v_cache, index, *,
                                     num_heads: int) -> torch.Tensor:
    """The plain version: q [B, hidden] attends over cache rows [0, index]
    of k/v [B, L, hidden] per head, in f32; `index` a host int for every
    row, or a [B] (or scalar) tensor of per-row positions, clamped into
    [0, L) as the kernel clamps them. Returns [B, hidden] in q's dtype."""
    B, L, hd = k_cache.shape
    H, D = num_heads, hd // num_heads
    if isinstance(index, torch.Tensor):
        lengths = index.to(device=q.device, dtype=torch.long).expand(B).clamp(0, L - 1) + 1
        n = int(lengths.max())
    else:
        lengths = n = int(index) + 1
    out = decode_attention(q.reshape(B, 1, H, D),
                           k_cache[:, :n].reshape(B, n, H, D),
                           v_cache[:, :n].reshape(B, n, H, D), lengths)
    return out.reshape(B, hd)


def _check_aligned(name, device, **tensors):
    for label, t in tensors.items():
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be a contiguous, 16-byte aligned "
                             f"tensor on {device}")


def fused_decode_attention(q, k_cache, v_cache, index, *,
                           num_heads: int) -> torch.Tensor:
    """q [B, hidden]; caches [B, L, hidden] already holding the new token's
    k/v at row index[b]; index an int32 [B] tensor on q's device (the decode
    step's position vector), a scalar tensor, or a host int for every row.
    Returns out [B, hidden], attending over cache rows [0, index[b]] only.
    One launch: the kernel merges its split sums itself."""
    B, L, hd = k_cache.shape
    H = num_heads
    D = hd // H
    if q.shape != (B, hd) or v_cache.shape != k_cache.shape or hd != H * D:
        raise ValueError(f"shapes q {tuple(q.shape)}, caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} with {H} heads do not fit")
    if not isinstance(index, torch.Tensor) and not 0 <= int(index) < L:
        raise ValueError(f"index {index} outside the cache length {L}")
    if not _on_cuda("fused_decode_attention", q):
        return fused_decode_attention_reference(q, k_cache, v_cache, index,
                                                num_heads=num_heads)
    if q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"fused_decode_attention takes f32 or bf16, got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"fused_decode_attention has kernels for head dims "
                         f"{HEAD_DIMS}, got {D}")
    _check_aligned("fused_decode_attention", q.device, q=q, k_cache=k_cache, v_cache=v_cache)
    pos = _positions(index, B, L, 1, q.device)
    lib = _build.load_library()
    code = DTYPE_CODES[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch, ticket, warps = _scratch(("decode_attention_fwd", D, code), q.device, stream,
                                      _slot_floats(1, D), B * H,
                                      lambda: lib.decode_attention_warps(D, code))
    out = torch.empty_like(q)
    err = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), ticket.data_ptr(), warps, B, L, H, D, code, stream)
    _build.check(err, "decode_attention_fwd")
    _build.count_launch(fused_decode_attention)
    return out


fused_decode_attention.launches = 0


# ------------------------------------------------- per-row positions, T queries --

def fused_decode_attention_multi_reference(q, k_cache, v_cache, index, *,
                                           num_heads: int) -> torch.Tensor:
    """The plain version: q [B, T, hidden]; query t of row b attends over
    cache rows [0, index[b] + t] of k/v [B, L, hidden], in f32. Returns
    [B, T, hidden] in q's dtype."""
    B, T, hd = q.shape
    L = k_cache.shape[1]
    H, D = num_heads, hd // num_heads
    out = decode_attention_multi(q.reshape(B, T, H, D), k_cache.reshape(B, L, H, D),
                                 v_cache.reshape(B, L, H, D), index)
    return out.reshape(B, T, hd)


def fused_decode_attention_q8_multi_reference(q, kv_vals, scales, index, *,
                                              num_heads: int) -> torch.Tensor:
    """The plain version over the int8 cache: dequantise in f32, then attend."""
    k, v = dequantize_cache(kv_vals, scales, torch.float32)
    return fused_decode_attention_multi_reference(q, k, v, index, num_heads=num_heads)


def fused_decode_attention_q8_reference(q, kv_vals, scales, index, *,
                                        num_heads: int) -> torch.Tensor:
    """Row 8's plain version: q [B, hidden], one query per row."""
    return fused_decode_attention_q8_multi_reference(q[:, None], kv_vals, scales, index,
                                                     num_heads=num_heads)[:, 0]


def _positions(index, B: int, L: int, T: int, device) -> torch.Tensor:
    """The int32 [B] position vector for the kernel, without a host read of
    a device tensor: a host int is range-checked and filled on the device; a
    tensor (scalar or [B]) is taken as it is, and the kernel reads no cache
    row at or past L whatever it holds."""
    if isinstance(index, torch.Tensor):
        if index.device != device or index.numel() not in (1, B) or index.dim() > 1:
            raise ValueError(f"index must be a scalar or a [{B}] tensor on {device}, got "
                             f"{tuple(index.shape)} on {index.device}")
        if index.dtype == torch.int32 and index.dim() == 1 and index.is_contiguous():
            return index  # the decode step's vector, as the kernels read it
        return index.to(torch.int32).expand(B).contiguous()
    index = int(index)
    if not 0 <= index <= L - T:
        raise ValueError(f"index {index} with {T} queries outside the cache length {L}")
    return torch.full((B,), index, dtype=torch.int32, device=device)


def _check_multi(name, q, caches: dict, num_heads: int, head_dims) -> tuple:
    """Raise on what a multi-query kernel does not take; (B, T, L, H, D).
    `caches` names the cache tensors (the first gives L)."""
    B, T, hd = q.shape
    L = next(iter(caches.values())).shape[1]
    H = num_heads
    D = hd // H
    if hd != H * D or D not in head_dims:
        raise ValueError(f"{name} has kernels for head dims {head_dims}, got hidden "
                         f"{hd} over {H} heads")
    if not 1 <= T <= MAX_T:
        raise ValueError(f"{name} takes 1 to {MAX_T} queries per row, got {T}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} takes f32 or bf16 queries, got {q.dtype}")
    _check_aligned(name, q.device, q=q, **caches)
    return B, T, L, H, D


def _launch_multi(q, k_cache, v_cache, index, num_heads: int) -> torch.Tensor:
    """Kernel D over a bf16/f32 cache, one launch on its persistent grid,
    with the scratch and tickets kept for its configuration."""
    name = "fused_decode_attention_multi"
    B, T, L, H, D = _check_multi(name, q, {"k_cache": k_cache, "v_cache": v_cache},
                                 num_heads, HEAD_DIMS)
    pos = _positions(index, B, L, T, q.device)
    code = DTYPE_CODES[q.dtype]
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch, ticket, warps = _scratch(
        ("decode_attention_multi_fwd", D, code, query_passes(T)[1]), q.device, stream,
        multi_slot_floats(D, T), multi_tickets(B, H, T),
        lambda: lib.decode_attention_multi_warps(D, T, code))
    out = torch.empty_like(q)
    err = lib.decode_attention_multi_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), ticket.data_ptr(), warps, B, L, H, D, T, code,
        1.0 / math.sqrt(D), stream)
    _build.check(err, name)
    return out


def _launch_quant(name, q, kv_vals, scales, index, num_heads: int, bits: int,
                  group: int = 0) -> torch.Tensor:
    """The quantised kernel over the int8 (bits 8) or int4 (bits 4) cache,
    one launch; `group` 0 for per-row scales (plane lanes 0 and 1), else
    the int4 group size (K's scales from lane 0, V's from V_GROUP_BASE)."""
    B, T, L, H, D = _check_multi(name, q, {"kv_vals": kv_vals, "scales": scales}, num_heads,
                                 INT4_HEAD_DIMS if bits == 4 else HEAD_DIMS)
    pos = _positions(index, B, L, T, q.device)
    passes, per_pass = query_passes(T)
    pairs = bits == 4 and int4_pairs(H, D)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch, ticket, warps = _scratch(
        ("decode_attention_quant_fwd", bits, pairs, D, per_pass), q.device, stream,
        quant_slot_floats(bits, H, D, T), B * passes * (H // 2 if pairs else H),
        lambda: lib.decode_attention_quant_warps(bits, H, D, T))
    out = torch.empty_like(q)
    err = lib.decode_attention_quant_fwd(
        q.data_ptr(), kv_vals.data_ptr(), scales.data_ptr(), pos.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), ticket.data_ptr(), warps, B, L, H, D, T, bits, group,
        V_GROUP_BASE if group else 1, DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D), stream)
    _build.check(err, name)
    return out


def _on_cuda(name: str, q) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    return True


def fused_decode_attention_multi(q, k_cache, v_cache, index, *,
                                 num_heads: int) -> torch.Tensor:
    """q [B, T, hidden] (T <= 8); caches [B, L, hidden] of q's dtype already
    holding the T new rows at index[b] .. index[b]+T-1; index an int32 [B]
    tensor on q's device (or a host int for every row). Returns [B, T,
    hidden]; query t of row b attends over cache rows [0, index[b] + t]."""
    B, T, hd = q.shape
    if k_cache.dim() != 3 or k_cache.shape[0] != B or k_cache.shape[2] != hd \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit")
    if not _on_cuda("fused_decode_attention_multi", q):
        return fused_decode_attention_multi_reference(q, k_cache, v_cache, index,
                                                      num_heads=num_heads)
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"fused_decode_attention_multi takes caches of q's dtype "
                         f"{q.dtype}, got {k_cache.dtype}, {v_cache.dtype}")
    out = _launch_multi(q, k_cache, v_cache, index, num_heads)
    _build.count_launch(fused_decode_attention_multi)
    return out


def _check_q8(name, q, kv_vals, scales):
    """Raise on int8-cache shapes and types that do not fit q [B, T, hidden]."""
    B, T, hd = q.shape
    L = kv_vals.shape[1] if kv_vals.dim() == 3 else -1
    if kv_vals.shape != (B, L, 2 * hd) or scales.shape != (B, L, SCALE_LANES):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, values "
                         f"{tuple(kv_vals.shape)}, scales {tuple(scales.shape)} do not fit")
    if kv_vals.dtype != torch.int8 or scales.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes int8 values and a bf16 scale plane, got "
                         f"{kv_vals.dtype}, {scales.dtype}")


def fused_decode_attention_q8_multi(q, kv_vals, scales, index, *,
                                    num_heads: int) -> torch.Tensor:
    """Multi-query decode over the int8 cache: q [B, T, hidden] (bf16/f32);
    kv_vals int8 [B, L, 2·hidden] (K ++ V) and scales bf16 [B, L, 128]
    already holding the T new rows at index[b] ..; index an int32 [B] tensor
    on q's device. Returns [B, T, hidden] in q's dtype."""
    _check_q8("fused_decode_attention_q8_multi", q, kv_vals, scales)
    if not _on_cuda("fused_decode_attention_q8_multi", q):
        return fused_decode_attention_q8_multi_reference(q, kv_vals, scales, index,
                                                         num_heads=num_heads)
    out = _launch_quant("fused_decode_attention_q8_multi", q, kv_vals, scales, index,
                        num_heads, 8)
    _build.count_launch(fused_decode_attention_q8_multi)
    return out


def fused_decode_attention_q8(q, kv_vals, scales, index, *,
                              num_heads: int) -> torch.Tensor:
    """One query per row over the int8 cache: q [B, hidden]; index an int32
    [B] tensor on q's device (the decode step's position, built once per
    step) or a host int. Runs the kernel of `fused_decode_attention_q8_multi`
    at T = 1. Returns [B, hidden]."""
    _check_q8("fused_decode_attention_q8", q[:, None], kv_vals, scales)
    if not _on_cuda("fused_decode_attention_q8", q):
        return fused_decode_attention_q8_reference(q, kv_vals, scales, index,
                                                   num_heads=num_heads)
    out = _launch_quant("fused_decode_attention_q8", q[:, None], kv_vals, scales, index,
                        num_heads, 8)[:, 0]
    _build.count_launch(fused_decode_attention_q8)
    return out


# ------------------------------------------------------------ the int4 cache --

def fused_decode_attention_q4_multi_reference(q, kv_vals, scales, index, *, num_heads: int,
                                              group: int = 0) -> torch.Tensor:
    """The plain version over the int4 cache: dequantise in f32, then attend."""
    k, v = dequantize_cache(kv_vals, scales, torch.float32, bits=4, group=group)
    return fused_decode_attention_multi_reference(q, k, v, index, num_heads=num_heads)


def fused_decode_attention_q4_reference(q, kv_vals, scales, index, *, num_heads: int,
                                        group: int = 0) -> torch.Tensor:
    """Row 7's plain version: q [B, hidden], one query per row."""
    return fused_decode_attention_q4_multi_reference(q[:, None], kv_vals, scales, index,
                                                     num_heads=num_heads, group=group)[:, 0]


def _check_q4(name, q, kv_vals, scales, num_heads: int, group: int):
    """Raise on int4-cache shapes, types and groups that do not fit q [B, T,
    hidden], or that the kernel's 8-lane loads cannot take: hidden must be a
    multiple of 16 and the head dim of 8, so that no load straddles
    hidden/2."""
    B, T, hd = q.shape
    L = kv_vals.shape[1] if kv_vals.dim() == 3 else -1
    if kv_vals.shape != (B, L, hd) or scales.shape != (B, L, SCALE_LANES):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, values "
                         f"{tuple(kv_vals.shape)}, scales {tuple(scales.shape)} do not fit")
    if kv_vals.dtype != torch.int8 or scales.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes int8 nibbles and a bf16 scale plane, got "
                         f"{kv_vals.dtype}, {scales.dtype}")
    if hd % 16 or hd % num_heads or (hd // num_heads) % 8:
        raise ValueError(f"{name} takes a hidden width that is a multiple of 16 over "
                         f"heads whose dim is a multiple of 8, got {hd} over {num_heads}")
    if group:
        check_group(hd, group)


def fused_decode_attention_q4_multi(q, kv_vals, scales, index, *, num_heads: int,
                                    group: int = 0) -> torch.Tensor:
    """Multi-query decode over the int4 cache: q [B, T, hidden] (bf16/f32);
    kv_vals int8 [B, L, hidden] of packed nibbles (K's bytes, then V's) and
    scales bf16 [B, L, 128] (per-row, or `group` lanes per scale) already
    holding the T new rows at index[b] ..; index an int32 [B] tensor on q's
    device. Returns [B, T, hidden] in q's dtype."""
    _check_q4("fused_decode_attention_q4_multi", q, kv_vals, scales, num_heads, group)
    if not _on_cuda("fused_decode_attention_q4_multi", q):
        return fused_decode_attention_q4_multi_reference(q, kv_vals, scales, index,
                                                         num_heads=num_heads, group=group)
    out = _launch_quant("fused_decode_attention_q4_multi", q, kv_vals, scales, index,
                        num_heads, 4, group)
    _build.count_launch(fused_decode_attention_q4_multi)
    return out


def fused_decode_attention_q4(q, kv_vals, scales, index, *, num_heads: int,
                              group: int = 0) -> torch.Tensor:
    """One query per row over the int4 cache: q [B, hidden]; index an int32
    [B] tensor on q's device (the decode step's position) or a host int.
    Runs the kernel of `fused_decode_attention_q4_multi` at T = 1. Returns
    [B, hidden]."""
    _check_q4("fused_decode_attention_q4", q[:, None], kv_vals, scales, num_heads, group)
    if not _on_cuda("fused_decode_attention_q4", q):
        return fused_decode_attention_q4_reference(q, kv_vals, scales, index,
                                                   num_heads=num_heads, group=group)
    out = _launch_quant("fused_decode_attention_q4", q[:, None], kv_vals, scales, index,
                        num_heads, 4, group)[:, 0]
    _build.count_launch(fused_decode_attention_q4)
    return out


fused_decode_attention_multi.launches = 0
fused_decode_attention_q8_multi.launches = 0
fused_decode_attention_q8.launches = 0
fused_decode_attention_q4_multi.launches = 0
fused_decode_attention_q4.launches = 0

"""Flash attention: the wrappers of the hand-written CUDA kernels
(csrc/flash_fwd.cu, csrc/flash_bwd.cu), their plain versions, and the
differentiable attentions that join them.

Replaces the TPU kernels `_fwd` / `_fwd_t` and `_bwd` / `_bwd_t` reached from
edgerunner_tpu/ops/flash_attention.py:1336 (`flash_attention`, a
`jax.custom_vjp`) and from :1363 (`flash_attention_lse`, the custom_vjp
`_flash_core_lse` :1220-1246, whose forward also returns lse and whose
backward takes the lse cotangent). On a CUDA tensor each wrapper launches its
kernel or raises; on a CPU tensor it runs its plain version. `FlashAttention`
and `FlashAttentionLse` are the `torch.autograd.Function`s whose forward is
the forward kernel and whose backward is the backward kernel; the second
returns (out, lse) and folds the lse cotangent into delta before the
backward kernel, as the JAX package does outside its kernels
(flash_attention.py:541-544). Row 5's wrappers (`flash_attention_lse`,
`flash_attention_lse_bwd`) launch the same kernels as rows 1-4 under their
own launch counts, so that a run tells ring attention's launches apart from
the point encoder's. Both kernels are bound by operations at the main path's
shapes (see the sources' notes), and the library chooses their instance by
dtype, never one for the other: a bf16 tensor launches the bf16 mma.sync
instances; an f32 tensor launches the 3xTF32 mma.sync instances of both
(each product as three TF32 products of split operands, f32-exact like the
TPU kernel's f32 dots).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from edgerunner_tpu_torch.ops import _build
from edgerunner_tpu_torch.ops.attention import _length_mask, attention_reference_lse

__all__ = ["FlashAttention", "FlashAttentionLse", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_reference", "flash_attention_lse",
           "flash_attention_lse_bwd", "flash_attention_reference"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 96)

# the plain version of the forward: same function, f32 math, no kernel
flash_attention_reference = attention_reference_lse


def _lengths(x: Optional[torch.Tensor], B: int, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    x = torch.as_tensor(x, device=device).to(torch.int32).contiguous()
    if x.shape != (B,):
        raise ValueError(f"length vector must have shape ({B},), got {tuple(x.shape)}")
    return x


def _check(q, k, v, causal: bool, name: str, *more):
    """Raise on what the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    B, N, H, D = q.shape
    M = k.shape[1]
    if k.shape != (B, M, H, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if causal and N != M:
        raise ValueError(f"causal attention needs N == M, got {N} and {M}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes f32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name} has kernels for head dims {HEAD_DIMS}, got {D}")
    for label, t in (("q", q), ("k", k), ("v", v), *more):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{label} must be a contiguous, 16-byte aligned "
                             f"tensor on {q.device}")


def _forward_kernel(q, k, v, causal, q_len, kv_len):
    """Launch the forward kernel: (out, lse [B,N,H] f32)."""
    _check(q, k, v, causal, "flash_attention")
    B, N, H, D = q.shape
    M = k.shape[1]
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
    return out, lse


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
    out = _forward_kernel(q, k, v, causal, q_len, kv_len)
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0


def _dout_and_delta(o, do, q_len, dlse=None):
    """dO with rows past q_len zeroed (the forward zeroes those output rows,
    so they take no gradient), and delta = rowsum(dO * O) - dlse [B, N, H] in
    f32, as the JAX package forms it outside its kernels
    (flash_attention.py:539-544): the lse cotangent adds p * dlse to each
    score's gradient, ds = p * (dp - (delta - dlse)), so it folds into delta
    and the kernels are unchanged."""
    if q_len is not None:
        do = torch.where(_length_mask(q_len, do.shape[1])[:, :, None, None], do, 0)
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return do, delta.contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal: bool = False,
                                  q_len: Optional[torch.Tensor] = None,
                                  kv_len: Optional[torch.Tensor] = None,
                                  dlse: Optional[torch.Tensor] = None):
    """The plain version of the backward kernel: (dq, dk, dv) in q's dtype.

    Recomputes p = exp(s - lse) from the forward's f32 lse and forms
    delta = rowsum(dO * O) - dlse (dlse, the lse cotangent, None for zero),
    as `_bwd` does (edgerunner_tpu/ops/
    flash_attention.py:520-545); for bf16 inputs p and ds are rounded to bf16
    before the products that take them. A row without any valid key
    (kv_len 0) averaged V uniformly over the M keys in the forward, so it
    gets the weights 1/M and no gradient to q or k, as autograd through
    `attention_reference` gives. Runs head by head to bound its memory.
    """
    B, N, H, D = q.shape
    M = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    do, delta = _dout_and_delta(o, do, q_len, dlse)
    if q.dtype == torch.float32:
        rnd = lambda x: x  # noqa: E731
    else:
        rnd = lambda x: x.to(q.dtype).float()  # noqa: E731
    valid = torch.ones((B, N, M), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & torch.ones((N, M), dtype=torch.bool, device=q.device).tril()
    if kv_len is not None:
        valid = valid & _length_mask(kv_len, M)[:, None, :]
        dead = (torch.as_tensor(kv_len, device=q.device) == 0)[:, None, None]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for h in range(H):
        qh, kh, vh, doh = (x[:, :, h].float() for x in (q, k, v, do))
        s = torch.einsum("bnd,bmd->bnm", qh, kh) * scale
        p = torch.where(valid, torch.exp(s - lse[:, :, h, None]), 0.0)
        if kv_len is not None:
            p = torch.where(dead, 1.0 / M, p)
        dp = torch.einsum("bnd,bmd->bnm", doh, vh)
        ds = torch.where(valid, p * (dp - delta[:, :, h, None]), 0.0)
        dv[:, :, h] = torch.einsum("bnm,bnd->bmd", rnd(p), doh).to(v.dtype)
        dq[:, :, h] = (scale * torch.einsum("bnm,bmd->bnd", rnd(ds), kh)).to(q.dtype)
        dk[:, :, h] = (scale * torch.einsum("bnm,bnd->bmd", rnd(ds), qh)).to(k.dtype)
    return dq, dk, dv


def _backward_kernel(q, k, v, o, lse, do, causal, q_len, kv_len, dlse):
    """Launch the backward kernels: (dq, dk, dv)."""
    B, N, H, D = q.shape
    M = k.shape[1]
    q_len = _lengths(q_len, B, q.device)
    kv_len = _lengths(kv_len, B, q.device)
    do, delta = _dout_and_delta(o, do.to(q.dtype), q_len, dlse)
    do = do.contiguous()
    if lse.shape != (B, N, H) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 [{B}, {N}, {H}] tensor")
    _check(q, k, v, causal, "flash_attention_bwd", ("do", do))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    lib = _build.load_library()
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        0 if q_len is None else q_len.data_ptr(),
        0 if kv_len is None else kv_len.data_ptr(),
        B, N, M, H, D, DTYPE_CODES[q.dtype], int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        q_len: Optional[torch.Tensor] = None,
                        kv_len: Optional[torch.Tensor] = None,
                        dlse: Optional[torch.Tensor] = None):
    """Gradients (dq, dk, dv) of `flash_attention`'s output, given its out
    `o`, its lse, the output gradient `do` [B,N,H,D] and, where lse is used
    too, lse's gradient `dlse` [B,N,H]."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                             q_len=q_len, kv_len=kv_len, dlse=dlse)
    grads = _backward_kernel(q, k, v, o, lse, do, causal, q_len, kv_len, dlse)
    _build.count_launch(flash_attention_bwd)
    return grads


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, and the backward
    kernel for its gradient (the port's counterpart of `_flash_core`'s
    custom_vjp). On CPU tensors both run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_len, kv_len):
        out, lse = flash_attention(q, k, v, causal=causal, q_len=q_len, kv_len=kv_len)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse, q_len, kv_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_len, kv_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal, q_len=q_len, kv_len=kv_len)
        return dq, dk, dv, None, None, None


# ------------------------------------------------------------------- row 5 --

def flash_attention_lse(q, k, v, *, causal: bool = False,
                        kv_len: Optional[torch.Tensor] = None):
    """TPU row 5 (edgerunner_tpu/ops/flash_attention.py:1363): q [B,N,H,D],
    k/v [B,M,H,D] -> (out [B,N,H,D], lse [B,N,H] f32), the forward kernel for
    a CUDA tensor and `attention_reference_lse` for a CPU tensor. The blocks
    of ring attention come here: the causal diagonal and the non-causal
    off-diagonal blocks, merged by their lse."""
    if q.device.type == "cpu":
        return attention_reference_lse(q, k, v, causal=causal, kv_len=kv_len)
    out = _forward_kernel(q, k, v, causal, None, kv_len)
    _build.count_launch(flash_attention_lse)
    return out


flash_attention_lse.launches = 0


def flash_attention_lse_bwd(q, k, v, o, lse, do, dlse=None, *, causal: bool = False,
                            kv_len: Optional[torch.Tensor] = None):
    """Row 5's backward: (dq, dk, dv) from out `o`, `lse`, their gradients
    `do` and `dlse` (None for zero), the backward kernels with
    delta = rowsum(dO * O) - dlse for a CUDA tensor, the plain version for a
    CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                             kv_len=kv_len, dlse=dlse)
    grads = _backward_kernel(q, k, v, o, lse, do, causal, None, kv_len, dlse)
    _build.count_launch(flash_attention_lse_bwd)
    return grads


flash_attention_lse_bwd.launches = 0


class FlashAttentionLse(torch.autograd.Function):
    """Differentiable (out, lse) = `flash_attention_lse`, in both outputs:
    the port's counterpart of `_flash_core_lse`'s custom_vjp
    (flash_attention.py:1220-1246)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_len):
        out, lse = flash_attention_lse(q, k, v, causal=causal, kv_len=kv_len)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv = flash_attention_lse_bwd(q, k, v, out, lse, do.contiguous(), dlse,
                                             causal=ctx.causal, kv_len=kv_len)
        return dq, dk, dv, None, None

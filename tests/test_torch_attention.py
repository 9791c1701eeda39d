"""The port's attention, flash-attention and decode-attention plain versions
against the JAX package: its Pallas kernels run in interpret mode on the CPU
(as tests/test_flash_attention.py and tests/test_decode_kernel.py run them)
and its plain `attention_reference` / `decode_attention`.

Tolerance: atol 2e-5, rtol 2e-4 in f32, the bound the JAX kernel tests hold
their own kernels to against the same reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.ops.attention import attention_reference as j_attention_reference
from edgerunner_tpu.ops.attention import decode_attention as j_decode_attention
from edgerunner_tpu.ops.decode_attention_pallas import fused_decode_attention as j_fused_decode
from edgerunner_tpu.ops.flash_attention import flash_attention as j_flash
from edgerunner_tpu.ops.flash_attention import flash_attention_lse as j_flash_lse
from edgerunner_tpu_torch.ops.attention import attention, attention_reference, decode_attention
from edgerunner_tpu_torch.ops.decode_attention import (
    fused_decode_attention,
    fused_decode_attention_reference,
)
from edgerunner_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

TOL = dict(atol=2e-5, rtol=2e-4)


def _qkv(B, N, M, H, D, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=s).astype(np.float32)
                 for s in ((B, N, H, D), (B, M, H, D), (B, M, H, D)))


CASES = [
    # B, N, M, H, D, causal, kv_len, q_len
    (2, 256, 256, 2, 64, False, None, None),
    (2, 256, 256, 2, 64, True, None, None),
    (2, 256, 256, 2, 64, True, [100, 256], [100, 256]),
    (1, 200, 200, 2, 96, True, None, None),
    (2, 77, 300, 2, 96, False, [300, 131], None),
    (2, 130, 130, 3, 64, False, [7, 130], [130, 60]),
]


@pytest.mark.parametrize("B,N,M,H,D,causal,kv_len,q_len", CASES)
def test_flash_plain_matches_jax_kernel_and_reference(B, N, M, H, D, causal, kv_len, q_len):
    q, k, v = _qkv(B, N, M, H, D)
    jkw = dict(causal=causal,
               kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32),
               q_len=None if q_len is None else jnp.asarray(q_len, jnp.int32))
    tkw = dict(causal=causal,
               kv_len=None if kv_len is None else torch.tensor(kv_len),
               q_len=None if q_len is None else torch.tensor(q_len))
    out, lse = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **tkw)
    kernel = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     block_q=128, block_k=128, **jkw)
    ref = j_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **tkw).numpy(),
        out.numpy(), rtol=0, atol=0)
    assert lse.shape == (B, N, H) and lse.dtype == torch.float32


@pytest.mark.parametrize("causal,D", [(False, 64), (True, 96)])
def test_flash_lse_matches_jax(causal, D):
    q, k, v = _qkv(2, 160, 160, 2, D, seed=1)
    kv_len = np.array([160, 90], np.int32)
    _, lse = flash_attention_reference(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                       causal=causal, kv_len=torch.tensor(kv_len))
    _, jlse = j_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                          kv_len=jnp.asarray(kv_len), block_q=128, block_k=128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


def test_row_without_keys_follows_the_reference():
    """kv_len 0: every logit is NEG_INF, so the reference averages V uniformly
    over the M keys (the JAX Pallas kernel averages over its padded length
    instead; ROADMAP.md section 3)."""
    q, k, v = _qkv(2, 100, 100, 2, 64, seed=2)
    kv_len = np.array([0, 100], np.int32)
    out, _ = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                             kv_len=torch.tensor(kv_len))
    ref = j_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy()[0], np.broadcast_to(v[0].mean(0), (100, 2, 64)),
                               **TOL)


def test_reference_bf16_returns_input_dtype():
    q, k, v = (torch.tensor(x).bfloat16() for x in _qkv(1, 9, 9, 2, 64))
    assert attention_reference(q, k, v, causal=True).dtype == torch.bfloat16


def test_causal_needs_square():
    q, k, v = (torch.tensor(x) for x in _qkv(1, 4, 6, 1, 64))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("D", [64, 96])
@pytest.mark.parametrize("index", [0, 127, 128, 200, 255])
def test_decode_plain_matches_jax_kernel(index, D):
    B, L, H = 2, 256, 4
    r = np.random.default_rng(index)
    kc, vc = (r.normal(size=(B, L, H * D)).astype(np.float32) for _ in range(2))
    q = r.normal(size=(B, H * D)).astype(np.float32)
    out = fused_decode_attention(torch.tensor(q), torch.tensor(kc), torch.tensor(vc),
                                 index, num_heads=H)
    kernel = j_fused_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), index,
                            num_heads=H, block=128)
    ref = j_decode_attention(jnp.asarray(q).reshape(B, 1, H, D),
                             jnp.asarray(kc).reshape(B, L, H, D),
                             jnp.asarray(vc).reshape(B, L, H, D), index + 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(B, H * D), **TOL)


def test_decode_reads_only_the_prefix():
    B, L, H, D, idx = 1, 256, 2, 64, 100
    r = np.random.default_rng(1)
    kc, vc = (r.normal(size=(B, L, H * D)).astype(np.float32) for _ in range(2))
    q = torch.tensor(r.normal(size=(B, H * D)).astype(np.float32))
    a = fused_decode_attention(q, torch.tensor(kc), torch.tensor(vc), idx, num_heads=H)
    kc[:, idx + 1:], vc[:, idx + 1:] = 1e6, -1e6
    b = fused_decode_attention(q, torch.tensor(kc), torch.tensor(vc), idx, num_heads=H)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decode_attention_plain_matches_jax_per_row_lengths():
    B, L, H, D = 3, 40, 2, 48
    r = np.random.default_rng(2)
    q = r.normal(size=(B, 1, H, D)).astype(np.float32)
    kc, vc = (r.normal(size=(B, L, H, D)).astype(np.float32) for _ in range(2))
    idx = np.array([1, 17, 40], np.int32)
    out = decode_attention(torch.tensor(q), torch.tensor(kc), torch.tensor(vc), torch.tensor(idx))
    ref = j_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(idx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (flash_attention.launches, fused_decode_attention.launches)
    q, k, v = (torch.tensor(x) for x in _qkv(1, 8, 8, 2, 64))
    flash_attention(q, k, v, causal=True)
    fused_decode_attention(q[:, 0].reshape(1, -1), k.reshape(1, 8, -1),
                           v.reshape(1, 8, -1), 3, num_heads=2)
    assert (flash_attention.launches, fused_decode_attention.launches) == before

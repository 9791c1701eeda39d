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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
    # shapes that straddle the CUDA kernels' 64-row tiles
    (1, 63, 63, 2, 64, True, None, None),
    (2, 65, 65, 2, 96, True, [65, 30], [65, 30]),     # kv_len in the middle of a tile
    (1, 127, 129, 2, 64, False, None, [100]),         # not square, not causal
    (2, 129, 129, 1, 96, True, [129, 100], None),
    (1, 191, 65, 2, 96, False, [33], [191]),
    (2, 191, 191, 2, 64, True, [191, 128], [191, 128]),
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


@pytest.mark.parametrize("causal", [False, True])
def test_row_without_keys_follows_the_reference(causal):
    """kv_len 0: every logit is NEG_INF, so the reference averages V uniformly
    over the M keys, causal or not (the JAX Pallas kernel averages over its
    padded length instead; ROADMAP.md section 3)."""
    q, k, v = _qkv(2, 100, 100, 2, 64, seed=2)
    kv_len = np.array([0, 100], np.int32)
    out, _ = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                             causal=causal, kv_len=torch.tensor(kv_len))
    ref = j_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, kv_len=jnp.asarray(kv_len))
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


@pytest.mark.parametrize("index", [0, 15, 16, 255, 256, 257, 511])
def test_decode_takes_a_position_tensor_as_well_as_a_host_int(index):
    """Kernel B's wrapper and its plain version take the decode step's int32
    [B] position vector (or a scalar tensor) and give what the host int
    gives, bit for bit."""
    B, L, H, D = 3, 512, 2, 96
    r = np.random.default_rng(index + 3)
    kc, vc = (torch.tensor(r.normal(size=(B, L, H * D)).astype(np.float32)) for _ in range(2))
    q = torch.tensor(r.normal(size=(B, H * D)).astype(np.float32))
    by_int = fused_decode_attention(q, kc, vc, index, num_heads=H)
    for pos in (torch.full((B,), index, dtype=torch.int32), torch.tensor(index)):
        torch.testing.assert_close(fused_decode_attention(q, kc, vc, pos, num_heads=H), by_int,
                                   rtol=0, atol=0)
        torch.testing.assert_close(fused_decode_attention_reference(q, kc, vc, pos, num_heads=H),
                                   by_int, rtol=0, atol=0)


@pytest.mark.parametrize("D", [64, 96])
def test_decode_plain_per_row_positions_match_jax(D):
    """Per-row positions (tile and split edges, the last row) against JAX
    `decode_attention` with [B] lengths index + 1, and each row against the
    Pallas kernel at that row's position broadcast (interpret mode, f32)."""
    B, L, H = 4, 512, 2
    idx = np.array([0, 255, 257, L - 1], np.int32)
    r = np.random.default_rng(D)
    kc, vc = (r.normal(size=(B, L, H * D)).astype(np.float32) for _ in range(2))
    q = r.normal(size=(B, H * D)).astype(np.float32)
    out = fused_decode_attention(torch.tensor(q), torch.tensor(kc), torch.tensor(vc),
                                 torch.tensor(idx), num_heads=H).numpy()
    ref = j_decode_attention(jnp.asarray(q).reshape(B, 1, H, D),
                             jnp.asarray(kc).reshape(B, L, H, D),
                             jnp.asarray(vc).reshape(B, L, H, D), jnp.asarray(idx + 1))
    np.testing.assert_allclose(out, np.asarray(ref).reshape(B, H * D), **TOL)
    for b, i in enumerate(idx):
        kernel = j_fused_decode(jnp.asarray(q[b:b + 1]), jnp.asarray(kc[b:b + 1]),
                                jnp.asarray(vc[b:b + 1]), int(i), num_heads=H, block=128)
        np.testing.assert_allclose(out[b:b + 1], np.asarray(kernel), **TOL)


def test_decode_clamps_positions_outside_the_cache_as_the_kernel_does():
    B, L, H, D = 2, 64, 2, 64
    r = np.random.default_rng(9)
    kc, vc = (torch.tensor(r.normal(size=(B, L, H * D)).astype(np.float32)) for _ in range(2))
    q = torch.tensor(r.normal(size=(B, H * D)).astype(np.float32))
    out = fused_decode_attention(q, kc, vc, torch.tensor([-5, L + 7], dtype=torch.int32),
                                 num_heads=H)
    want = fused_decode_attention(q, kc, vc, torch.tensor([0, L - 1], dtype=torch.int32),
                                  num_heads=H)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    with pytest.raises(ValueError):  # a host int outside the cache is refused
        fused_decode_attention(q, kc, vc, L, num_heads=H)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (flash_attention.launches, fused_decode_attention.launches)
    q, k, v = (torch.tensor(x) for x in _qkv(1, 8, 8, 2, 64))
    flash_attention(q, k, v, causal=True)
    fused_decode_attention(q[:, 0].reshape(1, -1), k.reshape(1, 8, -1),
                           v.reshape(1, 8, -1), 3, num_heads=2)
    assert (flash_attention.launches, fused_decode_attention.launches) == before

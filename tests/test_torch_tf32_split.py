"""The numerics of kernel A's f32 instance (csrc/flash_fwd.cu,
`flash_fwd_tf32_mma_kernel`), emulated on the CPU: each product of the flash
forward as three TF32 products of split operands (3xTF32), with the kernel's
64-key tiles, base-2 online softmax and the key permutation inside each
8-key chunk of PV.

TF32 keeps 10 mantissa bits: the emulation rounds to nearest with ties away
from zero (cvt.rna.tf32.f32, which the kernel computes with integer
instructions), splits x into big = rna(x) and small = rna(x - big), and
multiplies exactly in f32 (11-bit significands give 22-bit products). It is
held to the JAX package's `flash_attention` (its Pallas kernel in interpret
mode, as tests/test_flash_attention.py runs it) and to the port's plain
version under chip_smoke.py's f32 tolerance rule (1e-4 relative plus 1e-5
of the largest value), lse within 1e-3 as chip_smoke.py holds it. On inputs
scaled so that the logits span tens, one TF32 product per product fails
that rule: the split is what keeps the kernel the TPU kernel's f32 function.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import tolerance
from edgerunner_tpu.ops.flash_attention import flash_attention as j_flash
from edgerunner_tpu_torch.ops.flash_attention import flash_attention_reference
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NEG_INF = -1e30
BLOCK_K = 64  # the kernel's keys per tile
# A fragment column c of a PV k-step stands for key PERM[c] of its 8-key
# chunk: thread t's accumulator holds keys 2t and 2t + 1, which become its
# A fragment's columns t and t + 4
PERM = [0, 2, 4, 6, 1, 3, 5, 7]
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest value with 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b as the tensor cores compute it from f32 operands: three TF32
    products (small big + big small first, big big last), or one."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    if products == 1:
        return a_big @ b_big
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def flash_tf32_emulated(q, k, v, *, kv_len=None, products=3, perm=PERM, v_perm=None):
    """The f32 kernel's forward on [B, N, H, D] / [B, M, H, D] numpy arrays:
    (out [B, N, H, D], lse [B, N, H]). `v_perm` reads V's rows of each chunk
    in another order than P's columns (a wrong pairing, for the test)."""
    q, k, v = (torch.from_numpy(x).permute(0, 2, 1, 3) for x in (q, k, v))  # [B, H, *, D]
    B, H, N, D = q.shape
    M = k.shape[2]
    klen = torch.full((B,), M) if kv_len is None else torch.tensor(kv_len).clamp(max=M)
    scale_log2 = np.float32(LOG2E / math.sqrt(D))
    m = torch.full((B, H, N), NEG_INF)
    l = torch.zeros((B, H, N))
    acc = torch.zeros((B, H, N, D))
    for k0 in range(0, M, BLOCK_K):
        kt, vt = k[:, :, k0:k0 + BLOCK_K], v[:, :, k0:k0 + BLOCK_K]
        T = kt.shape[2]
        s = matmul_tf32(q, kt.transpose(-1, -2), products) * scale_log2
        keys = k0 + torch.arange(T)
        s = torch.where(keys[None, None, None, :] >= klen[:, None, None, None],
                        torch.tensor(NEG_INF), s)
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        # keys past M carry no weight: the ragged chunk is zero-padded
        pad = -T % 8
        p = torch.nn.functional.pad(p, (0, pad))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
        pc = p.reshape(B, H, N, -1, 8)[..., perm]
        vc = vt.reshape(B, H, -1, 8, D)[:, :, :, perm if v_perm is None else v_perm]
        for c in range(pc.shape[3]):  # one k-step per 8 keys, in the kernel's order
            acc = acc + matmul_tf32(pc[:, :, :, c], vc[:, :, c], products)
        m = mn
    safe = torch.where(l > 0, l, torch.ones(()))
    out = acc / safe[..., None]
    lse = torch.where(m == NEG_INF, torch.tensor(NEG_INF), m * LN2 + torch.log(safe))
    return out.permute(0, 2, 1, 3).numpy(), lse.permute(0, 2, 1).numpy()


def _inputs(B, N, M, H, D, seed, qk_scale=1.0):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=s).astype(np.float32)
               for s in ((B, N, H, D), (B, M, H, D), (B, M, H, D)))
    return q * np.float32(qk_scale), k * np.float32(qk_scale), v


def _plain(q, k, v, kv_len=None):
    out, lse = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_len=None if kv_len is None else torch.tensor(kv_len))
    return out.numpy(), lse.numpy()


def _within_rule(out, ref) -> bool:
    """chip_smoke.py's f32 rule for a kernel against its plain version."""
    atol, rtol = tolerance(torch.float32, torch.tensor(ref))
    return bool(np.isfinite(out).all() and (np.abs(out - ref) <= atol + rtol * np.abs(ref)).all())


def test_tf32_rounding_is_to_nearest_with_ties_away_from_zero():
    r = np.random.default_rng(0)
    x = (r.normal(size=4096) * 10.0 ** r.integers(-6, 6, size=4096)).astype(np.float32)
    e = np.floor(np.log2(np.abs(x)))
    ulp = 2.0 ** (e - 10)  # 10 mantissa bits
    want = np.sign(x) * np.floor(np.abs(x.astype(np.float64)) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(tf32_rna(torch.from_numpy(x)).numpy(), want.astype(np.float32))
    # a tie (1 + 2^-11, half a TF32 step above 1) goes away from zero
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], dtype=torch.float32)
    assert tf32_rna(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]
    # big + small holds x to 2^-22 of |x| (f32 keeps 2^-24)
    big, small = split(torch.from_numpy(x))
    rel = np.abs((big.double() + small.double()).numpy() - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -22


# the DiT's attentions cut to size: self over 256 latents, cross onto 33
# tokens (as 257 = 256 + 1: the last 8-key chunk holds one key), a ragged
# cross case (kv_len 10 inside the second 8-key chunk), and D 96 over 130
# keys (a last 64-key tile of two keys) with a ragged row
CASES = [
    ("self", (2, 256, 256, 4, 64), None),
    ("cross", (2, 256, 33, 4, 64), None),
    ("cross ragged", (2, 256, 33, 4, 64), [33, 10]),
    ("self d96", (2, 128, 130, 2, 96), [130, 70]),
]


@pytest.mark.parametrize("name,shape,kv_len", CASES, ids=[c[0] for c in CASES])
def test_3xtf32_emulation_matches_jax_and_the_plain_version(name, shape, kv_len):
    q, k, v = _inputs(*shape, seed=len(name))
    out, lse = flash_tf32_emulated(q, k, v, kv_len=kv_len)
    ref, ref_lse = _plain(q, k, v, kv_len)
    jax_out = np.asarray(j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128,
        kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32)))
    assert _within_rule(out, jax_out)
    assert _within_rule(out, ref)
    assert np.abs(lse - ref_lse).max() <= 1e-3


@pytest.mark.parametrize("name,shape,kv_len", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_one_tf32_product_fails_the_f32_rule_where_three_pass(name, shape, kv_len):
    """q and k scaled by 3: logits spanning tens, as chip_smoke.py's TF32
    diagnostic has them on the card."""
    q, k, v = _inputs(*shape, seed=7, qk_scale=3.0)
    ref, _ = _plain(q, k, v, kv_len)
    logits = np.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(shape[-1])
    assert logits.max() - logits.min() > 40
    three, _ = flash_tf32_emulated(q, k, v, kv_len=kv_len, products=3)
    one, _ = flash_tf32_emulated(q, k, v, kv_len=kv_len, products=1)
    assert _within_rule(three, ref)
    assert not _within_rule(one, ref)
    assert np.abs(one - ref).max() > 30 * np.abs(three - ref).max()


def test_the_key_permutation_pairs_p_and_v_rows_alike():
    """PV with P's columns permuted inside each 8-key chunk is PV only if
    V's B fragment reads the same permuted rows; V in key order (the
    layout an unpermuted read would use) is another function."""
    q, k, v = _inputs(1, 64, 64, 2, 64, seed=3)
    ref, _ = _plain(q, k, v)
    same, _ = flash_tf32_emulated(q, k, v)
    crossed, _ = flash_tf32_emulated(q, k, v, v_perm=list(range(8)))
    assert _within_rule(same, ref)
    assert not _within_rule(crossed, ref)

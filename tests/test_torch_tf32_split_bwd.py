"""The numerics of kernel C's f32 instance (csrc/flash_bwd.cu,
`flash_bwd_dq_tf32_mma_kernel` and `flash_bwd_dkv_tf32_mma_kernel`),
emulated on the CPU: every product of the flash backward as three TF32
products of split operands (3xTF32), over the kernels' 32-row streamed
tiles, with P in base 2 from the forward's lse, the masks, delta, the
keyless rows' 1/M weights, and the row permutation inside each 8-row chunk
of the three products that sum over the streamed rows (dS K, P^T dO, dS^T
Q), each tile's share of those sums summed in a fresh fragment and added to
the running sum in f32.

The split and the mma.sync are tests/test_torch_tf32_split.py's (to nearest
with ties away from zero, big = rna(x), small = rna(x - big); each mma.sync
adds its exact products into its accumulator and truncates toward zero). The
emulation is held to the JAX package's `_bwd` (`jax.vjp` of its Pallas flash
attention in interpret mode, as tests/test_torch_flash_backward.py runs it)
and to the port's plain version under chip_smoke.py's f32 tolerance rule
(1e-4 relative plus 1e-5 of the largest value), for dq, dk and dv at D 64
and 96, causal and ragged, and with a keyless row against the plain version
alone (the Pallas backward gives that row no weight: ROADMAP fault 1). On
inputs whose logits span tens, one TF32 product per product fails that rule
where three pass; over the point encoder's 8192 keys, dq chained through
one truncating accumulator fails it where the per-tile sums pass.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.ops.flash_attention import flash_attention as j_flash
from edgerunner_tpu_torch.ops.flash_attention import (
    _dout_and_delta,
    flash_attention_bwd_reference,
    flash_attention_reference,
)
from test_torch_tf32_split import LOG2E, PERM, _within_rule, mma_tf32x3
from test_torch_tf32_split import matmul_tf32 as mm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STREAM = 32  # rows of the kernels' streamed tiles


def weighted_sum(acc, w, z, products, fresh=True):
    """acc plus one streamed tile's share of W Z (W [..., R, 32], Z [..., 32,
    D]): one k-step per 8-row chunk, its rows in the kernels' permuted order,
    summed in a fresh fragment that joins acc by a rounded f32 add; or, with
    `fresh` False, chained into acc itself."""
    part = torch.zeros_like(acc) if fresh else acc
    for c in range(0, w.shape[-1], 8):
        rows = [c + i for i in PERM]
        part = mma_tf32x3(part, w[..., rows], z[..., rows, :], products)
    return acc + part if fresh else part


def bwd_tf32_emulated(q, k, v, o, lse, do, *, causal=False, q_len=None, kv_len=None,
                      products=3, fresh=True):
    """The f32 kernels' (dq, dk, dv) on [B, N|M, H, D] tensors, from the
    forward's o and lse; `fresh` as in `weighted_sum`."""
    B, N, H, D = q.shape
    M = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    scale_log2 = np.float32(scale * LOG2E)
    do, delta = _dout_and_delta(o, do, None if q_len is None else torch.tensor(q_len))
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))  # [B, H, *, D]
    lse2 = lse.permute(0, 2, 1) * np.float32(LOG2E)                  # [B, H, N]
    dl = delta.permute(0, 2, 1)
    klen = torch.tensor([M] * B if kv_len is None else kv_len).clamp(max=M)
    qend = torch.tensor([N] * B if q_len is None else q_len).clamp(max=N)
    dead = (klen == 0)[:, None, None, None]
    # zero-padded to whole streamed tiles, as the kernels' copies zero-fill
    pn, pm = -N % STREAM, -M % STREAM
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, n))  # noqa: E731
    qp, dop = pad(qh, pn), pad(doh, pn)
    kp, vp = pad(kh, pm), pad(vh, pm)
    rows, keys = torch.arange(N + pn), torch.arange(M + pm)

    def weights(q_rows, k_rows):
        """P [B, H, len(q_rows), len(k_rows)] and its valid mask."""
        valid = ((k_rows[None, None, :] < klen[:, None, None])
                 & (q_rows[None, :, None] < qend[:, None, None]))
        if causal:
            valid = valid & (k_rows[None, None, :] <= q_rows[None, :, None])
        return valid[:, None]

    # dq: every query row, key tiles of 32
    dq = torch.zeros((B, H, N + pn, D))
    for k0 in range(0, M + pm, STREAM):
        kt, vt = kp[:, :, k0:k0 + STREAM], vp[:, :, k0:k0 + STREAM]
        s = mm(qp, kt.transpose(-1, -2), products)
        dp = mm(dop, vt.transpose(-1, -2), products)
        lse_rows = torch.nn.functional.pad(lse2, (0, pn))[..., None]
        p = torch.exp2(s * scale_log2 - lse_rows)
        p = torch.where(weights(rows, keys[k0:k0 + STREAM]) & ~dead, p, 0.0)
        ds = p * (dp - torch.nn.functional.pad(dl, (0, pn))[..., None])
        dq = weighted_sum(dq, ds, kt, products, fresh)
    # dk and dv: every key row, query tiles of 32
    dk = torch.zeros((B, H, M + pm, D))
    dv = torch.zeros((B, H, M + pm, D))
    for q0 in range(0, N + pn, STREAM):
        qt, dt = qp[:, :, q0:q0 + STREAM], dop[:, :, q0:q0 + STREAM]
        q_rows = rows[q0:q0 + STREAM]
        lse_t = torch.nn.functional.pad(lse2, (0, pn))[:, :, q0:q0 + STREAM]
        dl_t = torch.nn.functional.pad(dl, (0, pn))[:, :, q0:q0 + STREAM]
        st = mm(kp, qt.transpose(-1, -2), products)          # S^T [B, H, M, 32]
        pt = torch.exp2(st * scale_log2 - lse_t[:, :, None])
        pt = torch.where(weights(q_rows, keys).transpose(-1, -2), pt, 0.0)
        # a row without any valid key: the weights 1/M from every query before q_len
        alive = (q_rows[None, :] < qend[:, None])[:, None, None, :]
        pt = torch.where(dead, torch.where(alive, 1.0 / M, 0.0), pt)
        dv = weighted_sum(dv, pt, dt, products, fresh)
        dpt = mm(vp, dt.transpose(-1, -2), products)
        dst = torch.where(dead, 0.0, pt * (dpt - dl_t[:, :, None]))
        dk = weighted_sum(dk, dst, qt, products, fresh)
    return tuple(x[:, :, :n].permute(0, 2, 1, 3).numpy() * f for x, n, f in
                 ((dq, N, np.float32(scale)), (dk, M, np.float32(scale)), (dv, M, 1.0)))


def _inputs(B, N, M, H, D, seed, qk_scale=1.0):
    r = np.random.default_rng(seed)
    q, k, v, do = (r.normal(size=s).astype(np.float32)
                   for s in ((B, N, H, D), (B, M, H, D), (B, M, H, D), (B, N, H, D)))
    return q * np.float32(qk_scale), k * np.float32(qk_scale), v, do


def _run(q, k, v, do, causal, q_len, kv_len, products=3, fresh=True):
    """(emulated kernel, plain version) gradients."""
    kw = dict(causal=causal, q_len=None if q_len is None else torch.tensor(q_len),
              kv_len=None if kv_len is None else torch.tensor(kv_len))
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = flash_attention_reference(q, k, v, **kw)
    plain = [g.numpy() for g in flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)]
    emu = bwd_tf32_emulated(q, k, v, o, lse, do, causal=causal, q_len=q_len, kv_len=kv_len,
                            products=products, fresh=fresh)
    return emu, plain


CASES = [
    # B, N, M, H, D, causal, kv_len, q_len
    ("causal ragged d64", (2, 130, 130, 2, 64), True, [130, 77], [130, 77]),
    ("causal d96", (1, 100, 100, 2, 96), True, None, None),
    ("cross ragged d96", (2, 77, 200, 2, 96), False, [200, 131], [77, 40]),
    ("tile edges d64", (1, 63, 129, 2, 64), False, None, [50]),
]


@pytest.mark.parametrize("name,shape,causal,kv_len,q_len", CASES, ids=[c[0] for c in CASES])
def test_3xtf32_backward_matches_jax_and_the_plain_version(name, shape, causal, kv_len, q_len):
    q, k, v, do = _inputs(*shape, seed=len(name))
    emu, plain = _run(q, k, v, do, causal, q_len, kv_len)
    jkw = dict(causal=causal, q_len=None if q_len is None else jnp.asarray(q_len, jnp.int32),
               kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32))
    _, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, block_q=128, block_k=128,
                                             bwd_block_q=128, bwd_block_k=128,
                                             interpret=True, **jkw),
                     *(jnp.asarray(x) for x in (q, k, v)))
    pallas = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    for name_g, e, p, j in zip(("dq", "dk", "dv"), emu, plain, pallas):
        assert _within_rule(e, j), name_g
        assert _within_rule(e, p), name_g


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_backward_gives_a_keyless_row_the_plain_versions_weights(causal):
    N = 70
    M = N if causal else 90
    q, k, v, do = _inputs(3, N, M, 2, 64, seed=5)
    emu, plain = _run(q, k, v, do, causal, [N, N, 40], [M, 0, 33])
    for e, p in zip(emu, plain):
        assert _within_rule(e, p)
    assert np.abs(emu[2][1]).max() > 0.05 and not emu[0][1].any() and not emu[1][1].any()


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_product_fails_the_f32_rule_where_three_pass(causal):
    """q and k scaled by 3: logits spanning tens, as on the card's TF32
    diagnostic for the forward."""
    q, k, v, do = _inputs(1, 96, 96, 2, 64, seed=9, qk_scale=3.0)
    logits = np.einsum("bnhd,bmhd->bhnm", q, k) / 8.0
    assert logits.max() - logits.min() > 40
    three, plain = _run(q, k, v, do, causal, None, None, products=3)
    one, _ = _run(q, k, v, do, causal, None, None, products=1)
    assert all(_within_rule(t, p) for t, p in zip(three, plain))
    assert not all(_within_rule(o, p) for o, p in zip(one, plain))
    worst = max(np.abs(o - p).max() / np.abs(t - p).max() for o, t, p in zip(one, three, plain))
    assert worst > 30


def test_the_streamed_sums_add_each_tile_in_a_fresh_fragment():
    """dq sums dS K over every key: at the point encoder's 8192 keys, chained
    through one truncating accumulator, it drifts past the f32 rule (as the
    first design's dq did on the card); a fresh fragment per 32-key tile,
    added in f32, holds it."""
    q, k, v, do = _inputs(1, 32, 8192, 1, 64, seed=0)
    tile, plain = _run(q, k, v, do, False, None, None)
    chained, _ = _run(q, k, v, do, False, None, None, fresh=False)
    assert all(_within_rule(t, p) for t, p in zip(tile, plain))
    assert not _within_rule(chained[0], plain[0])

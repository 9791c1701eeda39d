"""The port's flash-attention backward (the plain version of csrc/flash_bwd.cu)
against the JAX package in f32 on the CPU: `jax.vjp` of its Pallas flash
attention in interpret mode (its `_bwd` / `_bwd_t` kernels, both layouts)
and of its `attention_reference`, on the same inputs and output gradient
from a numpy seed.

Tolerance: atol 1e-4, rtol 1e-3 in f32. The JAX backward pads to 128-row
blocks and sums each gradient over 128-key blocks in another order than the
port's single sum; across up to 200 keys the results move by a few 1e-6,
well below this.

A row without any valid key (kv_len 0) is held against the reference only:
the Pallas backward gives such a row no weight at all (`_bwd` zeroes p where
`_make_valid` is false), which disagrees with its own forward (ROADMAP
fault 1); the port follows the forward, as autograd through the reference
does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.ops.attention import attention_reference as j_attention_reference
from edgerunner_tpu.ops.flash_attention import flash_attention as j_flash
from edgerunner_tpu_torch.ops.attention import attention, attention_reference
from edgerunner_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_reference,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-4, rtol=1e-3)


def _inputs(B, N, M, H, D, seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=s).astype(np.float32)
                 for s in ((B, N, H, D), (B, M, H, D), (B, M, H, D), (B, N, H, D)))


def _port_grads(q, k, v, do, causal, q_len, kv_len):
    kw = dict(causal=causal, q_len=None if q_len is None else torch.tensor(q_len),
              kv_len=None if kv_len is None else torch.tensor(kv_len))
    q, k, v, do = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = flash_attention_reference(q, k, v, **kw)
    return [g.numpy() for g in flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)]


def _jax_grads(fn, q, k, v, do):
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _jkw(causal, q_len, kv_len):
    return dict(causal=causal,
                q_len=None if q_len is None else jnp.asarray(q_len, jnp.int32),
                kv_len=None if kv_len is None else jnp.asarray(kv_len, jnp.int32))


CASES = [
    # B, N, M, H, D, causal, kv_len, q_len, layout of the Pallas kernel
    (2, 130, 130, 2, 64, True, [130, 77], [130, 77], "dn"),
    (2, 77, 200, 2, 96, False, [200, 131], [77, 40], "dn"),
    (1, 100, 100, 2, 96, True, None, None, "nd"),
    (2, 64, 150, 2, 64, False, None, [64, 20], "nd"),
    # shapes that straddle the CUDA kernels' 64-row tiles
    (2, 65, 65, 2, 96, True, [65, 30], [65, 30], "nd"),  # kv_len in the middle of a tile
    (1, 63, 129, 2, 64, False, None, [50], "dn"),        # not square, not causal
    (2, 127, 127, 1, 96, True, [127, 100], None, "nd"),
    (1, 191, 65, 2, 96, False, [33], [191], "dn"),
]


@pytest.mark.parametrize("B,N,M,H,D,causal,kv_len,q_len,layout", CASES)
def test_backward_plain_matches_jax_kernel_and_reference(B, N, M, H, D, causal, kv_len,
                                                         q_len, layout):
    q, k, v, do = _inputs(B, N, M, H, D)
    port = _port_grads(q, k, v, do, causal, q_len, kv_len)
    jkw = _jkw(causal, q_len, kv_len)
    kernel = _jax_grads(lambda a, b, c: j_flash(
        a, b, c, block_q=128, block_k=128, bwd_block_q=128, bwd_block_k=128,
        interpret=True, layout=layout, **jkw), q, k, v, do)
    ref = _jax_grads(lambda a, b, c: j_attention_reference(a, b, c, **jkw), q, k, v, do)
    for p, kg, rg in zip(port, kernel, ref):
        np.testing.assert_allclose(p, kg, **TOL)
        np.testing.assert_allclose(p, rg, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_row_without_keys_follows_the_reference(causal):
    """kv_len 0: the row averaged V over every key in the forward, so dv
    gets 1/M of its dO per key and q, k get no gradient from it."""
    B, N, H, D = 2, 50, 2, 64
    M = N if causal else 70
    q, k, v, do = _inputs(B, N, M, H, D, seed=1)
    port = _port_grads(q, k, v, do, causal, None, [M, 0])
    ref = _jax_grads(lambda a, b, c: j_attention_reference(
        a, b, c, **_jkw(causal, None, [M, 0])), q, k, v, do)
    for p, rg in zip(port, ref):
        np.testing.assert_allclose(p, rg, **TOL)
    np.testing.assert_allclose(port[2][1], np.broadcast_to(do[1].sum(0) / M, (M, H, D)), **TOL)


@pytest.mark.parametrize("causal,kv_len,q_len", [
    (True, [40, 23], [40, 23]), (False, [33, 0], [40, 12])])
def test_autograd_function_on_cpu_equals_autograd_through_the_reference(causal, kv_len, q_len):
    q, k, v, do = (torch.tensor(x) for x in _inputs(2, 40, 40 if causal else 33, 3, 96, seed=2))
    kw = dict(causal=causal, q_len=torch.tensor(q_len), kv_len=torch.tensor(kv_len))
    grads = []
    for fn in (attention, attention_reference):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves, **kw), leaves, do))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)


def test_backward_wrapper_takes_the_plain_version_on_cpu():
    q, k, v, do = (torch.tensor(x) for x in _inputs(1, 20, 20, 2, 64, seed=3))
    o, lse = flash_attention_reference(q, k, v, causal=True)
    launches = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    assert flash_attention_bwd.launches == launches
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_pallas_backward_gives_a_keyless_row_no_weight():
    """Shows the JAX side of ROADMAP fault 1 in the backward: for a row with
    kv_len 0 the Pallas backward's dv is zero, where the reference (and the
    port) give every key 1/M of the row's dO."""
    B, N, M, H, D = 2, 50, 70, 2, 64
    q, k, v, do = _inputs(B, N, M, H, D, seed=1)
    kv = jnp.asarray([M, 0], jnp.int32)
    kernel = _jax_grads(lambda a, b, c: j_flash(
        a, b, c, kv_len=kv, block_q=128, block_k=128, bwd_block_q=128, bwd_block_k=128,
        interpret=True), q, k, v, do)
    port = _port_grads(q, k, v, do, False, None, [M, 0])
    assert not kernel[2][1].any()
    assert np.abs(port[2][1]).max() > 0.1

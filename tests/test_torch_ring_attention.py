"""TPU kernel row 5 and ring attention of the port against the JAX package,
in f32 on the CPU.

Row 5: the port's `flash_attention_lse` (its plain version on a CPU tensor)
and `FlashAttentionLse` against `edgerunner_tpu.ops.flash_attention.
flash_attention_lse(..., interpret=True)`: o, lse, and the gradients of a
loss that reads both o and lse, so that the lse cotangent is not zero.

The ring: `ring_self_attention` over 2 and 4 gloo CPU processes
(tests/torch_sp_workers.py) against the JAX package's
`ring_self_attention(..., impl="flash")` on the virtual CPU mesh, at the
JAX ring test's sizes (B 2, N 128, H 4, D 32), causal and not: outputs and
dq/dk/dv. Every rank must call row 5 r + 1 times in the causal forward (its
diagonal, then the live blocks) and R times in the full one, and the same
blocks in the backward.

Tolerance: atol 2e-5, rtol 2e-4 for outputs and lse (the JAX ring test's),
atol 5e-5, rtol 5e-4 for the gradients (the JAX ring gradient test's): the
two sum the same f32 products in another order, the ring merges in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from edgerunner_tpu.ops import flash_attention as jfa
from edgerunner_tpu.ops.ring_attention import ring_self_attention as jax_ring
from edgerunner_tpu_torch.ops.flash_attention import (
    FlashAttentionLse,
    flash_attention_lse,
    flash_attention_lse_bwd,
)
from torch_sp_workers import ring_cases, spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

OUT_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
B, N, H, D = 2, 128, 4, 32


def _inputs(seed, n=N, m=N):
    r = np.random.default_rng(seed)
    q = r.normal(size=(B, n, H, D)).astype(np.float32)
    k = r.normal(size=(B, m, H, D)).astype(np.float32)
    v = r.normal(size=(B, m, H, D)).astype(np.float32)
    w = r.normal(size=(B, n, H, D)).astype(np.float32)
    wl = r.normal(size=(B, n, H)).astype(np.float32)
    return q, k, v, w, wl


# ------------------------------------------------------------------- row 5 --

@pytest.mark.parametrize("causal,n,m", [(True, 128, 128), (False, 96, 160)])
def test_flash_attention_lse_matches_jax(causal, n, m):
    q, k, v, w, wl = _inputs(1, n, m)
    o, lse = flash_attention_lse(*(torch.tensor(x) for x in (q, k, v)), causal=causal)
    jo, jlse = jfa.flash_attention_lse(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                                       interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **OUT_TOL)


@pytest.mark.parametrize("causal,n,m", [(True, 128, 128), (False, 96, 160)])
def test_flash_attention_lse_gradients_with_dlse_match_jax(causal, n, m):
    q, k, v, w, wl = _inputs(2, n, m)
    x = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o, lse = FlashAttentionLse.apply(*x, causal, None)
    loss = (o * torch.tensor(w)).sum() + (lse * torch.tensor(wl)).sum()
    grads = torch.autograd.grad(loss, x)

    def jloss(q, k, v):
        jo, jlse = jfa.flash_attention_lse(q, k, v, causal=causal, interpret=True)
        return (jo * w).sum() + (jlse * wl).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD_TOL, err_msg=f"d{name}")


def test_dlse_folds_into_delta():
    """The lse cotangent changes the gradients by exactly what the chain
    rule gives: d lse / d s = p, so dlse alone acts like do = 0 with
    delta = -dlse."""
    q, k, v, w, wl = _inputs(3, 64, 64)
    q, k, v = (torch.tensor(a) for a in (q, k, v))
    o, lse = flash_attention_lse(q, k, v, causal=True)
    dlse = torch.tensor(wl)
    got = flash_attention_lse_bwd(q, k, v, o, lse, torch.zeros_like(o), dlse, causal=True)
    x = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad((flash_attention_lse(*x, causal=True)[1] * dlse).sum(), x,
                               allow_unused=True)
    assert want[2] is None          # lse does not depend on v: dv is zero
    want = (*want[:2], torch.zeros_like(v))
    # f32, the same products summed in another order
    for name, g, wg in zip("qkv", got, want):
        torch.testing.assert_close(g, wg, atol=1e-5, rtol=1e-4, msg=f"d{name}")


# -------------------------------------------------------------------- ring --

@pytest.fixture(scope="module", params=[2, 4], ids=["R2", "R4"])
def ring(request, tmp_path_factory):
    """(R, inputs, [each rank's results], {causal: JAX out and grads})."""
    R = request.param
    q, k, v, w, _ = _inputs(0)
    ranks = spawn(ring_cases, R, tmp_path_factory.mktemp(f"ring{R}"), q, k, v, w)
    mesh = Mesh(np.asarray(jax.devices()[:R]), axis_names=("sp",))
    ref = {}
    for causal in (True, False):
        def loss(q, k, v):
            o = jax_ring(q, k, v, mesh, causal=causal, impl="flash")
            return (o * w).sum(), o

        (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            q, k, v)
        ref[causal] = np.asarray(o), [np.asarray(g) for g in grads]
    return R, ranks, ref


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_output_matches_jax(ring, causal):
    R, ranks, ref = ring
    tag = "causal" if causal else "full"
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{tag}_out"], ref[causal][0], **OUT_TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_gradients_match_jax(ring, causal):
    R, ranks, ref = ring
    tag = "causal" if causal else "full"
    for r, res in enumerate(ranks):
        for name, jg in zip("qkv", ref[causal][1]):
            np.testing.assert_allclose(res[f"{tag}_d{name}"], jg, **GRAD_TOL,
                                       err_msg=f"rank {r} d{name}")


def test_ring_calls_row5_on_live_blocks_only(ring):
    """Causal: rank r attends its diagonal (causal) and r earlier shards
    (full); dead blocks call nothing. Not causal: every shard, full. The
    backward calls the same blocks, and every rank finished both passes, so
    the collectives matched."""
    R, ranks, _ = ring
    for r, res in enumerate(ranks):
        for d in ("fwd", "bwd"):
            assert res[f"causal_{d}_calls"].tolist() == [1] + [0] * r, (r, d)
            assert res[f"full_{d}_calls"].tolist() == [0] * R, (r, d)

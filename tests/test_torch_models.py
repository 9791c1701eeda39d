"""The port's modules against their JAX counterparts, in f32 on the CPU.

The same weights (a flax init converted through the port's weight mapping)
and the same inputs (numpy, from a seed) go through both. Tolerance: atol
and rtol 1e-5 in f32 — the two frameworks sum the same products in another
order, which moves results by a few f32 ulps, far below this.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.config import Options
from edgerunner_tpu.models import layers as jl
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.models.point_encoder import latent_kl as j_latent_kl
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models import layers as tl
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.models.point_encoder import latent_kl
from edgerunner_tpu_torch.weights import load_state, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
B, N_POINTS = 2, 48


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               torch.as_tensor(b).detach().float().numpy(), **TOL)


def _tiny(**over):
    kw = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
              point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
              hidden_dim=96, num_layers=2, num_heads=2, max_seq_length=256,
              use_num_face_cond=True, checkpointing=False, decode_bucket=64,
              point_num=N_POINTS)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def pair():
    """(jax model, params, port model) with the same weights, tiny width."""
    kw = _tiny()
    jm = JLMM(Options(**kw))
    rng = jax.random.PRNGKey(0)
    conds = jnp.asarray(np.random.default_rng(0).normal(size=(B, N_POINTS, 3)), jnp.float32)
    tokens = jnp.array([[1, 6, 7, 8, 2]] * B)
    labels = jnp.concatenate([jnp.full((B, 18), -100), tokens[:, 1:]], axis=1)
    params = jm.init({"params": rng, "nof": rng, "dropout": rng}, conds, tokens,
                     labels, jnp.array([100] * B), jnp.array([23] * B, jnp.int32))
    params = jax.tree.map(np.asarray, params)
    tm = LMM(TOptions(**kw))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm


def _lin(t: torch.nn.Linear, tree):
    t.weight.data = torch.tensor(np.asarray(tree["kernel"]).T.copy())
    if "bias" in tree:
        t.bias.data = torch.tensor(np.asarray(tree["bias"]))


def _ln(t: torch.nn.LayerNorm, tree):
    t.weight.data = torch.tensor(np.asarray(tree["scale"]))
    t.bias.data = torch.tensor(np.asarray(tree["bias"]))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("heads,dim", [(2, 64), (2, 96)])
def test_cross_attention(heads, dim):
    x, ctx = _rand(B, 5, dim), _rand(B, 33, dim, seed=1)
    jm = jl.CrossAttention(dim, heads)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), x, ctx))["params"]
    tm = tl.CrossAttention(dim, dim, dim, heads)
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _lin(getattr(tm, name), p[name])
    kv_len = np.array([33, 20], np.int32)
    ref = jm.apply({"params": p}, x, ctx, kv_len=jnp.asarray(kv_len))
    _close(ref, tm(torch.tensor(x), torch.tensor(ctx), kv_len=torch.tensor(kv_len)))


@pytest.mark.parametrize("causal", [False, True])
def test_self_attention(causal):
    dim, heads = 64, 2
    x = _rand(B, 19, dim)
    jm = jl.SelfAttention(dim, heads, causal=causal)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), x))["params"]
    tm = tl.SelfAttention(dim, dim, heads, causal=causal)
    _lin(tm.qkv_proj, p["qkv_proj"])
    _lin(tm.out_proj, p["out_proj"])
    lengths = np.array([19, 11], np.int32)
    ref = jm.apply({"params": p}, x, lengths=jnp.asarray(lengths))
    _close(ref, tm(torch.tensor(x), torch.tensor(lengths)))


def test_feed_forward_is_tanh_geglu():
    dim = 32
    x = _rand(B, 7, dim) * 3
    jm = jl.FeedForward(dim)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), x))["params"]
    tm = tl.FeedForward(dim)
    _lin(tm.net[0], p["fc_in"])
    _lin(tm.net[2], p["fc_out"])
    _close(jm.apply({"params": p}, x), tm(torch.tensor(x)))


def test_res_cross_att_block():
    dim, heads = 64, 2
    x, ctx = _rand(B, 6, dim), _rand(B, 21, dim, seed=4)
    jm = jl.ResCrossAttBlock(dim, heads)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4), x, ctx))["params"]
    tm = tl.ResCrossAttBlock(dim, heads)
    _ln(tm.ln1, p["ln1"])
    _ln(tm.ln2, p["ln2"])
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _lin(getattr(tm.att, name), p["att"][name])
    _lin(tm.mlp.net[0], p["mlp"]["fc_in"])
    _lin(tm.mlp.net[2], p["mlp"]["fc_out"])
    _close(jm.apply({"params": p}, x, ctx), tm(torch.tensor(x), torch.tensor(ctx)))


def test_point_encoder_and_kl(pair):
    jm, params, tm = pair
    pts = _rand(B, N_POINTS, 3, seed=5)
    ref = jm.apply(params, jnp.asarray(pts), method=lambda m, p: m.point_encoder(p))
    out = tm.point_encoder(torch.tensor(pts))
    _close(ref, out)
    np.testing.assert_allclose(float(j_latent_kl(ref)), float(latent_kl(out)), rtol=1e-5)


def test_shape_opt_teacher_forcing_logits(pair):
    jm, params, tm = pair
    embeds = _rand(B, 29, 96, seed=6) * 0.1
    lengths = np.array([29, 17], np.int32)
    ref, _, _ = jm.apply(params, jnp.asarray(embeds), lengths=jnp.asarray(lengths),
                         method=lambda m, e, lengths: m.mesh_decoder(e, lengths=lengths))
    out = tm.mesh_decoder(torch.tensor(embeds), torch.tensor(lengths))
    _close(ref, out)


def test_shape_opt_prefill_caches_and_steps(pair):
    jm, params, tm = pair
    P, max_len = 23, 64
    embeds = _rand(B, P, 96, seed=7) * 0.1
    jl_, _, jk, jv = jm.apply(params, jnp.asarray(embeds), max_len,
                              method=lambda m, e, n: m.mesh_decoder.prefill(e, n))
    tlg, (tk, tv) = tm.mesh_decoder.prefill(torch.tensor(embeds), max_len)
    _close(jl_, tlg)
    for a, b in zip(jk + jv, tk + tv):
        assert tuple(b.shape) == (B, max_len, 96)
        _close(a, b)
    ids = np.array([[7], [9]])
    for index in (P, P + 1, P + 2):
        jl_, jk, jv = jm.apply(params, jnp.asarray(ids), jk, jv, index,
                               method=lambda m, t, k, v, i: m.mesh_decoder.step(t, k, v, i))
        tlg = tm.mesh_decoder.step(torch.tensor(ids), (tk, tv), index)
        _close(jl_, tlg)
        for a, b in zip(jk + jv, tk + tv):
            _close(a, b)
        ids = ids + 5


def test_shape_opt_step_gives_the_bf16_kind_a_device_position_vector(pair, monkeypatch):
    """The decode step builds one int32 [B] position vector on the logits'
    device for all layers and hands it to the one-query kernel of every
    cache kind (here the unquantised one, kernel B's wrapper); the step's
    logits still match the JAX step's."""
    jm, params, tm = pair
    P, max_len = 23, 64
    embeds = _rand(B, P, 96, seed=11) * 0.1
    _, _, jk, jv = jm.apply(params, jnp.asarray(embeds), max_len,
                            method=lambda m, e, n: m.mesh_decoder.prefill(e, n))
    _, (tk, tv) = tm.mesh_decoder.prefill(torch.tensor(embeds), max_len)
    seen = []
    for layer in tm.mesh_decoder.model.layers:
        attn = layer.self_attn
        assert attn.decode.__name__ == "fused_decode_attention"

        def spy(q, k, v, index, _decode=attn.decode, **kw):
            seen.append(index)
            return _decode(q, k, v, index, **kw)

        monkeypatch.setattr(attn, "decode", spy)
    ids = np.array([[7], [9]])
    jl_, _, _ = jm.apply(params, jnp.asarray(ids), jk, jv, P,
                         method=lambda m, t, k, v, i: m.mesh_decoder.step(t, k, v, i))
    _close(jl_, tm.mesh_decoder.step(torch.tensor(ids), (tk, tv), P))
    assert len(seen) == len(tm.mesh_decoder.model.layers)
    assert all(x is seen[0] for x in seen)  # built once per step
    assert isinstance(seen[0], torch.Tensor) and seen[0].dtype == torch.int32
    assert seen[0].tolist() == [P] * B


def test_lmm_encode_cond_prefill_step(pair):
    jm, params, tm = pair
    pts = _rand(B, N_POINTS, 3, seed=8)
    nf = np.array([800, 2500], np.int32)
    jc, jkl = jm.apply(params, jnp.asarray(pts), jnp.asarray(nf), method=JLMM.encode_cond)
    tc, tkl = tm.encode_cond(torch.tensor(pts), torch.tensor(nf))
    assert tuple(tc.shape) == (B, 17, 96)
    _close(jc, tc)
    np.testing.assert_allclose(float(jkl), float(tkl), rtol=1e-5)

    prompt = np.ones((B, 1), np.int32)
    jlog, _, jk, jv, jplen = jm.apply(params, jnp.asarray(pts), jnp.asarray(nf),
                                      jnp.asarray(prompt), 64, method=JLMM.prefill)
    tlog, (tk, tv), tplen = tm.prefill(torch.tensor(pts), torch.tensor(nf),
                                       torch.tensor(prompt), 64)
    assert tplen == jplen == 18
    _close(jlog, tlog)
    ids = np.array([[5], [5]])
    jlog, jk, jv = jm.apply(params, jnp.asarray(ids), jk, jv, 18, method=JLMM.step)
    _close(jlog, tm.step(torch.tensor(ids), (tk, tv), 18))

"""The port's int8 KV cache and int8 weights against the JAX package, in f32
on the CPU: the quantised rows and scale planes bit for bit, the plain
versions of the multi-query and int8 decode kernels against the Pallas
kernels (interpret mode, block 128), QuantDense and quantize_lmm_params,
and greedy generation with kv_quant (and w_quant) token for token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edgerunner_tpu.generate as JG
import edgerunner_tpu_torch.generate as TG
from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.ops import decode_attention_pallas as JP
from edgerunner_tpu.ops import kv_quant as JQ
from edgerunner_tpu.ops import w_quant as JW
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.ops import decode_attention as DA
from edgerunner_tpu_torch.ops import kv_quant as TQ
from edgerunner_tpu_torch.ops import w_quant as TW
from edgerunner_tpu_torch.weights import load_state, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 sums in another order: the plain versions agree with the Pallas
# kernels to rounding
TOL = 1e-5


def _rows(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _bits(x) -> np.ndarray:
    """The raw bits of a bf16 array (JAX) or tensor (torch), as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("bf16", [False, True])
def test_quantize_rows_and_pack_scales_are_bit_equal_to_jax(bf16):
    x = _rows((3, 5, 256), 0)
    # a row with absmax 127 (scale exactly 1) whose values sit half-way
    # between integers: round half to even in both
    x[0, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[0, 0, 8:] = 0.0
    x[1, 1] = 0.0  # an all-zero row: the 1e-6 floor
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    xt = torch.tensor(x).to(torch.bfloat16 if bf16 else torch.float32)
    (jv, js), (tv, ts) = JQ.quantize_rows(xj), TQ.quantize_rows(xt)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tv.dtype == torch.int8
    if not bf16:
        np.testing.assert_array_equal(tv[0, 0, :8].numpy(), [127, 0, 2, 2, 0, -2, -2, 126])
    x2 = _rows((3, 5, 256), 1) * 0.3
    (_, js2), (_, ts2) = (JQ.quantize_rows(jnp.asarray(x2, xj.dtype)),
                          TQ.quantize_rows(torch.tensor(x2).to(xt.dtype)))
    jp, tp = JQ.pack_scales(js, js2), TQ.pack_scales(ts, ts2)
    assert tp.shape == (3, 5, TQ.SCALE_LANES) and tp.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tp), _bits(jp))
    for lane in (0, 1):
        np.testing.assert_array_equal(
            TQ.dequantize_rows(tv, tp, torch.float32, lane).numpy(),
            np.asarray(JQ.dequantize_rows(jv, jp, jnp.float32, lane)))


def _q8_cache(B, L, hd, seed):
    """The int8 cache of random rows, built by the JAX package (the
    bit-equality test above holds the port's builder to it)."""
    kv, plane = [], []
    (kq, ks), (vq, vs) = (JQ.quantize_rows(jnp.asarray(_rows((B, L, hd), seed + i)))
                          for i in range(2))
    kv = jnp.concatenate([kq, vq], -1)
    plane = JQ.pack_scales(ks, vs)
    return kv, plane


# (T, per-row indices): block edges 127/128 and the last legal start L - T
CASES = [(1, [0, 127, 255]), (3, [126, 128, 253]), (1, [128, 5, 200])]


@pytest.mark.parametrize("T,index", CASES)
def test_multi_plain_version_matches_pallas(T, index):
    B, L, H, D = 3, 256, 2, 64
    q, k, v = _rows((B, T, H * D), 1), _rows((B, L, H * D), 2), _rows((B, L, H * D), 3)
    ref = JP.fused_decode_attention_multi(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(index, jnp.int32), num_heads=H,
                                          block=128)
    out = DA.fused_decode_attention_multi(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                          torch.tensor(index, dtype=torch.int32), num_heads=H)
    assert out.shape == (B, T, H * D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("T,index", CASES)
def test_q8_multi_plain_version_matches_pallas(T, index):
    B, L, H, D = 3, 256, 2, 96
    q = _rows((B, T, H * D), 4)
    kv, plane = _q8_cache(B, L, H * D, 5)
    ref = JP.fused_decode_attention_q8_multi(jnp.asarray(q), kv, plane,
                                             jnp.asarray(index, jnp.int32), num_heads=H,
                                             block=128)
    out = DA.fused_decode_attention_q8_multi(
        torch.tensor(q), torch.tensor(np.asarray(kv)), torch.tensor(_bits(plane).view(np.int16))
        .view(torch.bfloat16), torch.tensor(index, dtype=torch.int32), num_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("index", [0, 127, 128, 255])
def test_q8_plain_version_matches_pallas(index):
    B, L, H, D = 2, 256, 2, 64
    q = _rows((B, H * D), 6)
    kv, plane = _q8_cache(B, L, H * D, 7)
    ref = JP.fused_decode_attention_q8(jnp.asarray(q), kv, plane, index, num_heads=H,
                                       block=128)
    out = DA.fused_decode_attention_q8(
        torch.tensor(q), torch.tensor(np.asarray(kv)),
        torch.tensor(_bits(plane).view(np.int16)).view(torch.bfloat16), index, num_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(2, 3, 128)
    k = torch.zeros(2, 16, 128)
    with pytest.raises(ValueError):
        DA.fused_decode_attention_multi(q, k, torch.zeros(2, 16, 64), torch.zeros(2),
                                        num_heads=2)
    with pytest.raises(ValueError):
        DA.fused_decode_attention_q8_multi(q, torch.zeros(2, 16, 128, dtype=torch.int8),
                                           torch.zeros(2, 16, 128, dtype=torch.bfloat16),
                                           torch.zeros(2), num_heads=2)
    with pytest.raises(ValueError):  # a device the kernels do not run on
        DA.fused_decode_attention_multi(q.to("meta"), k.to("meta"), k.to("meta"),
                                        torch.zeros(2, device="meta"), num_heads=2)


def test_quant_dense_and_quantize_lmm_params_match_jax():
    w = _rows((96, 80), 8) * 0.05                     # flax [in, out]
    b = _rows((80,), 9) * 0.1
    x = _rows((4, 7, 96), 10)
    jq, js = JW.quantize_kernel(jnp.asarray(w))
    tq, ts = TW.quantize_kernel(torch.tensor(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(TW.dequantize_kernel(tq, ts).numpy(),
                                  np.asarray(JW.dequantize_kernel(jq, js)))
    dense = JW.QuantDense(80)
    ref = dense.apply({"params": {"kernel_q": jq, "scale": js, "bias": jnp.asarray(b)}},
                      jnp.asarray(x))
    lin = torch.nn.Linear(96, 80)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T))
        lin.bias.copy_(torch.tensor(b))
    out = TW.QuantDense.from_linear(lin)(torch.tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)

    jm, params, tm = _pair()
    jparams = JW.quantize_lmm_params(params)
    TW.quantize_lmm_params(tm)
    layer = jparams["params"]["mesh_decoder"]["model"]["layers_1"]
    for name, mod in (("q_proj", tm.mesh_decoder.model.layers[1].self_attn.q_proj),
                      ("fc2", tm.mesh_decoder.model.layers[1].fc2)):
        tree = layer["self_attn"][name] if name.endswith("proj") else layer[name]
        assert isinstance(mod, TW.QuantDense)
        np.testing.assert_array_equal(mod.kernel_q.numpy(), np.asarray(tree["kernel_q"]))
        np.testing.assert_array_equal(mod.scale.numpy(), np.asarray(tree["scale"]))
    assert isinstance(tm.mesh_decoder.lm_head, torch.nn.Linear)
    assert "kernel" in jparams["params"]["mesh_decoder"]["lm_head"]
    n_quant = sum(isinstance(m, TW.QuantDense) for m in tm.modules())
    assert n_quant == 6 * tm.opt.num_layers


N_POINTS = 40
BASE = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
            point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
            hidden_dim=128, num_layers=2, num_heads=2, max_seq_length=512,
            use_num_face_cond=True, checkpointing=False, decode_bucket=64,
            generate_mode="greedy", point_num=N_POINTS)


def _pair(**over):
    """A JAX LMM and the port's, on the same random weights (widened so that
    the point clouds steer the streams)."""
    kw = dict(BASE, **over)
    jm = JLMM(Options(**kw))
    rng = jax.random.PRNGKey(2)
    tokens = jnp.array([[1, 6, 7, 8, 2]])
    labels = jnp.concatenate([jnp.full((1, 18), -100), tokens[:, 1:]], axis=1)
    params = jm.init({"params": rng, "nof": rng, "dropout": rng},
                     jnp.zeros((1, N_POINTS, 3)), tokens, labels, jnp.array([100]),
                     jnp.array([23], jnp.int32))
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0, params)
    tm = LMM(TOptions(**kw))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm


@pytest.mark.parametrize("w_quant", [False, True])
def test_greedy_streams_with_kv_quant_identical_to_jax(monkeypatch, w_quant):
    monkeypatch.setattr(JG, "DECODE_CHUNK", 64)
    monkeypatch.setattr(TG, "DECODE_CHUNK", 64)
    jm, params, tm = _pair(kv_quant=True)
    if w_quant:
        params = JW.quantize_lmm_params(params)
        jm = JLMM(Options(**dict(BASE, kv_quant=True, w_quant=True)))
        TW.quantize_lmm_params(tm)
    pts = _rows((3, N_POINTS, 3), 11)
    ref = JG.generate_tokens(jm, params, pts, num_faces=20)
    out = TG.generate_tokens(tm, pts, num_faces=20)
    assert out.shape == ref.shape and out.shape[1] > 64
    np.testing.assert_array_equal(out, ref)
    assert len({tuple(r) for r in out.tolist()}) > 1, "rows should differ"


def test_int8_prefill_cache_matches_jax():
    jm, params, tm = _pair(kv_quant=True)
    pts = _rows((2, N_POINTS, 3), 12)
    prompt = np.ones((2, 1), np.int64)
    _, _, jk, jv, _ = jm.apply(params, jnp.asarray(pts), jnp.asarray([20, 20]),
                               jnp.asarray(prompt, jnp.int32), 64, method=JLMM.prefill)
    with torch.no_grad():
        _, (tk, tv), _ = tm.prefill(torch.tensor(pts), torch.tensor([20, 20]),
                                    torch.tensor(prompt), 64)
    assert tk[0].dtype == torch.int8 and tv[0].shape == (2, 64, TQ.SCALE_LANES)
    for a, b in zip(tk, jk):
        # one rounding step at most where the f32 projections differ in the last bit
        assert np.abs(a.numpy().astype(int) - np.asarray(b).astype(int)).max() <= 1
        assert (a.numpy() == np.asarray(b)).mean() > 0.99
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=1e-2)

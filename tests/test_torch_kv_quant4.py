"""The port's int4 KV cache against the JAX package, in f32 on the CPU: the
packed nibbles and scale planes (per-row and grouped) and the rotation
matrices bit for bit, `rotate_rows`, the plain versions of the int4 decode
kernels (TPU rows 7 and 10) against the Pallas kernels in interpret mode
(block 128), the int4 prefill cache, and greedy streams over the int4 cache
(per-row, grouped, rotated) from `generate_tokens` and from the engine,
token for token. Tiny width: hidden 64, 2 heads, 2 layers."""

import dataclasses
import functools

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
from edgerunner_tpu.serve_engine import ContinuousEngine as JEngine
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.config import config_defaults, validate
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.ops import decode_attention as DA
from edgerunner_tpu_torch.ops import kv_quant as TQ
from edgerunner_tpu_torch.serve_engine import ContinuousEngine
from edgerunner_tpu_torch.weights import load_state, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 sums in another order: the plain versions agree with the Pallas
# kernels to rounding
TOL = 1e-5
# rotate_rows: the same D f32 products summed in another order, at unit-scale
# rows: within 1e-6 plus 1e-6 of the value (outputs reach ~4 at D = 96)
ROT_TOL = 1e-6


def _rows(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _bits(x) -> np.ndarray:
    """The raw bits of a bf16 array (JAX) or tensor (torch), as uint16."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _plane(x) -> torch.Tensor:
    """A JAX bf16 plane as a torch bf16 tensor, bit for bit."""
    return torch.tensor(_bits(x).view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("group", [0, 16, 32])
@pytest.mark.parametrize("bf16", [False, True])
def test_int4_rows_and_planes_are_bit_equal_to_jax(group, bf16):
    x = _rows((3, 5, 64), 0) * 2.0
    # a row with absmax 7 (scale exactly 1 per row and per group) whose
    # values sit half-way between integers: round half to even in both, and
    # negative nibbles in both halves of the packed bytes
    x[0, 0] = 0.0
    x[0, 0, :8] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -7.0]
    x[0, 0, 32:40] = [-7.0, -6.5, -3.5, 3.5, 6.5, -1.0, 5.0, 7.0]
    x[1, 1] = 0.0  # an all-zero row: the 1e-6 floor
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    xt = torch.tensor(x).to(torch.bfloat16 if bf16 else torch.float32)
    if group:
        (jv, js), (tv, ts) = (JQ.quantize_rows_int4_grouped(xj, group),
                              TQ.quantize_rows_int4_grouped(xt, group))
    else:
        (jv, js), (tv, ts) = JQ.quantize_rows_int4(xj), TQ.quantize_rows_int4(xt)
    assert tv.dtype == torch.int8 and tv.shape == (3, 5, 32)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tv.numpy() < 0).any()  # bytes whose high nibble is negative wrap
    vals = TQ.unpack_int4(tv)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(JQ.unpack_int4(jv)))
    if not bf16:
        np.testing.assert_array_equal(vals[0, 0, :8].numpy(), [7, 0, 2, 2, 0, -2, -2, -7])
        np.testing.assert_array_equal(vals[0, 0, 32:40].numpy(), [-7, -6, -4, 4, 6, -1, 5, 7])
    s2 = ts * 0.3
    if group:
        jp, tp = JQ.pack_scales_grouped(js, js * 0.3), TQ.pack_scales_grouped(ts, s2)
    else:
        jp, tp = JQ.pack_scales(js, js * 0.3), TQ.pack_scales(ts, s2)
    assert tp.shape == (3, 5, TQ.SCALE_LANES) and tp.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tp), _bits(jp))
    for lane in (0, 1):
        if group:
            ref = JQ.dequantize_rows_int4_grouped(jv, jp, group, jnp.float32, lane)
            out = TQ.dequantize_rows_int4_grouped(tv, tp, group, torch.float32, lane)
        else:
            ref = JQ.dequantize_rows_int4(jv, jp, jnp.float32, lane)
            out = TQ.dequantize_rows_int4(tv, tp, torch.float32, lane)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("heads,head_dim", [(2, 32), (16, 96), (3, 32)])
def test_rotations_are_bit_equal_to_jax_and_rotate_rows_agrees(heads, head_dim):
    np.testing.assert_array_equal(TQ._rotations_np(heads, head_dim),
                                  JQ._rotations_np(heads, head_dim))
    assert TQ.ROTATION_SEED == JQ.ROTATION_SEED
    x = _rows((2, 3, heads * head_dim), 1)
    for inverse in (False, True):
        ref = JQ.rotate_rows(jnp.asarray(x), heads, inverse=inverse)
        out = TQ.rotate_rows(torch.tensor(x), heads, inverse=inverse)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=ROT_TOL, atol=ROT_TOL)
    back = TQ.rotate_rows(TQ.rotate_rows(torch.tensor(x), heads), heads, inverse=True)
    np.testing.assert_allclose(back.numpy(), x, rtol=ROT_TOL, atol=ROT_TOL)


def _q4_cache(B, L, hd, seed, group):
    """The int4 cache of random rows, quantised by the JAX package (the
    bit-equality test above holds the port's quantisation to it)."""
    k, v = (jnp.asarray(_rows((B, L, hd), seed + i)) for i in range(2))
    if group:
        (kq, ks), (vq, vs) = (JQ.quantize_rows_int4_grouped(x, group) for x in (k, v))
        plane = JQ.pack_scales_grouped(ks, vs)
    else:
        (kq, ks), (vq, vs) = JQ.quantize_rows_int4(k), JQ.quantize_rows_int4(v)
        plane = JQ.pack_scales(ks, vs)
    return jnp.concatenate([kq, vq], -1), plane


# (T, per-row indices): block edges 127/128 and the last legal start L - T
CASES = [(1, [0, 127, 255]), (3, [126, 128, 253]), (1, [128, 5, 200])]


@pytest.mark.parametrize("group", [0, 16])
@pytest.mark.parametrize("T,index", CASES)
def test_q4_multi_plain_version_matches_pallas(T, index, group):
    B, L, H, D = 3, 256, 2, 32
    q = _rows((B, T, H * D), 4)
    kv, plane = _q4_cache(B, L, H * D, 5, group)
    ref = JP.fused_decode_attention_q4_multi(jnp.asarray(q), kv, plane,
                                             jnp.asarray(index, jnp.int32), num_heads=H,
                                             block=128, group=group)
    out = DA.fused_decode_attention_q4_multi(
        torch.tensor(q), torch.tensor(np.asarray(kv)), _plane(plane),
        torch.tensor(index, dtype=torch.int32), num_heads=H, group=group)
    assert out.shape == (B, T, H * D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("group", [0, 32])
@pytest.mark.parametrize("index", [0, 127, 128, 255])
def test_q4_plain_version_matches_pallas(index, group):
    B, L, H, D = 2, 256, 2, 32
    q = _rows((B, H * D), 6)
    kv, plane = _q4_cache(B, L, H * D, 7, group)
    ref = JP.fused_decode_attention_q4(jnp.asarray(q), kv, plane, index, num_heads=H,
                                       block=128, group=group)
    out = DA.fused_decode_attention_q4(torch.tensor(q), torch.tensor(np.asarray(kv)),
                                       _plane(plane), index, num_heads=H, group=group)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("heads,head_dim,pairs", [(16, 96, True), (2, 64, True), (3, 96, False),
                                                  (3, 32, False), (4, 32, False), (1, 64, False)])
def test_int4_items_pair_heads_that_share_their_bytes(heads, head_dim, pairs):
    """The int4 kernel takes heads h and h + H/2 as one item when H is even
    (their lanes are the low and high nibbles of the same bytes); an odd H,
    or head dim 32, runs one head per item. Its scratch slot holds, per head
    of an item and query of a pass, head_dim sums, a max and a sum."""
    assert DA.int4_pairs(heads, head_dim) is pairs
    if pairs:  # head h's lanes and head h + H/2's share byte j of the packed row
        hd = heads * head_dim
        for h in range(heads // 2):
            low = np.arange(h * head_dim, (h + 1) * head_dim)
            assert ((low + hd // 2) // head_dim == h + heads // 2).all()
    for T in range(1, 9):
        per_pass = DA.query_passes(T)[1]
        for bits, streams in ((4, (2 if pairs else 1) * per_pass), (8, per_pass)):
            n = DA.quant_slot_floats(bits, heads, head_dim, T)
            assert n % 4 == 0 and streams * (head_dim + 2) <= n < streams * (head_dim + 2) + 4


@pytest.mark.parametrize("T,passes,per_pass", [(1, 1, 1), (2, 1, 2), (3, 1, 3), (4, 2, 2),
                                               (5, 2, 3), (6, 2, 3), (7, 3, 3), (8, 3, 3)])
def test_query_passes_cover_every_query_at_most_three_at_a_time(T, passes, per_pass):
    assert DA.query_passes(T) == (passes, per_pass)
    assert per_pass <= DA.QUERIES_PER_PASS and passes * per_pass >= T
    assert (passes - 1) * per_pass < T  # no pass without a real query


@pytest.mark.parametrize("group", [0, 96])
def test_q4_plain_version_takes_per_row_positions_at_eight_queries(group):
    """T = 8 (three passes of the kernel) at per-row positions, a pair of
    heads per item, against the Pallas kernel in interpret mode."""
    B, L, H, D, T = 3, 256, 2, 96, 8
    index = [0, 127, L - T]
    q = np.random.default_rng(21).normal(size=(B, T, H * D)).astype(np.float32)
    kv, plane = _q4_cache(B, L, H * D, 22, group)
    ref = JP.fused_decode_attention_q4_multi(jnp.asarray(q), kv, plane,
                                             jnp.asarray(index, jnp.int32), num_heads=H,
                                             group=group, block=128)
    out = DA.fused_decode_attention_q4_multi(torch.tensor(q), torch.tensor(np.asarray(kv)),
                                             _plane(plane), torch.tensor(index, dtype=torch.int32),
                                             num_heads=H, group=group)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_q4_wrappers_refuse_what_the_kernel_does_not_take():
    q, kv = torch.zeros(2, 3, 96), torch.zeros(2, 16, 96, dtype=torch.int8)
    plane = torch.zeros(2, 16, 128, dtype=torch.bfloat16)
    DA.fused_decode_attention_q4_multi(q, kv, plane, torch.zeros(2, dtype=torch.int32),
                                       num_heads=3)  # 3 heads of 32: taken
    with pytest.raises(ValueError):  # hidden not a multiple of 16
        DA.fused_decode_attention_q4_multi(torch.zeros(2, 1, 72), torch.zeros(
            2, 16, 72, dtype=torch.int8), plane, 0, num_heads=3)
    with pytest.raises(ValueError):  # a head dim that is not a multiple of 8
        DA.fused_decode_attention_q4_multi(q, kv, plane, 0, num_heads=24)
    with pytest.raises(ValueError):  # more than 64 group scales
        DA.fused_decode_attention_q4(q[:, 0], kv, plane, 0, num_heads=3, group=1)
    with pytest.raises(ValueError):  # a group that does not divide hidden
        DA.fused_decode_attention_q4(q[:, 0], kv, plane, 0, num_heads=3, group=36)
    with pytest.raises(ValueError):  # values of the int8 cache's width
        DA.fused_decode_attention_q4_multi(q, torch.zeros(2, 16, 192, dtype=torch.int8),
                                           plane, 0, num_heads=3)
    with pytest.raises(ValueError):  # a device the kernel does not run on
        DA.fused_decode_attention_q4_multi(q.to("meta"), kv.to("meta"), plane.to("meta"),
                                           torch.zeros(2, device="meta"), num_heads=3)


def test_validate_takes_the_int4_options_and_refuses_groups_jax_asserts_against():
    base = config_defaults["ArAE"]  # hidden 1536
    for ok in (dict(kv_quant=True, kv_bits=4), dict(kv_quant=True, kv_bits=4, kv_group=96),
               dict(kv_quant=True, kv_bits=4, kv_group=24),  # G = 64, the plane's limit
               dict(kv_quant=True, kv_bits=4, kv_rotate=True, w_quant=True)):
        validate(dataclasses.replace(base, **ok))
    for bad in (dict(kv_group=12), dict(kv_group=100), dict(kv_bits=3)):
        with pytest.raises(ValueError):
            validate(dataclasses.replace(base, **{"kv_quant": True, "kv_bits": 4, **bad}))


N_POINTS = 40
BASE = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
            point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
            hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=512,
            use_num_face_cond=True, checkpointing=False, decode_bucket=64,
            generate_mode="greedy", point_num=N_POINTS, test_batch_size=2,
            test_num_face=(64,), kv_quant=True, kv_bits=4)
VARIANTS = {"per-row": {}, "grouped": {"kv_group": 16}, "rotated": {"kv_rotate": True}}


@functools.lru_cache(maxsize=None)
def _pair(variant: str = "per-row"):
    """A JAX LMM with its params and the port's LMM on the same weights
    (widened so that the point clouds steer the streams), built once per
    variant; the tests only read them."""
    kw = dict(BASE, **VARIANTS[variant])
    jm = JLMM(Options(**kw))
    rng = jax.random.PRNGKey(2)
    tokens = jnp.array([[1, 6, 7, 8, 2]])
    labels = jnp.concatenate([jnp.full((1, 18), -100), tokens[:, 1:]], axis=1)
    params = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                              jnp.zeros((1, N_POINTS, 3)), tokens, labels, jnp.array([100]),
                              jnp.array([23], jnp.int32))
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0, params)
    tm = LMM(TOptions(**kw))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_int4_prefill_cache_is_bit_equal_to_jax(variant):
    jm, params, tm = _pair(variant)
    pts = _rows((2, N_POINTS, 3), 12)
    prompt = np.ones((2, 1), np.int64)
    prefill = jax.jit(lambda p, c, n, ids: jm.apply(p, c, n, ids, 64, method=JLMM.prefill))
    _, _, jk, jv, _ = prefill(params, jnp.asarray(pts), jnp.asarray([20, 20]),
                              jnp.asarray(prompt, jnp.int32))
    with torch.no_grad():
        _, (tk, tv), _ = tm.prefill(torch.tensor(pts), torch.tensor([20, 20]),
                                    torch.tensor(prompt), 64)
    assert tk[0].dtype == torch.int8 and tk[0].shape == (2, 64, 64)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_streams_over_the_int4_cache_identical_to_jax(variant):
    jm, params, tm = _pair(variant)
    pts = _rows((3, N_POINTS, 3), 11)
    ref = JG.generate_tokens(jm, params, pts, num_faces=20)
    out = TG.generate_tokens(tm, pts, num_faces=20)
    assert out.shape == ref.shape and out.shape[1] > 64
    np.testing.assert_array_equal(out, ref)
    assert len({tuple(r) for r in out.tolist()}) > 1, "rows should differ"


def test_engine_streams_over_the_int4_cache_equal_the_jax_engine(monkeypatch):
    monkeypatch.setattr(TG, "DECODE_CHUNK", 4)
    jm, params, tm = _pair()
    faces = (20, 30, 20)
    # EOS forbidden: every request decodes its whole budget (192 and 256 tokens)
    jeng = JEngine(jm, params, Options(**BASE), batch=2, segment_steps=64, bench_no_eos=True)
    teng = ContinuousEngine(tm, tm.opt, batch=2, segment_steps=64, bench_no_eos=True)
    try:
        ref = [jeng.submit(_rows((N_POINTS, 3), i), nf, None) for i, nf in enumerate(faces)]
        out = [teng.submit(_rows((N_POINTS, 3), i), nf, None) for i, nf in enumerate(faces)]
    finally:
        jeng.shutdown()
        teng.shutdown()
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o["tokens"], np.asarray(r["tokens"]))
    assert max(len(o["tokens"]) for o in out) > 64

"""Greedy generation of the port against edgerunner_tpu.generate, in f32 on
the CPU: for the same exported weights and points the token streams must be
IDENTICAL, across decode-segment boundaries (both packages' DECODE_CHUNK is
shrunk so that the budget spans several segments)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import edgerunner_tpu.generate as JG
import edgerunner_tpu_torch.generate as TG
from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.weights import load_state, state_dict_from_flax

B, N_POINTS = 3, 40
BASE = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
            point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
            hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=512,
            use_num_face_cond=True, checkpointing=False, decode_bucket=64,
            generate_mode="greedy", point_num=N_POINTS)


@pytest.fixture(autouse=True)
def _short_segments(monkeypatch):
    monkeypatch.setattr(JG, "DECODE_CHUNK", 64)
    monkeypatch.setattr(TG, "DECODE_CHUNK", 64)


def _pair(**over):
    kw = dict(BASE, **over)
    jm = JLMM(Options(**kw))
    rng = jax.random.PRNGKey(1)
    conds = jnp.zeros((1, N_POINTS, 3), jnp.float32)
    tokens = jnp.array([[1, 6, 7, 8, 2]])
    labels = jnp.concatenate([jnp.full((1, 18), -100), tokens[:, 1:]], axis=1)
    params = jm.init({"params": rng, "nof": rng, "dropout": rng}, conds, tokens,
                     labels, jnp.array([100]), jnp.array([23], jnp.int32))
    # widen the random weights so that the point clouds steer the streams
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0, params)
    tm = LMM(TOptions(**kw))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm


@pytest.fixture(scope="module")
def lr_pair():
    return _pair()


def _points(seed=0):
    return np.random.default_rng(seed).normal(size=(B, N_POINTS, 3)).astype(np.float32)


@pytest.mark.parametrize("num_faces", [20, 30])
def test_greedy_streams_identical_across_segments(lr_pair, num_faces):
    jm, params, tm = lr_pair
    pts = _points(num_faces)
    ref = JG.generate_tokens(jm, params, pts, num_faces=num_faces)
    out = TG.generate_tokens(tm, pts, num_faces=num_faces)
    assert out.shape == ref.shape and out.shape[1] > 64
    np.testing.assert_array_equal(out, ref)
    assert len({tuple(r) for r in out.tolist()}) > 1, "rows should differ"


def test_bench_no_eos_and_resume_ids_identical(lr_pair):
    jm, params, tm = lr_pair
    pts = _points(7)
    resume = np.array([[5, 100, 101, 102, 103, 104, 105, 106, 107, 108, 3, 20]] * B)
    for kw in (dict(bench_no_eos=True), dict(resume_ids=resume)):
        ref = JG.generate_tokens(jm, params, pts, num_faces=12, **kw)
        out = TG.generate_tokens(tm, pts, num_faces=12, **kw)
        np.testing.assert_array_equal(out, ref)
        if "bench_no_eos" in kw:
            assert not (out == 2).any() and not (out == 0).any()


def test_clers_greedy_streams_identical():
    jm, params, tm = _pair(meto_backend="CLERS")
    pts = _points(3)
    np.testing.assert_array_equal(TG.generate_tokens(tm, pts, num_faces=15),
                                  JG.generate_tokens(jm, params, pts, num_faces=15))


def test_decode_shape_matches_jax_sizing():
    opt = TOptions(**dict(BASE, decode_bucket=1024, max_seq_length=40960,
                          num_cond_tokens=2049))
    # the ArAE bench shape: 1000 faces, the bench's 4096-token budget
    assert TG.decode_shape(opt, 1, 1000, 4096) == (4096, 6656)
    assert TG.decode_shape(opt, 1, 1000, None) == (5120, 7680)
    assert TG.round_up_bucket(1, 64) == 64 and TG.round_up_bucket(65, 64) == 128


def test_trim_eos():
    np.testing.assert_array_equal(TG.trim_eos(np.array([5, 6, 2, 7, 2])), [5, 6])
    np.testing.assert_array_equal(TG.trim_eos(np.array([5, 6])), [5, 6])


def test_sampled_streams_are_grammar_valid_and_seeded(lr_pair):
    import torch

    _, _, tm = lr_pair
    tm.opt = dataclasses.replace(tm.opt, generate_mode="sample")
    try:
        pts = _points(1)
        a = TG.generate_tokens(tm, pts, num_faces=10, generator=torch.Generator().manual_seed(5))
        b = TG.generate_tokens(tm, pts, num_faces=10, generator=torch.Generator().manual_seed(5))
    finally:
        tm.opt = dataclasses.replace(tm.opt, generate_mode="greedy")
    np.testing.assert_array_equal(a, b)
    for row in a:
        counter, first = 0, True
        for t in TG.trim_eos(row):
            if first:
                assert t == 5
                first = False
            elif counter > 0:
                assert t >= 6
            else:
                assert t in (3, 4, 5)
            counter = 9 if t == 5 else 3 if t in (3, 4) else counter - 1 if t >= 6 else counter

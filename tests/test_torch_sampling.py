"""The port's grammar FSMs and samplers against the JAX package's.

Both FSMs step through the same random token streams in both packages; the
states and the allowed-token masks must be equal at every step (integer and
boolean state: exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.ops import sampling as JS
from edgerunner_tpu_torch.ops import sampling as S
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _lr_stream(rng, B, T, vocab):
    """Random streams over every token class, biased towards grammar-valid
    ones so that the FSM visits all its states."""
    return rng.choice([S.BOM_ID, S.L_ID, S.R_ID, S.EOS_ID, 7, 8, 100, vocab - 1],
                      size=(B, T), p=[.08, .1, .1, .02, .2, .2, .2, .1])


def _clers_stream(rng, B, T, vocab):
    return rng.choice([S.CBOM_ID, S.C_ID, S.CL_L_ID, S.CE_ID, S.CR_ID, S.CS_ID,
                       S.CEOM_ID, S.EOS_ID, 10, 11, vocab - 1],
                      size=(B, T), p=[.06, .08, .08, .1, .08, .08, .06, .02, .2, .14, .1])


@pytest.mark.parametrize("backend,stream,vocab", [
    ("LR_ABSCO", _lr_stream, 518), ("LR", _lr_stream, 1030),
    ("CLERS", _clers_stream, 2058)])
@pytest.mark.parametrize("seed", [0, 1])
def test_fsm_matches_jax_on_random_streams(backend, stream, vocab, seed):
    rng = np.random.default_rng(seed)
    B, T = 6, 120
    toks = stream(rng, B, T, vocab)
    jg, tg = JS.get_grammar(backend), S.get_grammar(backend)
    js, ts = jg.init(B), tg.init(B)
    for t in range(T):
        np.testing.assert_array_equal(np.asarray(jg.mask(js, vocab)),
                                      tg.mask(ts, vocab).numpy())
        js = jg.advance(js, jnp.asarray(toks[:, t], jnp.int32))
        ts = tg.advance(ts, torch.tensor(toks[:, t]))
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    replayed = S.grammar_replay(tg, toks)
    for a, b in zip(js, replayed):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("step", [0, 1, 8, 9, 17])
def test_naive_mask_matches_jax(step):
    np.testing.assert_array_equal(np.asarray(JS.naive_grammar_mask(jnp.asarray(step), 2, 40)),
                                  S.naive_grammar_mask(step, 2, 40).numpy())


def test_apply_mask_and_greedy_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 50)).astype(np.float32)
    mask = rng.random((4, 50)) < 0.3
    j = JS.apply_mask(jnp.asarray(logits), jnp.asarray(mask))
    t = S.apply_mask(torch.tensor(logits), torch.tensor(mask))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(np.asarray(JS.greedy_token(j)), S.greedy_token(t).numpy())


def test_sample_token_stays_in_top_k_and_is_seeded():
    logits = torch.tensor(np.random.default_rng(4).normal(size=(8, 100)).astype(np.float32))
    top = torch.topk(logits, 5, dim=-1).indices
    draws = [S.sample_token(logits, torch.Generator().manual_seed(s), top_k=5,
                            temperature=0.7) for s in range(20)]
    for d in draws:
        assert bool((top == d[:, None]).any(-1).all())
    again = S.sample_token(logits, torch.Generator().manual_seed(3), top_k=5, temperature=0.7)
    assert torch.equal(again, draws[3])
    assert len({tuple(d.tolist()) for d in draws}) > 1


def test_tiny_top_p_keeps_only_the_argmax():
    logits = torch.tensor(np.random.default_rng(5).normal(size=(8, 100)).astype(np.float32))
    out = S.sample_token(logits, torch.Generator().manual_seed(0), top_k=10, top_p=1e-6)
    assert torch.equal(out, logits.argmax(-1))

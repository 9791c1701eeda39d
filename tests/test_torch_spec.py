"""The port's multi-token-prediction heads and speculative decoding against
the JAX package, in f32 on the CPU at a tiny width (hidden 64, 2 heads, 2
layers): the draft heads' logits, the auxiliary loss and every gradient;
the heads' weights through weights.py both ways; `loss_mtp` in the training
step's metrics and log line; speculative streams from `generate_tokens` and
from the engine, over the exact and the int4 cache, equal to vanilla greedy
streams and to the JAX package's speculative streams; and the warning and
vanilla decoding where spec_decode cannot run. The draft heads carry random
non-zero weights from a numpy seed (zero heads would draft the base head's
token), so that some proposals are accepted and some rejected."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edgerunner_tpu.generate as JG
import edgerunner_tpu_torch.generate as TG
from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.serve_engine import ContinuousEngine as JEngine
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.serve_engine import ContinuousEngine
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.weights import (
    flax_from_state_dict,
    load_state,
    read_safetensors,
    reference_state_dict,
    state_dict_from_flax,
    write_safetensors,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# f32 sums in another order (as tests/test_torch_train.py)
TOL = dict(atol=1e-5, rtol=1e-4)
N_POINTS = 40
HEADS = 2
BASE = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
            point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
            hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=512,
            use_num_face_cond=True, checkpointing=False, decode_bucket=64,
            generate_mode="greedy", point_num=N_POINTS, test_batch_size=2,
            test_num_face=(64,), mtp_heads=HEADS, spec_decode=True)
CACHES = {"exact": {}, "int4": {"kv_quant": True, "kv_bits": 4}}


def _rows(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _batch(seed=0, L=24):
    """Two training rows, the second cut short (as tests/test_torch_train.py)."""
    r = np.random.default_rng(seed)
    C = BASE["num_cond_tokens"]
    lens = [L, L - 7]
    tokens = np.zeros((2, L + 2), np.int32)
    labels = np.full((2, C + L + 2), -100, np.int32)
    for i, n in enumerate(lens):
        coords = r.integers(6, 300, n)
        tokens[i, :n + 2] = np.concatenate([[1], coords, [2]])
        labels[i, C + 1:C + n + 2] = np.concatenate([coords, [2]])
    return {"conds": r.normal(size=(2, N_POINTS, 3)).astype(np.float32),
            "tokens": tokens, "labels": labels, "num_faces": np.array([100, 3000], np.int32),
            "lengths": np.array([C + n + 2 for n in lens], np.int32)}


_KEYS = ("conds", "tokens", "labels", "num_faces", "lengths")


@functools.lru_cache(maxsize=None)
def _pair(cache: str = "exact"):
    """The JAX LMM with its params and the port's LMM on the same weights:
    widened so that the point clouds steer the streams, with draft heads
    from a numpy seed. Built once per cache kind; the tests only read them."""
    kw = dict(BASE, **CACHES[cache])
    jm = JLMM(Options(**kw))
    rng = jax.random.PRNGKey(2)
    b = _batch()
    params = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                              *(jnp.asarray(b[k]) for k in _KEYS))
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0, params)
    r = np.random.default_rng(7)
    decoder = params["params"]["mesh_decoder"]
    for k in range(HEADS):
        head = decoder[f"mtp_{k}"]
        head["kernel"] = (r.normal(size=head["kernel"].shape) * 0.3).astype(np.float32)
        head["bias"] = (r.normal(size=head["bias"].shape) * 0.1).astype(np.float32)
    tm = LMM(TOptions(**kw))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm.eval()


def test_mtp_logits_loss_and_gradients_match_jax():
    jm, params, tm = _pair()
    b = _batch(1)

    def loss_fn(p):
        out = jm.apply(p, *(jnp.asarray(b[k]) for k in _KEYS), train=False)
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    out = tm(*(torch.as_tensor(b[k]) for k in _KEYS), train=False)
    for k in ("loss", "loss_ce", "loss_kl", "loss_mtp"):
        np.testing.assert_allclose(out[k].item(), float(jout[k]), **TOL, err_msg=k)
    assert out["loss_mtp"].item() > 0
    named = dict(tm.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(out["loss"], list(named.values()))))
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    assert {f"mesh_decoder.mtp_{k}.weight" for k in range(HEADS)} <= set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n], **TOL, err_msg=n)
    assert np.abs(want["mesh_decoder.mtp_1.weight"]).max() > 0

    h = _rows((2, 3, BASE["hidden_dim"]), 2)
    ref = jm.apply(params, jnp.asarray(h), method=JLMM.mtp_logits)
    with torch.no_grad():
        got = tm.mtp_logits(torch.tensor(h))
    assert len(got) == HEADS
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


def test_mtp_heads_round_trip_through_weights(tmp_path):
    _, params, tm = _pair()
    sd = reference_state_dict(tm)
    tree = flax_from_state_dict(sd)["params"]["mesh_decoder"]
    for k in range(HEADS):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(tree[f"mtp_{k}"][leaf],
                                          params["params"]["mesh_decoder"][f"mtp_{k}"][leaf])
    path = str(tmp_path / "model.safetensors")
    write_safetensors(path, sd)
    fresh = LMM(tm.opt)
    load_state(fresh, read_safetensors(path))
    for n, t in fresh.state_dict().items():
        torch.testing.assert_close(t, tm.state_dict()[n], rtol=0, atol=0)
    # strict both ways: no heads in the weights, or heads the model lacks
    with pytest.raises(RuntimeError):
        load_state(fresh, {k: v for k, v in sd.items() if ".mtp_" not in k})
    with pytest.raises(RuntimeError):
        load_state(LMM(dataclasses.replace(tm.opt, mtp_heads=0)), sd)


def test_training_step_reports_loss_mtp():
    _, _, tm = _pair()
    model = LMM(tm.opt)
    model.load_state_dict(tm.state_dict())
    lines = []
    trainer = Trainer(model.train(), dataclasses.replace(tm.opt, mixed_precision="no"),
                      total_steps=4, logger=types.SimpleNamespace(info=lines.append))
    trainer.train_epoch([_batch(2), _batch(3)], 0)
    metrics = trainer.train_step(_batch(4))
    assert np.isfinite(metrics["loss_mtp"]) and metrics["loss_mtp"] > 0
    assert any(" loss_mtp: " in ln for ln in lines), lines


def _accepts(monkeypatch):
    """Record the accepted counts of every speculative pass."""
    seen, spec_pass = [], TG.spec_pass

    def recording(*args, **kw):
        P, a, eos = spec_pass(*args, **kw)
        seen.append(a.clone())
        return P, a, eos

    monkeypatch.setattr(TG, "spec_pass", recording)
    return seen


@pytest.mark.parametrize("cache", list(CACHES))
def test_spec_streams_equal_vanilla_greedy_and_jax(monkeypatch, cache):
    jm, params, tm = _pair(cache)
    pts = _rows((3, N_POINTS, 3), 11)
    seen = _accepts(monkeypatch)
    ref = JG.generate_tokens(jm, params, pts, num_faces=20, bench_no_eos=True)
    out = TG.generate_tokens(tm, pts, num_faces=20, bench_no_eos=True)
    tm.opt = dataclasses.replace(tm.opt, spec_decode=False)
    try:
        vanilla = TG.generate_tokens(tm, pts, num_faces=20, bench_no_eos=True)
    finally:
        tm.opt = dataclasses.replace(tm.opt, spec_decode=True)
    assert out.shape == ref.shape == vanilla.shape and out.shape[1] > 64
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, vanilla)
    assert len({tuple(r) for r in out.tolist()}) > 1, "rows should differ"
    accepted = torch.stack(seen)
    live = accepted > 0
    # drafts both accepted and rejected
    assert (accepted[live] > 1).any() and (accepted[live] < 1 + HEADS).any()


@pytest.mark.parametrize("cache", list(CACHES))
def test_engine_spec_streams_equal_the_jax_engine_and_vanilla(monkeypatch, cache):
    monkeypatch.setattr(TG, "DECODE_CHUNK", 4)
    seen = _accepts(monkeypatch)
    jm, params, tm = _pair(cache)
    kw = dict(BASE, **CACHES[cache])
    faces = (20, 30, 20)
    pts = [_rows((N_POINTS, 3), 20 + i) for i in range(len(faces))]
    # EOS forbidden: every request decodes its whole budget (192 and 256 tokens)
    jeng = JEngine(jm, params, Options(**kw), batch=2, segment_steps=64, bench_no_eos=True)
    teng = ContinuousEngine(tm, tm.opt, batch=2, segment_steps=64, bench_no_eos=True)
    try:
        ref = [jeng.submit(p, nf, None) for p, nf in zip(pts, faces)]
        out = [teng.submit(p, nf, None) for p, nf in zip(pts, faces)]
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert teng.T == 1 + HEADS
    for p, nf, r, o in zip(pts, faces, ref, out):
        np.testing.assert_array_equal(o["tokens"], np.asarray(r["tokens"]))
        tm.opt = dataclasses.replace(tm.opt, spec_decode=False)
        try:
            solo = TG.generate_tokens(tm, p[None], num_faces=nf, bench_no_eos=True)[0]
        finally:
            tm.opt = dataclasses.replace(tm.opt, spec_decode=True)
        np.testing.assert_array_equal(o["tokens"], solo)
    assert min(len(o["tokens"]) for o in out) > 64
    assert (torch.stack(seen) > 1).any()  # some passes accepted a draft


def test_spec_without_draft_heads_or_outside_greedy_warns_and_decodes_vanilla(capsys):
    _, _, tm = _pair()
    pts = _rows((2, N_POINTS, 3), 13)
    tm.opt = dataclasses.replace(tm.opt, spec_decode=False)
    try:
        vanilla = TG.generate_tokens(tm, pts, num_faces=20)
        capsys.readouterr()
        for change in (dict(mtp_heads=0), dict(generate_mode="sample")):
            tm.opt = dataclasses.replace(tm.opt, spec_decode=True, **change)
            out = TG.generate_tokens(tm, pts, num_faces=20)
            assert "[WARN] spec_decode needs mtp_heads > 0" in capsys.readouterr().out
            if "mtp_heads" in change:
                np.testing.assert_array_equal(out, vanilla)
            engine = ContinuousEngine(tm, tm.opt, batch=2)
            engine.shutdown()
            assert engine.T == 1 and "[WARN] serve engine" in capsys.readouterr().out
    finally:
        tm.opt = dataclasses.replace(tm.opt, spec_decode=True, mtp_heads=HEADS,
                                     generate_mode="greedy")

"""The port's Mixture-of-Experts decoder against the JAX package, in f32 on
the CPU at the JAX MoE tests' size (2 layers, hidden 64, 4 heads, 4
experts; tests/test_moe.py:33-37).

- `MoEMLP` against the JAX `MoEMLP`: outputs, the aux loss and the
  gradients of x and of every parameter, at top-1 and top-2, with ample
  capacity and with drops (capacity factor 0.5), in both formulations of
  the dispatch (the one-hot einsums and the index gathers); identical
  experts equal the dense MLP; tied probabilities route to the lower
  expert index, as jax.lax.top_k does; the index dispatch equals the
  one-hot one over a share of the experts (ep's).
- The MoE LMM's training loss (with moe_aux_weight), loss_moe and every
  gradient against the JAX train step's objective (dropout off: the two
  packages draw other bits), with and without gradient checkpointing; the
  eval loss has no aux; the weights both ways through weights.py; the
  trainer's log line carries loss_moe.
- Greedy streams of `generate_tokens` identical to `edgerunner_tpu.generate`
  (every row of a step routed together, so rows can drop each other's
  tokens): the exact cache, the int8 cache, and speculative decoding with
  2 draft heads; one engine segment over 3 slots (one free) equal to the
  JAX engine's; --w_quant quantises only the attention projections.

Tolerance: atol 1e-5, rtol 1e-4 in f32 (the two frameworks sum the same
products in another order), as tests/test_torch_train.py.
"""

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
from edgerunner_tpu.models.moe import MoEMLP as JMoE
from edgerunner_tpu.ops.w_quant import quantize_lmm_params as jquantize
from edgerunner_tpu.serve_engine import ContinuousEngine as JEngine
from edgerunner_tpu.serve_engine import Request as JRequest
from edgerunner_tpu.train.state import make_eval_step
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models import moe as M
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.ops.w_quant import QuantDense, quantize_lmm_params
from edgerunner_tpu_torch.serve_engine import ContinuousEngine, Request
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

TOL = dict(atol=1e-5, rtol=1e-4)
N_POINTS = 64
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=32, point_num_heads=4, point_latent_dim=8,
          hidden_dim=64, num_layers=2, num_heads=4, max_seq_length=256,
          use_num_face_cond=True, checkpointing=False, point_num=N_POINTS,
          nof_dropout_ratio=0.0, moe_experts=4, moe_top_k=2, decode_bucket=64,
          generate_mode="greedy", test_num_face=(64,))
FIELDS = ("conds", "tokens", "labels", "num_faces", "lengths")
EXPERTS = ("w1", "b1", "w2", "b2")


# ------------------------------------------------------------ the module --

def _module_pair(K, cf, E=4, C=16, F=32, seed=1, same_experts=False, zero_router=False):
    """(JAX MoEMLP, its params as numpy, the port's MoEMLP on them)."""
    jm = JMoE(hidden_dim=C, intermediate_dim=F, num_experts=E, top_k=K, capacity_factor=cf)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, C)))["params"])
    if same_experts:
        p = {**p, **{k: np.broadcast_to(p[k][:1], p[k].shape).copy() for k in EXPERTS}}
    if zero_router:
        p = {**p, "router": {k: np.zeros_like(v) for k, v in p["router"].items()}}
    tm = M.MoEMLP(C, F, E, K, cf)
    with torch.no_grad():
        tm.router.weight.copy_(torch.tensor(p["router"]["kernel"].T))
        tm.router.bias.copy_(torch.tensor(p["router"]["bias"]))
        for k in EXPERTS:
            getattr(tm, k).copy_(torch.tensor(p[k]))
    return jm, p, tm


def _jax_module(jm, p, x, w):
    def f(params, x):
        y, mut = jm.apply({"params": params}, x, mutable=["losses"])
        aux = jax.tree.leaves(mut)[0]
        return jnp.sum(y * w) + 3.0 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(p, x)
    return np.asarray(y), float(aux), np.asarray(gx), jax.tree.map(np.asarray, gp)


@functools.lru_cache(maxsize=None)
def _module_case(K, cf):
    """The inputs and the JAX module's results of one (K, cf) case."""
    jm, p, _ = _module_pair(K, cf)
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 12, 16)).astype(np.float32)
    w = r.normal(size=(2, 12, 16)).astype(np.float32)
    return (x, w) + _jax_module(jm, p, x, w)


@pytest.mark.parametrize("dispatch", ["onehot", "index"])
@pytest.mark.parametrize("K,cf", [(1, 1.25), (2, 1.25), (1, 0.5), (2, 0.5)])
def test_moe_mlp_matches_jax(K, cf, dispatch):
    _, _, tm = _module_pair(K, cf)
    x, w, y, aux, gx, gp = _module_case(K, cf)
    tm.dispatch = dispatch
    xt = torch.tensor(x, requires_grad=True)
    yt, at = tm(xt)
    ((yt * torch.tensor(w)).sum() + 3.0 * at).backward()
    np.testing.assert_allclose(yt.detach().numpy(), y, **TOL)
    np.testing.assert_allclose(at.item(), aux, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), gx, **TOL)
    for k in EXPERTS:
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(), gp[k], **TOL, err_msg=k)
    np.testing.assert_allclose(tm.router.weight.grad.numpy().T, gp["router"]["kernel"], **TOL)
    np.testing.assert_allclose(tm.router.bias.grad.numpy(), gp["router"]["bias"], **TOL)
    with torch.no_grad():
        logits = tm.router(torch.tensor(x).reshape(-1, 16))
    keep = M.route(logits, K, cf)["keep"]
    # capacity factor 0.5 drops a quarter of the assignments or more
    assert keep.float().mean() < (0.75 if cf < 1 else 1.01), keep.float().mean()


def test_identical_experts_equal_dense_mlp():
    """Every expert the same and ample capacity: the gates sum to one, so
    the mixture is the dense MLP (tests/test_moe.py:56-70)."""
    _, p, tm = _module_pair(2, 8.0, same_experts=True)
    x = torch.tensor(np.random.default_rng(2).normal(size=(2, 6, 16)).astype(np.float32))
    dense = torch.relu(x @ torch.tensor(p["w1"][0]) + torch.tensor(p["b1"][0])) \
        @ torch.tensor(p["w2"][0]) + torch.tensor(p["b2"][0])
    for dispatch in ("onehot", "index"):
        tm.dispatch = dispatch
        with torch.no_grad():
            torch.testing.assert_close(tm(x)[0], dense, rtol=2e-5, atol=2e-6)


def test_tied_probabilities_route_to_the_lower_expert():
    """A zero router gives every expert the same probability: the top-k
    are experts 0 .. K-1 in order, as jax.lax.top_k gives them."""
    jm, p, tm = _module_pair(2, 1.25, zero_router=True)
    x = np.random.default_rng(3).normal(size=(1, 8, 16)).astype(np.float32)
    probs = torch.full((8, 4), 0.25)
    _, idx = M.top_k(probs, 2)
    _, jidx = jax.lax.top_k(jnp.full((8, 4), 0.25), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx == torch.tensor([0, 1])).all()
    y, *_ = _jax_module(jm, p, x, np.ones_like(x))
    for dispatch in ("onehot", "index"):
        tm.dispatch = dispatch
        with torch.no_grad():
            np.testing.assert_allclose(tm(torch.tensor(x))[0].numpy(), y, **TOL)


@pytest.mark.parametrize("first", [0, 2])
def test_index_dispatch_equals_onehot_over_a_share_of_the_experts(first):
    """combine_index against combine_onehot over experts [first, first + 2)
    of 4 (an ep rank's share), with drops: outputs and the gradients of the
    tokens, the gates and the experts."""
    r = np.random.default_rng(first)
    N, C, F, E, K = 40, 16, 24, 4, 2
    logits = torch.tensor(r.normal(size=(N, E)).astype(np.float32))
    route = M.route(logits, K, 0.5)
    assert not route["keep"].all()
    weights = [torch.tensor(r.normal(size=s).astype(np.float32) * 0.2)
               for s in ((2, C, F), (2, F), (2, F, C), (2, C))]
    x = torch.tensor(r.normal(size=(N, C)).astype(np.float32))
    outs = []
    for combine in (M.combine_onehot, M.combine_index):
        ins = [t.clone().requires_grad_() for t in [x, route["gate"]] + weights]
        rr = dict(route, gate=ins[1])
        y = combine(ins[0], rr, *ins[2:], first=first)
        y.pow(2).sum().backward()
        outs.append([y.detach()] + [t.grad for t in ins])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **TOL)


# --------------------------------------------------------------- the LMM --

def _batch(seed=0, B=4, L=20):
    """Rows of decreasing length: tokens BOS + coords + EOS, labels -100 on
    the condition, BOS and padding (padded positions are routed too)."""
    r = np.random.default_rng(seed)
    C = KW["num_cond_tokens"]
    lens = [L - 3 * i for i in range(B)]
    tokens = np.zeros((B, L + 2), np.int32)
    labels = np.full((B, C + L + 2), -100, np.int32)
    for i, n in enumerate(lens):
        coords = r.integers(6, 300, n)
        tokens[i, :n + 2] = np.concatenate([[1], coords, [2]])
        labels[i, C + 1:C + n + 2] = np.concatenate([coords, [2]])
    return {"conds": r.normal(size=(B, N_POINTS, 3)).astype(np.float32),
            "tokens": tokens, "labels": labels,
            "num_faces": np.array([100, 3000, 500, 800][:B], np.int32),
            "lengths": np.array([C + n + 2 for n in lens], np.int32)}


@functools.lru_cache(maxsize=None)
def _params():
    """The JAX MoE LMM's params, widened fourfold so that the point clouds
    steer the streams (the options varied below change no parameter)."""
    jm = JLMM(Options(**KW))
    b = _batch()
    rng = jax.random.PRNGKey(0)
    params = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                              *(jnp.asarray(b[k]) for k in FIELDS))
    return jax.tree.map(lambda x: np.asarray(x) * 4.0, {"params": params["params"]})


@functools.lru_cache(maxsize=None)
def _pair(**over):
    """The JAX MoE LMM of KW changed by `over`, its params, and the port's
    LMM on the same weights."""
    kw = dict(KW, **dict(over))
    tm = LMM(TOptions(**kw))
    load_state(tm, state_dict_from_flax(_params()))
    for layer in tm.mesh_decoder.model.layers:
        layer.dropout = 0.0  # the JAX objective is taken with train=False
    return JLMM(Options(**kw)), _params(), tm


@functools.lru_cache(maxsize=None)
def _jax_objective(cf, seed):
    jm, params, _ = _pair(moe_capacity_factor=cf)
    return jax_train_objective(jm, params, _batch(seed), KW_T.moe_aux_weight)


KW_T = TOptions(**KW)


def jax_train_objective(jm, params, b, weight):
    """(loss, loss_moe, grads) of the JAX train step's objective with
    dropout off (edgerunner_tpu/train/state.py:203-226)."""
    def loss_fn(p):
        out, mut = jm.apply(p, *(jnp.asarray(b[k]) for k in FIELDS), train=False,
                            mutable=["losses"])
        aux = jax.tree.leaves(mut)
        moe = sum(jnp.sum(a) for a in aux) / sum(a.size for a in aux)
        return out["loss"] + weight * moe, moe

    (loss, moe), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), float(moe), state_dict_from_flax(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", [False, True])
def test_moe_train_loss_and_gradients_match_jax(remat):
    """With drops (capacity factor 0.5); under checkpointing the replay
    routes as the first pass did."""
    cf = 0.5
    _, params, _ = _pair(moe_capacity_factor=cf)
    opt = TOptions(**dict(KW, moe_capacity_factor=cf, checkpointing=remat))
    tm = LMM(opt)
    load_state(tm, state_dict_from_flax(params))
    for layer in tm.mesh_decoder.model.layers:
        layer.dropout = 0.0
    b = _batch(1)
    loss, moe, want = _jax_objective(cf, 1)
    out = tm(*(torch.as_tensor(b[k]) for k in FIELDS), train=True)
    np.testing.assert_allclose(out["loss"].item(), loss, **TOL)
    np.testing.assert_allclose(out["loss_moe"].item(), moe, **TOL)
    assert 0.5 < moe < 2.0
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(out["loss"], list(named.values()))
    assert any(".moe.router." in n for n in named) and len(named) > 40
    for n, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), want[n], **TOL, err_msg=n)
    assert np.abs(want["mesh_decoder.model.layers.1.moe.router.weight"]).max() > 0


def test_moe_eval_loss_has_no_aux():
    jm, params, tm = _pair()
    b = _batch(2)
    jout = jax.jit(make_eval_step(jm))(params, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        out = tm(*(torch.as_tensor(b[k]) for k in FIELDS), train=False)
    assert "loss_moe" not in out
    np.testing.assert_allclose(out["loss"].item(), float(jout["loss"]), **TOL)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]), **TOL)


def test_moe_weights_round_trip(tmp_path):
    _, params, tm = _pair()
    sd = reference_state_dict(tm)
    assert sd["mesh_decoder.model.layers.0.moe.w1"].shape == (4, 64, 256)
    assert not any(".fc1." in n for n in sd)
    back = flax_from_state_dict(sd)["params"]["mesh_decoder"]["model"]["layers_1"]["moe"]
    ref = params["params"]["mesh_decoder"]["model"]["layers_1"]["moe"]
    for k in EXPERTS:
        np.testing.assert_array_equal(back[k], ref[k])
    np.testing.assert_array_equal(back["router"]["kernel"], ref["router"]["kernel"])
    path = str(tmp_path / "model.safetensors")
    write_safetensors(path, sd)
    fresh = LMM(tm.opt)
    load_state(fresh, read_safetensors(path))
    for n, t in fresh.state_dict().items():
        torch.testing.assert_close(t, tm.state_dict()[n], rtol=0, atol=0)
    # the router stays f32 in a bf16 model
    half = LMM(tm.opt, dtype=torch.bfloat16)
    layer = half.mesh_decoder.model.layers[0].moe
    assert layer.router.weight.dtype == torch.float32 and layer.w1.dtype == torch.bfloat16


def test_trainer_logs_loss_moe():
    _, _, tm = _pair()
    model = LMM(tm.opt)
    model.load_state_dict(tm.state_dict())
    lines = []
    trainer = Trainer(model.train(), dataclasses.replace(tm.opt, mixed_precision="no"),
                      total_steps=4, logger=types.SimpleNamespace(info=lines.append))
    trainer.train_epoch([_batch(3), _batch(4)], 0)
    metrics = trainer.train_step(_batch(5))
    assert 0.5 < metrics["loss_moe"] < 2.0
    assert any(" loss_moe: " in ln for ln in lines), lines


# ------------------------------------------------------------- decoding --

def _pts(n, seed):
    return np.random.default_rng(seed).normal(size=(n, N_POINTS, 3)).astype(np.float32)


SPEC = dict(mtp_heads=2, spec_decode=True)


@functools.lru_cache(maxsize=None)
def _spec_pair():
    """The MoE pair with 2 draft heads of random non-zero weights."""
    params = jax.tree.map(np.copy, _params())
    r = np.random.default_rng(7)
    for k in range(2):
        params["params"]["mesh_decoder"][f"mtp_{k}"] = {
            "kernel": (r.normal(size=(64, 64)) * 0.3).astype(np.float32),
            "bias": (r.normal(size=(64,)) * 0.1).astype(np.float32)}
    jm = JLMM(Options(**dict(KW, **SPEC)))
    tm = LMM(TOptions(**dict(KW, **SPEC)))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("case", ["exact", "int8", "spec"])
def test_moe_greedy_streams_equal_jax(case):
    """3 rows at once (a decode step's capacity is 2 per expert, so rows
    drop each other's tokens), 20 faces, EOS forbidden."""
    if case == "spec":
        jm, params, tm = _spec_pair()
    else:
        jm, params, tm = _pair(**({"kv_quant": True} if case == "int8" else {}))
    pts = _pts(3, 11)
    ref = JG.generate_tokens(jm, params, pts, num_faces=20, bench_no_eos=True)
    with torch.no_grad():
        out = TG.generate_tokens(tm.eval(), pts, num_faces=20, bench_no_eos=True)
    assert out.shape == ref.shape and out.shape[1] > 64
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert len({tuple(r) for r in out.tolist()}) > 1, "rows should differ"


def _stopped(engine):
    """An engine whose worker has stopped: its state is driven from here."""
    engine.shutdown()
    engine.thread.join(timeout=60)
    assert not engine.thread.is_alive()
    return engine


def test_moe_engine_segment_equals_the_jax_engine():
    """Two requests admitted into 3 slots (the free slot routed with them),
    then one segment of 48 steps on each engine: every slot's tokens, count
    and done flag equal the JAX engine's."""
    jm, params, tm = _pair()
    opt = tm.opt
    reqs = [(p, nf) for p, nf in zip(_pts(2, 21), (20, 30))]
    jeng = _stopped(JEngine(jm, params, Options(**KW), batch=3, segment_steps=48))
    teng = _stopped(ContinuousEngine(tm.eval(), opt, batch=3, segment_steps=48))
    for slot, (p, nf) in enumerate(reqs):
        jeng._admit_one(slot, JRequest(p, nf, None))
    st = jeng.state
    (st["tokens"], st["next_logits"], st["h_last"], st["k_cache"], st["v_cache"], st["pos"],
     st["n"], st["done"], st["gstate"], st["rng"]) = jeng._segment(
        params, st["tokens"], st["next_logits"], st["h_last"], st["k_cache"],
        st["v_cache"], st["pos"], st["n"], st["budget"], st["gstate"], st["done"],
        st["rng"], jeng._active_mask(), jnp.asarray(48))
    with torch.inference_mode():
        for slot, (p, nf) in enumerate(reqs):
            teng._admit_one(slot, Request(p, nf, None))
        teng._segment(torch.tensor([True, True, False]))
    n = teng.state["n"].numpy()
    np.testing.assert_array_equal(n, np.asarray(st["n"]))
    np.testing.assert_array_equal(teng.state["done"].numpy(), np.asarray(st["done"]))
    assert n.max() > 8 and n[2] == 0
    for s in range(2):
        np.testing.assert_array_equal(teng.state["tokens"][s, :n[s]].numpy(),
                                      np.asarray(st["tokens"])[s, :n[s]])


def test_w_quant_under_moe_quantises_only_the_attention():
    """As the JAX walk (w_quant.py:92-123) finds no fc1/fc2 under MoE: the
    q/k/v/out projections become int8, the router and the experts stay
    exact, and the int8 values and scales equal the JAX package's."""
    _, params, tm = _pair()
    model = LMM(tm.opt)
    model.load_state_dict(tm.state_dict())
    quantize_lmm_params(model)
    jq = jquantize(params)["params"]["mesh_decoder"]["model"]["layers_0"]
    layer = model.mesh_decoder.model.layers[0]
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        mod = getattr(layer.self_attn, name)
        assert isinstance(mod, QuantDense), name
        np.testing.assert_array_equal(mod.kernel_q.numpy(), np.asarray(jq["self_attn"][name]["kernel_q"]))
        np.testing.assert_allclose(mod.scale.numpy(), np.asarray(jq["self_attn"][name]["scale"]),
                                   rtol=1e-6)
    assert set(jq["moe"]) == {"router", *EXPERTS} and "kernel" in jq["moe"]["router"]
    assert type(layer.moe.router) is torch.nn.Linear
    for k in EXPERTS:
        torch.testing.assert_close(getattr(layer.moe, k), getattr(
            tm.mesh_decoder.model.layers[0].moe, k), rtol=0, atol=0)

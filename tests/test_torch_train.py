"""The port's training step against the JAX package, in f32 on the CPU.

The same weights (a flax init carried across through `state_dict_from_flax`)
and the same batch (numpy, from a seed) go through both: the loss and every
gradient of `LMM.forward` against `jax.value_and_grad` of the JAX
`LMM.apply`; the optimizer update, given equal gradients, against the JAX
package's fused update and its optax chain; the schedule; and gradient
accumulation against `optax.MultiSteps`.

Tolerance: atol 1e-5, rtol 1e-4 in f32 for the loss, the gradients and the
updated parameters (the two frameworks sum the same products in another
order); the bf16 first moment to one bf16 step at its tensor's scale
(2^-7 of the value plus 2^-7 of the tensor's largest moment): an f32
difference of one ulp can round a moment to the neighbouring bf16 value,
and the next step carries that step on.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.train import state as jstate
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.train.state import AdamW, cosine_warmup_schedule, make_optimizer
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.weights import load_state, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
B, N_POINTS, L = 2, 48, 24
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
          hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=256,
          use_num_face_cond=True, checkpointing=False, point_num=N_POINTS,
          lr=1e-3, warmup_ratio=0.0, gradient_clip=0.5)


def _batch(seed=0):
    """Two rows, the second cut short: tokens BOS+L+EOS, labels -100 on cond,
    BOS and padding."""
    r = np.random.default_rng(seed)
    C = KW["num_cond_tokens"]
    lens = [L, L - 7]
    tokens = np.zeros((B, L + 2), np.int32)
    labels = np.full((B, C + L + 2), -100, np.int32)
    for i, n in enumerate(lens):
        coords = r.integers(6, 300, n)
        tokens[i, :n + 2] = np.concatenate([[1], coords, [2]])
        labels[i, C + 1:C + n + 2] = np.concatenate([coords, [2]])
    return {"conds": r.normal(size=(B, N_POINTS, 3)).astype(np.float32),
            "tokens": tokens, "labels": labels,
            "num_faces": np.array([100, 3000], np.int32),
            "lengths": np.array([C + n + 2 for n in lens], np.int32)}


@pytest.fixture(scope="module")
def pair():
    """(jax model, flax params as numpy, port model) with the same weights."""
    jm = JLMM(Options(**KW))
    b = _batch()
    rng = jax.random.PRNGKey(0)
    params = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng}, *(
        jnp.asarray(b[k]) for k in ("conds", "tokens", "labels", "num_faces", "lengths")))
    params = jax.tree.map(np.asarray, params)
    tm = LMM(TOptions(**KW))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm


def _port_loss_grads(tm, b, **kw):
    out = tm(*(torch.as_tensor(b[k]) for k in ("conds", "tokens", "labels", "num_faces",
                                               "lengths")), **kw)
    params = dict(tm.named_parameters())
    return out, dict(zip(params, torch.autograd.grad(out["loss"], list(params.values()))))


def _jax_loss_grads(jm, params, b):
    def loss_fn(p):
        out = jm.apply(p, *(jnp.asarray(b[k]) for k in (
            "conds", "tokens", "labels", "num_faces", "lengths")), train=False)
        return out["loss"], out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return out, jax.tree.map(np.asarray, grads)


def _named(tree, names):
    """A flax tree in the port's parameter names (the point basis, a fixed
    table, is not a parameter)."""
    sd = state_dict_from_flax(tree)
    return {n: sd[n] for n in names}


def test_loss_and_gradients_match_jax(pair):
    jm, params, tm = pair
    b = _batch()
    out, grads = _port_loss_grads(tm, b, train=False)
    jout, jgrads = _jax_loss_grads(jm, params, b)
    for k in ("loss", "loss_ce", "loss_kl"):
        np.testing.assert_allclose(out[k].item(), float(jout[k]), **TOL)
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(jout["logits"]), **TOL)
    want = _named(jgrads, grads)
    assert len(want) == len(grads) > 40
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n], **TOL, err_msg=n)


def test_checkpointing_gives_the_same_gradients(pair):
    _, params, _ = pair
    b = _batch(1)
    grads = []
    for remat in (False, True):
        tm = LMM(TOptions(**dict(KW, checkpointing=remat)))
        load_state(tm, state_dict_from_flax(params))
        grads.append(_port_loss_grads(tm, b, train=False)[1])
    assert tm.mesh_decoder.model.remat and tm.point_encoder.cross_att.remat
    for n in grads[0]:
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=0, atol=0)


def _jax_opt(total_steps, **over):
    return jstate.make_optimizer(Options(**dict(KW, **over)), total_steps)


def _random_grads(params, seed):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda x: r.normal(size=x.shape).astype(np.float32) * 0.1, params)


def test_optimizer_steps_match_the_fused_update_and_the_optax_chain(pair):
    """Two steps (the second reads the bf16 first moment back), with
    clipping active: gnorm of these gradients is far above 0.5."""
    _, params, tm = pair
    tx, _ = _jax_opt(100)
    fused_p, chain_p = params, params
    fused_s = chain_s = tx.init(params)
    fused = jax.jit(functools.partial(jstate._fused_apply, tx.fused_spec))
    chain = jax.jit(tx.update)
    names = [n for n, _ in tm.named_parameters()]
    port = {n: torch.tensor(v) for n, v in _named(params, names).items()}
    adamw, _ = make_optimizer(TOptions(**KW), port, 100)
    for step in range(2):
        g = _random_grads(params, step)
        fused_p, fused_s, gnorm = fused(fused_p, g, fused_s)
        upd, chain_s = chain(g, chain_s, chain_p)
        chain_p = optax.apply_updates(chain_p, upd)
        got = adamw.update({n: torch.tensor(v) for n, v in _named(g, names).items()})
        np.testing.assert_allclose(got.item(), float(gnorm), **TOL)
        assert float(gnorm) > 0.5
    mu = _named({"params": fused_s[1][0].mu["params"]}, names)
    nu = _named({"params": fused_s[1][0].nu["params"]}, names)
    for n in names:
        for want in (_named(fused_p, names)[n], _named(chain_p, names)[n]):
            np.testing.assert_allclose(port[n].numpy(), want, **TOL, err_msg=n)
        assert adamw.mu[n].dtype == torch.bfloat16
        want = mu[n].astype(np.float32)
        np.testing.assert_allclose(adamw.mu[n].float().numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max(), err_msg=n)
        np.testing.assert_allclose(adamw.nu[n].numpy(), nu[n], **TOL, err_msg=n)
    assert adamw.count == 2


def test_schedule_matches_cosine_warmup_schedule():
    for warmup in (0.0, 0.1):
        mine = cosine_warmup_schedule(3e-4, 50, warmup_ratio=warmup)
        theirs = jstate.cosine_warmup_schedule(3e-4, 50, warmup_ratio=warmup)
        got = [mine(s) for s in range(60)]
        want = [float(theirs(jnp.asarray(s, jnp.int32))) for s in range(60)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_accumulation_matches_multisteps(pair):
    _, params, tm = pair
    tx, _ = _jax_opt(10, gradient_accumulation_steps=3)
    assert isinstance(tx, optax.MultiSteps)
    state = tx.init(params)
    update = jax.jit(tx.update)
    jp = params
    names = [n for n, _ in tm.named_parameters()]
    port = {n: torch.tensor(v) for n, v in _named(params, names).items()}
    adamw = AdamW(port, cosine_warmup_schedule(KW["lr"], 10, warmup_ratio=0.0),
                  weight_decay=0.01, clip=0.5, accumulate=3)
    for micro in range(6):
        g = _random_grads(params, 10 + micro)
        upd, state = update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        adamw.update({n: torch.tensor(v) for n, v in _named(g, names).items()})
        want = _named(jp, names)
        for n in names:
            np.testing.assert_allclose(port[n].numpy(), want[n], **TOL, err_msg=f"{micro} {n}")
    assert adamw.count == 2 and adamw.mini_step == 0


def test_dropout_is_off_in_eval_and_seeded_in_training(pair):
    _, params, _ = pair
    opt = TOptions(**dict(KW, checkpointing=True))
    b = _batch(2)
    runs = []
    for _ in range(2):
        tm = LMM(opt)
        load_state(tm, state_dict_from_flax(params))
        with torch.no_grad():
            evals = [tm(*(torch.as_tensor(b[k]) for k in (
                "conds", "tokens", "labels", "num_faces", "lengths")))["loss"].item()
                for _ in range(2)]
        assert evals[0] == evals[1]
        trainer = Trainer(tm, opt, total_steps=10)
        runs.append([trainer.train_step(b)["loss"] for _ in range(3)])
    assert runs[0] == runs[1]          # seeded from (seed, step): reproducible
    assert runs[0][0] != evals[0]      # dropout and num-face dropout were on


def test_trainer_seeds_differ_by_step():
    from edgerunner_tpu_torch.train.trainer import step_seeds

    seeds = {step_seeds(0, s) for s in range(50)} | {step_seeds(1, s) for s in range(50)}
    assert len(seeds) == 100

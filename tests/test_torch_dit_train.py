"""The port's DiT training loss, gradients and optimizer against the JAX
package's, in f32 on the CPU.

The same weights (a flax MDiT init carried across through
`mdit_state_dict_from_flax`), the same images and points (numpy, from a
seed) and the same three draws: JAX's `MDiT.__call__(train=True)` runs with
`jax.random.uniform`, `normal` and `randint` wrapped so that their results
are recorded, and the port's `MDiT.forward` takes the recorded draws.
Tolerances: the loss within 1e-5 relative (f32 sums in another order);
each trainable gradient within 1e-4 of its tensor's largest value, plus
1e-7 of the largest gradient of the model for the key projections' biases,
whose true gradient is zero (softmax ignores a shift of every logit) and
which both frameworks fill with rounding noise; the optimizer's
parameters within 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.mdit import MDiT as JMDiT
from edgerunner_tpu.train import state as jstate
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.mdit import MDiT
from edgerunner_tpu_torch.train.state import (
    frozen_param_keys,
    make_optimizer,
    trainable_parameters,
)
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.weights import load_state, mdit_state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 6
SMALL = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
             point_hidden_dim=32, point_num_heads=4, point_latent_dim=8,
             dit_hidden_dim=32, dit_num_heads=4, dit_num_layers=2,
             clip_image_size=32, clip_patch_size=8, clip_hidden_dim=32,
             clip_num_heads=4, clip_num_layers=2, clip_intermediate_dim=64,
             hidden_dim=64, num_layers=2, num_heads=4, max_seq_length=256,
             use_num_face_cond=True, checkpointing=False, point_num=64,
             mixed_precision="no")
FROZEN = ("image_encoder.", "point_encoder.")
CASES = {"v_prediction": {}, "epsilon": dict(noise_scheduler_predtype="epsilon"),
         "no_snr": dict(snr_gamma=None)}


@pytest.fixture(scope="module")
def params():
    jm = JMDiT(Options(**SMALL))
    rng = jax.random.PRNGKey(0)
    params = jax.jit(jm.init, static_argnames="train")(
        {"params": rng, "cfg": rng, "noise": rng, "time": rng},
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 64, 3)), train=True)
    return jax.tree.map(np.asarray, params)


def _port(params, **changes) -> MDiT:
    tm = MDiT(TOptions(**dict(SMALL, **changes)))
    load_state(tm, mdit_state_dict_from_flax(params))
    return tm


def _batch(seed=0):
    r = np.random.default_rng(seed)
    return (r.uniform(size=(B, 32, 32, 3)).astype(np.float32),
            r.normal(size=(B, 64, 3)).astype(np.float32))


def _rngs(jm, params):
    """(cfg, noise, time) keys, the cfg key the first whose draw (through
    make_rng at the MDiT's scope, as `__call__` draws it) drops the condition
    of at least one row, so that the dropout is exercised."""
    base = jax.random.PRNGKey(3)
    for i in range(100):
        cfg = jax.random.fold_in(base, i)
        u = jm.apply(params, method=lambda m: jax.random.uniform(m.make_rng("cfg"), (B, 1, 1)),
                     rngs={"cfg": cfg})
        if (np.asarray(u) < 0.1).any():
            break
    return {"cfg": cfg, "noise": jax.random.fold_in(base, 1000),
            "time": jax.random.fold_in(base, 1001)}


def _jax_run(monkeypatch, params, images, points, **changes):
    """(loss, grads, draws) of JAX's training loss, the draws recorded where
    `__call__` makes them and returned beside the loss."""
    jm = JMDiT(Options(**dict(SMALL, **changes)))
    rngs = _rngs(jm, params)
    draws = {}
    for name in ("uniform", "normal", "randint"):
        original = getattr(jax.random, name)

        def recording(*args, _name=name, _original=original, **kw):
            out = _original(*args, **kw)
            draws.setdefault(_name, out)
            return out

        monkeypatch.setattr(jax.random, name, recording)

    def loss_fn(p):
        draws.clear()
        out = jm.apply(p, jnp.asarray(images), jnp.asarray(points), train=True, rngs=rngs)
        return out["loss"], dict(draws)

    (loss, got), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    monkeypatch.undo()
    return (float(loss), jax.tree.map(np.asarray, grads),
            {k: np.asarray(v) for k, v in got.items()})


def _port_run(tm, images, points, draws):
    out = tm(torch.tensor(images), torch.tensor(points), train=True,
             keep=torch.tensor(draws["uniform"] >= 0.1), noise=torch.tensor(draws["normal"]),
             t=torch.tensor(draws["randint"]).long())
    named = dict(tm.named_parameters())
    grads = torch.autograd.grad(out["loss"], list(named.values()), allow_unused=True)
    return out["loss"].item(), dict(zip(named, grads))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(monkeypatch, params, case):
    images, points = _batch()
    jloss, jgrads, draws = _jax_run(monkeypatch, params, images, points, **CASES[case])
    assert draws["uniform"].shape == (B, 1, 1) and (draws["uniform"] < 0.1).any()
    assert draws["normal"].shape == (B, 16, 8) and draws["randint"].shape == (B,)
    tm = _port(params, **CASES[case])
    loss, grads = _port_run(tm, images, points, draws)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=0)
    want = mdit_state_dict_from_flax(jgrads)
    trainable = [n for n in grads if not n.startswith(FROZEN)]
    assert len(trainable) > 30
    top = max(np.abs(want[n]).max() for n in trainable)
    for n in trainable:
        g, w = grads[n].numpy(), want[n]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-7 * top,
                                   err_msg=n)
    # the frozen towers take no gradient, and JAX's stop_gradient gives them zeros
    for n in grads:
        if n.startswith(FROZEN):
            assert grads[n] is None and not want[n].any(), n


def test_remat_gives_bit_equal_loss_and_gradients(params):
    images, points = _batch(1)
    r = np.random.default_rng(2)
    draws = {"uniform": r.uniform(size=(B, 1, 1)).astype(np.float32),
             "normal": r.normal(size=(B, 16, 8)).astype(np.float32),
             "randint": r.integers(0, 1000, B)}
    runs = []
    for remat in (False, True):
        tm = _port(params, checkpointing=remat)
        assert all(layer.remat == remat for layer in tm.dit.layers)
        runs.append(_port_run(tm, images, points, draws))
    assert runs[0][0] == runs[1][0]
    for n, g in runs[0][1].items():
        if g is not None:
            torch.testing.assert_close(runs[1][1][n], g, rtol=0, atol=0)


def test_forward_draws_from_the_generator(params):
    tm = _port(params)
    images, points = (torch.tensor(x) for x in _batch(2))

    def loss(seed, train=True):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tm(images, points, train=train, generator=gen)["loss"].item()

    assert loss(5) == loss(5) and loss(5) != loss(6)
    assert loss(5, train=False) == loss(5, train=False)


def test_trainer_steps_only_the_trainable_parameters(params):
    tm = _port(params, lr=1e-3, warmup_ratio=0.0)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    trainer = Trainer(tm, tm.opt, total_steps=10, kind="dit")
    assert set(trainer.params) == {n for n in before if not n.startswith(FROZEN)}
    assert not any(p.requires_grad for n, p in tm.named_parameters() if n.startswith(FROZEN))
    images, points = _batch(3)
    losses = [trainer.train_step({"images": images, "points": points})["loss"]
              for _ in range(2)]
    assert all(np.isfinite(losses))
    for n, p in tm.named_parameters():
        if n.startswith(FROZEN):
            assert torch.equal(p, before[n]), n
    assert any(not torch.equal(p, before[n]) for n, p in trainer.params.items())


def test_two_updates_match_jax_masked_adamw(params):
    """The DiT preset's optimizer (weight decay 0.1, lr 1e-5, no warmup)
    with the DiT's frozen keys: JAX's masked chain against the port's AdamW
    over the trainable parameters, on the same gradients (JAX's frozen ones
    zero, as stop_gradient makes them), clipping active."""
    over = dict(lr=1e-5, weight_decay=0.1, warmup_ratio=0.0)
    jopt = Options(**dict(SMALL, **over))
    tx, _ = jstate.make_optimizer(jopt, 100, jstate.frozen_param_keys(jopt, "dit"))
    state = tx.init(params)
    update = jax.jit(tx.update)
    topt = TOptions(**dict(SMALL, **over))
    tm = _port(params)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    port = trainable_parameters(tm, frozen_param_keys(topt, "dit"))
    adamw, _ = make_optimizer(topt, port, 100)
    assert frozen_param_keys(topt, "dit") == jstate.frozen_param_keys(jopt, "dit")
    jp = params
    for step in range(2):
        r = np.random.default_rng(10 + step)
        g = jax.tree_util.tree_map_with_path(
            lambda path, x: (np.zeros_like(x) if any(
                getattr(k, "key", None) in ("image_encoder", "point_encoder") for k in path)
                else r.normal(size=x.shape).astype(np.float32) * 0.5), params)
        upd, state = update(g, state, jp)
        jp = jax.tree.map(lambda p, u: np.asarray(p + u), jp, upd)
        gnorm = adamw.update({n: torch.tensor(v) for n, v in
                              mdit_state_dict_from_flax(g).items() if n in port})
        assert gnorm.item() > topt.gradient_clip
    want = mdit_state_dict_from_flax(jp)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-6, err_msg=n)
        if n.startswith(FROZEN):
            assert torch.equal(p, before[n]), n
        else:  # each update moved it by about lr
            assert not torch.equal(p, before[n]), n
    assert set(adamw.mu) == set(port) and adamw.count == 2

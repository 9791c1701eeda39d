"""Data-parallel training of the port's MDiT against the JAX package's, in
f32 on the CPU: one `Trainer.train_step` (model kind 'dit') with dp 2 over
two gloo CPU processes (tests/torch_dp_workers.py), each rank holding half
of a 4-row batch, against the JAX step on a dp2 mesh of two virtual CPU
devices, from the same flax init (`mdit_state_dict_from_flax`). The three
draws (condition dropout, noise, timesteps) are JAX's, recorded as
tests/test_torch_dit_train.py records them, each rank given its rows; the
JAX update is its masked AdamW chain over the trainable parameters.

Tolerance, as tests/test_torch_sp_train.py: the loss atol 1e-5, rtol 1e-4;
each trainable parameter's update atol 1e-5 (1% of the learning rate
1e-3), rtol 1e-4; both ranks' parameters equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.mdit import MDiT as JMDiT
from edgerunner_tpu.parallel import batch_sharding, make_mesh
from edgerunner_tpu.train import state as jstate
from edgerunner_tpu_torch.weights import mdit_state_dict_from_flax
from torch_dp_workers import mdit_step
from torch_sp_workers import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
B = 4
DIT_KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
              point_hidden_dim=32, point_num_heads=4, point_latent_dim=8,
              dit_hidden_dim=32, dit_num_heads=4, dit_num_layers=2,
              clip_image_size=32, clip_patch_size=8, clip_hidden_dim=32,
              clip_num_heads=4, clip_num_layers=2, clip_intermediate_dim=64,
              hidden_dim=64, num_layers=2, num_heads=4, max_seq_length=256,
              use_num_face_cond=True, checkpointing=False, point_num=64,
              mixed_precision="no", lr=1e-3, warmup_ratio=0.0)
FROZEN = ("image_encoder.", "point_encoder.")


@pytest.fixture(scope="module")
def mdit(tmp_path_factory):
    """The port's dp 2 MDiT step and the JAX step on a dp2 mesh, from the
    same weights, batch and draws."""
    jopt = Options(**DIT_KW)
    jm = JMDiT(jopt)
    rng = jax.random.PRNGKey(0)
    params = jax.tree.map(np.asarray, jax.jit(jm.init, static_argnames="train")(
        {"params": rng, "cfg": rng, "noise": rng, "time": rng},
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 64, 3)), train=True))
    r = np.random.default_rng(4)
    images = r.uniform(size=(B, 32, 32, 3)).astype(np.float32)
    points = r.normal(size=(B, 64, 3)).astype(np.float32)
    mesh = make_mesh(2, 1, 1, devices=jax.devices()[:2])
    imgs, pts = (jax.device_put(x, batch_sharding(mesh)) for x in (images, points))
    keys = {"cfg": jax.random.PRNGKey(5), "noise": jax.random.PRNGKey(6),
            "time": jax.random.PRNGKey(7)}
    draws, originals = {}, {n: getattr(jax.random, n) for n in ("uniform", "normal", "randint")}

    def recording(*args, _name, **kw):
        out = originals[_name](*args, **kw)
        draws.setdefault(_name, out)
        return out

    def loss_fn(p):
        draws.clear()
        return jm.apply(p, imgs, pts, train=True, rngs=keys)["loss"], dict(draws)

    try:
        for n in originals:
            setattr(jax.random, n, functools.partial(recording, _name=n))
        (loss, got), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        for n, f in originals.items():
            setattr(jax.random, n, f)
    tx, _ = jstate.make_optimizer(jopt, 10, jstate.frozen_param_keys(jopt, "dit"))
    upd, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    got = {k: np.asarray(v) for k, v in got.items()}
    state = mdit_state_dict_from_flax(params)
    ranks = spawn(mdit_step, 2, tmp_path_factory.mktemp("mdit"), DIT_KW, state,
                  {"images": images, "points": points}, got)
    return state, ranks, float(loss), mdit_state_dict_from_flax(jax.tree.map(np.asarray, upd))


def test_mdit_dp_step_matches_jax(mdit):
    state, ranks, jloss, jdelta = mdit
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(float(res["step0_loss"]), jloss, **TOL, err_msg=f"rank {r}")
    trainable = [n for n in jdelta if f"step0/{n}" in ranks[0]]
    assert len(trainable) > 30 and not any(n.startswith(FROZEN) for n in trainable)
    for n in trainable:
        np.testing.assert_allclose(ranks[0][f"step0/{n}"] - state[n], jdelta[n], **TOL,
                                   err_msg=n)
    for key, val in ranks[0].items():
        assert np.array_equal(ranks[1][key], val), key

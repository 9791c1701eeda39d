"""Sequence-parallel training of the port against the JAX package's, in f32
on the CPU.

One training step with sp 2 and 4: the port's `Trainer.train_step` over 2
and 4 gloo CPU processes (tests/torch_sp_workers.py) against the JAX
package's step on an sp mesh of as many virtual CPU devices (dp 1, the ring
of `ring_attention` inside `attention`, as tests/test_train.py's
`test_dp_sp_equivalence` builds it), from the same weights (a flax init
carried across with `state_dict_from_flax`) on the same batch. The batch's
attention length (17 + 26 = 43) is odd: both packages pad it to a multiple
of sp. Dropout and num-face dropout are off on both sides (the two packages
draw other random bits): the JAX loss is taken with train=False, the port's
decoder layers get dropout 0 and `nof_dropout_ratio` is 0. The JAX update is
its fused AdamW (`_fused_apply`), as in tests/test_torch_train.py.

Tolerance: the loss atol 1e-5, rtol 1e-4, and each parameter's update atol
1e-5 (1% of the learning rate 1e-3, which bounds the first Adam step),
rtol 1e-4: f32, the same sums in another order. Every rank's parameters
must be the same.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.parallel import batch_sharding, make_mesh, set_sequence_parallel
from edgerunner_tpu.train import state as jstate
from edgerunner_tpu.train.trainer import _device_batch
from edgerunner_tpu_torch.weights import state_dict_from_flax
from torch_sp_workers import spawn, train_steps
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
B, N_POINTS, L = 2, 48, 24
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
          hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=256,
          use_num_face_cond=True, checkpointing=False, point_num=N_POINTS,
          lr=1e-3, warmup_ratio=0.0, gradient_clip=0.5, nof_dropout_ratio=0.0)
FIELDS = ("conds", "tokens", "labels", "num_faces", "lengths")


def make_batch(seed=0, mesh_tokens=L):
    """Two rows, the second cut short: tokens BOS+L+EOS, labels -100 on cond,
    BOS and padding."""
    r = np.random.default_rng(seed)
    C = KW["num_cond_tokens"]
    lens = [mesh_tokens, mesh_tokens - 7]
    tokens = np.zeros((B, mesh_tokens + 2), np.int32)
    labels = np.full((B, C + mesh_tokens + 2), -100, np.int32)
    for i, n in enumerate(lens):
        coords = r.integers(6, 300, n)
        tokens[i, :n + 2] = np.concatenate([[1], coords, [2]])
        labels[i, C + 1:C + n + 2] = np.concatenate([coords, [2]])
    return {"conds": r.normal(size=(B, N_POINTS, 3)).astype(np.float32),
            "tokens": tokens, "labels": labels,
            "num_faces": np.array([100, 3000], np.int32),
            "lengths": np.array([C + n + 2 for n in lens], np.int32)}


@pytest.fixture(scope="module")
def params():
    jm = JLMM(Options(**KW))
    b = make_batch()
    rng = jax.random.PRNGKey(0)
    p = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                         *(jnp.asarray(b[k]) for k in FIELDS))
    return jax.tree.map(np.asarray, p)


def jax_sp_step(params, batch, sp):
    """(loss, {port name: parameter update}) of one JAX step on an sp mesh."""
    opt = Options(**KW)
    jm = JLMM(opt)
    mesh = make_mesh(1, 1, sp, devices=jax.devices()[:sp])
    set_sequence_parallel(mesh)
    try:
        dev = _device_batch(batch, batch_sharding(mesh), sp=sp, pad_token_id=opt.pad_token_id)

        def loss_fn(p):
            return jm.apply(p, *(dev[k] for k in FIELDS), train=False)["loss"]

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    finally:
        set_sequence_parallel(None)
    tx, _ = jstate.make_optimizer(opt, 10)
    new, _, _ = jax.jit(functools.partial(jstate._fused_apply, tx.fused_spec))(
        params, grads, tx.init(params))
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new, params)
    return float(loss), state_dict_from_flax(delta)


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def step(request, params, tmp_path_factory):
    sp = request.param
    batch = make_batch()
    state = state_dict_from_flax(params)
    ranks = spawn(train_steps, sp, tmp_path_factory.mktemp(f"sp{sp}"), KW, state, [batch],
                  False)
    return sp, state, ranks, jax_sp_step(params, batch, sp)


def test_sp_step_loss_matches_jax(step):
    sp, _, ranks, (jloss, _) = step
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(float(res["step0_loss"]), jloss, **TOL, err_msg=f"rank {r}")


def test_sp_step_updates_match_jax(step):
    sp, state, ranks, (_, jdelta) = step
    names = [n for n in jdelta if f"step0/{n}" in ranks[0]]
    assert len(names) > 40
    for n in names:
        np.testing.assert_allclose(ranks[0][f"step0/{n}"] - state[n], jdelta[n], **TOL,
                                   err_msg=n)


def test_sp_step_leaves_every_rank_the_same_parameters(step):
    sp, _, ranks, _ = step
    for r in range(1, sp):
        for key, val in ranks[0].items():
            assert np.array_equal(ranks[r][key], val), (r, key)

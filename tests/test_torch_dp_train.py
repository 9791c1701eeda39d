"""Data-parallel training of the port against the JAX package's, in f32 on
the CPU.

One training step of the port's `Trainer.train_step` over gloo CPU
processes (tests/torch_dp_workers.py), each rank holding its dp group's rows
of a 4-row global batch, against the JAX package's step on a mesh of as many
virtual CPU devices (the batch split over dp as `batch_sharding` splits it,
tests/test_multihost.py), from the same weights (a flax init carried across
with `state_dict_from_flax` / `mdit_state_dict_from_flax`):

- the LMM with dp 2: the rows are cut to lengths that give the two ranks
  different label counts, so that a mean of the ranks' mean losses (what
  DDP's averaging would give) misses the JAX loss, which the test checks;
- the LMM with dp 2 × sp 2 over 4 processes against the JAX dp2 × sp2 mesh
  (tests/test_train.py `test_dp_sp_equivalence`); the attention length 43
  is padded to a multiple of sp on both sides.

The MDiT's dp step is held to the JAX step in tests/test_torch_dp_mdit.py.

Dropout and num-face dropout are off (the two packages draw other bits):
the JAX loss is taken with train=False. The random weights are widened
twofold, so that the rows' losses per label differ. The JAX update is its
fused AdamW (`_fused_apply`).

Tolerance, as tests/test_torch_sp_train.py: the loss atol 1e-5, rtol 1e-4;
each parameter's update atol 1e-5 (1% of the learning rate 1e-3, which
bounds the first Adam step), rtol 1e-4; every rank's parameters equal.
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
from torch_dp_workers import lmm_step
from torch_sp_workers import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
B, N_POINTS, L = 4, 48, 24
LENS = (L, L - 2, L - 9, L - 14)  # rank 0's rows hold 46 labels, rank 1's 27
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
          hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=256,
          use_num_face_cond=True, checkpointing=False, point_num=N_POINTS,
          lr=1e-3, warmup_ratio=0.0, gradient_clip=0.5, nof_dropout_ratio=0.0)
FIELDS = ("conds", "tokens", "labels", "num_faces", "lengths")


def make_batch(seed=0):
    """Four rows of the lengths LENS: tokens BOS + coords + EOS, labels -100
    on the condition, BOS and padding."""
    r = np.random.default_rng(seed)
    C = KW["num_cond_tokens"]
    tokens = np.zeros((B, L + 2), np.int32)
    labels = np.full((B, C + L + 2), -100, np.int32)
    for i, n in enumerate(LENS):
        coords = r.integers(6, 300, n)
        tokens[i, :n + 2] = np.concatenate([[1], coords, [2]])
        labels[i, C + 1:C + n + 2] = np.concatenate([coords, [2]])
    return {"conds": r.normal(size=(B, N_POINTS, 3)).astype(np.float32),
            "tokens": tokens, "labels": labels,
            "num_faces": np.array([100, 3000, 500, 1000], np.int32),
            "lengths": np.array([C + n + 2 for n in LENS], np.int32)}


@pytest.fixture(scope="module")
def params():
    jm = JLMM(Options(**KW))
    b = make_batch()
    rng = jax.random.PRNGKey(0)
    p = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                         *(jnp.asarray(b[k]) for k in FIELDS))
    # widened, so that rows differ in their loss per label
    return jax.tree.map(lambda x: np.asarray(x) * 2.0, p)


def jax_loss(params, batch, dp, sp):
    """(loss, grads) of the JAX LMM on a dp × sp mesh, train=False."""
    jm = JLMM(Options(**KW))
    mesh = make_mesh(dp, 1, sp, devices=jax.devices()[:dp * sp])
    set_sequence_parallel(mesh if sp > 1 else None)
    try:
        dev = _device_batch(batch, batch_sharding(mesh), sp=sp, pad_token_id=0)

        def loss_fn(p):
            return jm.apply(p, *(dev[k] for k in FIELDS), train=False)["loss"]

        return jax.jit(jax.value_and_grad(loss_fn))(params)
    finally:
        set_sequence_parallel(None)


def jax_step(params, batch, dp, sp):
    """(loss, {port name: parameter update}) of one JAX step."""
    loss, grads = jax_loss(params, batch, dp, sp)
    tx, _ = jstate.make_optimizer(Options(**KW), 10)
    new, _, _ = jax.jit(functools.partial(jstate._fused_apply, tx.fused_spec))(
        params, grads, tx.init(params))
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new, params)
    return float(loss), state_dict_from_flax(delta)


@pytest.fixture(scope="module", params=[(2, 1), (2, 2)], ids=["dp2", "dp2xsp2"])
def step(request, params, tmp_path_factory):
    dp, sp = request.param
    batch = make_batch()
    state = state_dict_from_flax(params)
    ranks = spawn(lmm_step, dp * sp, tmp_path_factory.mktemp(f"dp{dp}sp{sp}"), KW, state,
                  batch, dp, sp)
    return state, ranks, jax_step(params, batch, dp, sp)


def test_the_ranks_label_counts_differ_so_a_mean_of_means_misses(params):
    batch = make_batch()
    counts = [(batch["labels"][r:r + 2, 1:] != -100).sum() for r in (0, 2)]
    assert counts[0] != counts[1]
    whole = float(jax_loss(params, batch, 1, 1)[0])
    halves = [float(jax_loss(params, {k: v[r:r + 2] for k, v in batch.items()}, 1, 1)[0])
              for r in (0, 2)]
    assert abs(np.mean(halves) - whole) > 20 * (TOL["atol"] + TOL["rtol"] * abs(whole))


def test_dp_step_loss_matches_jax(step):
    _, ranks, (jloss, _) = step
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(float(res["step0_loss"]), jloss, **TOL, err_msg=f"rank {r}")


def test_dp_step_updates_match_jax(step):
    state, ranks, (_, jdelta) = step
    names = [n for n in jdelta if f"step0/{n}" in ranks[0]]
    assert len(names) > 40
    for n in names:
        np.testing.assert_allclose(ranks[0][f"step0/{n}"] - state[n], jdelta[n], **TOL,
                                   err_msg=n)


def test_dp_step_leaves_every_rank_the_same_parameters(step):
    _, ranks, _ = step
    for r in range(1, len(ranks)):
        for key, val in ranks[0].items():
            assert np.array_equal(ranks[r][key], val), (r, key)

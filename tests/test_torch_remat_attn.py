"""--remat_policy attn of the port, in f32 on the CPU.

Under 'attn' each decoder layer's attention (its q/k/v projections and the
attention call) runs outside the checkpoint and keeps its output, and the
rest of the layer is checkpointed (models/shape_opt.py), as the JAX
package's save_only_these_names("attn_out") keeps the output: the backward
pass does not replay the attention. The same kernels run on the same
inputs, so the loss and every gradient equal 'full''s bit for bit, dropout
on; the attention runs once per decoder layer in a step (twice under
'full'); the step stays within the training parity's tolerance (atol 1e-5,
rtol 1e-4, tests/test_torch_train.py) of the JAX 'attn' step; and under
sp 2 over gloo (the ring in place of the attention call) 'attn' equals
'full'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.weights import load_state, reference_state_dict, state_dict_from_flax
from torch_sp_workers import spawn, train_runs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
B, N_POINTS, L = 2, 48, 24
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
          hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=256,
          use_num_face_cond=True, checkpointing=True, point_num=N_POINTS,
          lr=1e-3, warmup_ratio=0.0, gradient_clip=0.5)
KEYS = ("conds", "tokens", "labels", "num_faces", "lengths")


def _batch(seed=0):
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
def state():
    return reference_state_dict(init_weights(LMM(TOptions(**KW)), 3))


def _model(state, policy):
    model = LMM(TOptions(**dict(KW, remat_policy=policy)))
    return load_state(model, state)


def _attention_calls(model) -> list:
    """Counts of each decoder layer's attention calls, kept up to date."""
    counts = []
    for layer in model.mesh_decoder.model.layers:
        attn = layer.self_attn
        counts.append(0)

        def counted(*a, _i=len(counts) - 1, _f=attn.attend, **kw):
            counts[_i] += 1
            return _f(*a, **kw)

        attn.attend = counted
    return counts


def _loss_and_grads(model, b, seed):
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        out = model(*(torch.as_tensor(b[k]) for k in KEYS), train=True,
                    generator=torch.Generator().manual_seed(seed))
        names = dict(model.named_parameters())
        grads = torch.autograd.grad(out["loss"], list(names.values()))
    return out, dict(zip(names, grads))


def test_attn_equals_full_bit_for_bit_with_dropout(state):
    b = _batch(1)
    runs = {}
    for policy in ("full", "attn"):
        model = _model(state, policy)
        counts = _attention_calls(model)
        out, grads = _loss_and_grads(model, b, seed=11)
        runs[policy] = (out, grads, counts)
    (o_full, g_full, c_full), (o_attn, g_attn, c_attn) = runs["full"], runs["attn"]
    assert c_full == [2, 2] and c_attn == [1, 1]   # forward, and full's replay
    for k in ("loss", "loss_ce", "loss_kl"):
        assert o_attn[k].item() == o_full[k].item(), k
    assert len(g_full) > 40
    for n in g_full:
        torch.testing.assert_close(g_attn[n], g_full[n], rtol=0, atol=0, msg=n)
    # dropout was on: the training loss differs from the eval loss
    with torch.no_grad():
        ev = _model(state, "attn")(*(torch.as_tensor(b[k]) for k in KEYS))["loss"].item()
    assert ev != o_attn["loss"].item()


def test_attn_trainer_steps_equal_full(state):
    b = _batch(2)
    params = {}
    for policy in ("full", "attn"):
        opt = TOptions(**dict(KW, remat_policy=policy))
        trainer = Trainer(_model(state, policy), opt, total_steps=10)
        trainer.init_state()
        metrics = [trainer.train_step(b) for _ in range(2)]
        params[policy] = (metrics, {n: p.detach().clone() for n, p in trainer.params.items()})
    assert params["attn"][0] == params["full"][0]
    for n, p in params["full"][1].items():
        torch.testing.assert_close(params["attn"][1][n], p, rtol=0, atol=0, msg=n)


def test_attn_step_matches_the_jax_attn_step():
    kw = dict(KW, remat_policy="attn")
    jm = JLMM(Options(**kw))
    b = _batch(3)
    rng = jax.random.PRNGKey(0)
    params = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                              *(jnp.asarray(b[k]) for k in KEYS))
    params = jax.tree.map(np.asarray, params)
    model = LMM(TOptions(**kw))
    load_state(model, state_dict_from_flax(params))
    out = model(*(torch.as_tensor(b[k]) for k in KEYS), train=False)
    names = dict(model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(out["loss"], list(names.values()))))

    def loss_fn(p):
        o = jm.apply(p, *(jnp.asarray(b[k]) for k in KEYS), train=False)
        return o["loss"], o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    np.testing.assert_allclose(out["loss"].item(), float(jout["loss"]), **TOL)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n], **TOL, err_msg=n)


def test_sp2_attn_equals_sp2_full(state, tmp_path):
    """Two gloo ranks, each on half of the positions, the attention a ring:
    two steps under each policy, dropout on, from the same weights."""
    batches = [_batch(4), _batch(5)]
    runs = [(dict(KW, remat_policy=p), state, batches, True, p) for p in ("full", "attn")]
    ranks = spawn(train_runs, 2, tmp_path, runs)
    for out in ranks:
        keys = [k[len("full"):] for k in out if k.startswith("full")]
        assert len(keys) > 80
        for k in keys:
            np.testing.assert_array_equal(out["attn" + k], out["full" + k], err_msg=k)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)

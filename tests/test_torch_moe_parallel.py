"""The port's MoE training under data and expert parallelism against one
process and against the JAX package's dp/ep meshes, in f32 on the CPU.

One `Trainer.train_step` over gloo CPU processes (tests/torch_moe_workers.py)
at the JAX MoE tests' size (2 layers, hidden 64, 4 experts, top-2;
tests/test_moe.py:33-37, `test_dp_ep_equivalence`): dp 2, dp 1 × ep 2 and
dp 2 × ep 2, each dp group holding its rows of a 4-row global batch (the
rows cut to lengths that give the groups different label counts), against
the same step in one process and against the JAX objective (loss + 0.01 ×
the layers' mean aux, dropout off) on a mesh of as many virtual devices
with the batch split over dp and the experts over ep (`param_shardings`):

- the loss, loss_moe, the gradients that the optimizer takes (summed over
  the ranks that hold the same experts; the experts gathered whole) and
  the global norm that clipping takes;
- the routing is the global batch's: capacity factor 0.5 drops tokens, and
  routing each dp group's rows alone would give another loss;
- under gradient checkpointing, whose replay routes again (the counts
  all-gathered again, in the same order on every rank), as the first pass;
- after the step every rank holds the same replicated weights, bit for
  bit: what enters a rank's experts has its gradient summed over the group;
- `main` at ep 2 writes checkpoints with every expert, which load strictly
  into a one-process model, and resumes at ep 2 and at ep 1 alike.

Tolerance: atol 1e-5, rtol 1e-4 (f32 summed in another order, as
tests/test_torch_dp_train.py).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.parallel import batch_sharding, make_mesh, param_shardings
from edgerunner_tpu_torch import main as tmain
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models import moe as M
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.weights import load_state, read_safetensors, state_dict_from_flax
from torch_moe_workers import moe_step
from torch_sp_workers import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
B, N_POINTS, L = 4, 48, 24
LENS = (L, L - 2, L - 9, L - 14)
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=32, point_num_heads=4, point_latent_dim=8,
          hidden_dim=64, num_layers=2, num_heads=4, max_seq_length=256,
          use_num_face_cond=True, checkpointing=True, point_num=N_POINTS,
          lr=1e-3, warmup_ratio=0.0, gradient_clip=0.5, nof_dropout_ratio=0.0,
          mixed_precision="no", moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
FIELDS = ("conds", "tokens", "labels", "num_faces", "lengths")
TINY = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "4",
        "--point_hidden_dim", "32", "--point_num_heads", "4", "--point_latent_size", "16",
        "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "48",
        "--max_seq_length", "256", "--moe_experts", "4", "--moe_top_k", "2"]


def make_batch(seed=0):
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


@functools.lru_cache(maxsize=None)
def params():
    jm = JLMM(Options(**KW))
    b = make_batch()
    rng = jax.random.PRNGKey(0)
    p = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                         *(jnp.asarray(b[k]) for k in FIELDS))
    # widened, so that the rows differ in their loss per label
    return jax.tree.map(lambda x: np.asarray(x) * 2.0, {"params": p["params"]})


def jax_objective(dp, ep):
    """(loss, loss_moe, grads by port name, global norm) of the JAX
    objective on a dp × ep mesh (tests/test_moe.py:160-190)."""
    jm = JLMM(Options(**KW))
    mesh = make_mesh(dp, 1, 1, 1, ep, devices=jax.devices()[:dp * ep])
    p = jax.tree.map(lambda x, s: jax.device_put(x, s), params(),
                     param_shardings(params(), mesh))
    b = {k: jax.device_put(v, batch_sharding(mesh)) for k, v in make_batch().items()}

    def loss_fn(q):
        out, mut = jm.apply(q, *(b[k] for k in FIELDS), train=False, mutable=["losses"])
        aux = jax.tree.leaves(mut)
        moe = sum(jnp.sum(a) for a in aux) / sum(a.size for a in aux)
        return out["loss"] + KW_OPT.moe_aux_weight * moe, moe

    (loss, moe), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p)
    g = jax.tree.map(np.asarray, jax.device_get(g))
    norm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in jax.tree.leaves(g))))
    return float(loss), float(moe), state_dict_from_flax(g), norm


KW_OPT = TOptions(**KW)


def one_process():
    """The same step in this process, no dp, no ep: metrics and grads."""
    model = LMM(TOptions(**KW))
    load_state(model, state_dict_from_flax(params()))
    for layer in model.mesh_decoder.model.layers:
        layer.dropout = 0.0
    trainer = Trainer(model, TOptions(**KW), total_steps=10)
    seen, update = {}, trainer.optimizer.update

    def capture(grads):
        seen.update({n: g.clone() for n, g in grads.items()})
        return update(grads)

    trainer.optimizer.update = capture
    return trainer.train_step(make_batch()), {n: g.numpy() for n, g in seen.items()}


@pytest.fixture(scope="module")
def single():
    return one_process()


LAYOUTS = {"dp2": (2, 1), "ep2": (1, 2), "dp2xep2": (2, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (name, the ranks' results, the JAX mesh's, its directory),
    each layout spawned once."""
    done = {}

    def get(name):
        if name not in done:
            done[name] = _spawn(name, tmp_path_factory.mktemp(name))
        return done[name]

    return get


def _spawn(name, tmp):
    dp, ep = LAYOUTS[name]
    main_argv = None
    if name == "ep2":
        # main at ep 2 for an epoch, then resumed for a second
        ws, argv = str(tmp / "ws"), ["ArAE", "--device", "cpu", "--data_root", "/nonexistent",
                                     "--synthetic_size", "8", "--batch_size", "2",
                                     "--num_workers", "0", "--ep_size", "2", *TINY]
        main_argv = ([*argv, "--workspace", ws, "--num_epochs", "1"],
                     [*argv, "--workspace", ws + "_r", "--num_epochs", "2", "--resume",
                      os.path.join(ws, "ep0000", "model.safetensors"),
                      "--resume_train_state", "true"])
    ranks = spawn(moe_step, dp * ep, tmp, KW, state_dict_from_flax(params()), make_batch(),
                  dp, ep, main_argv)
    return name, ranks, jax_objective(dp, ep), tmp


@pytest.fixture(params=list(LAYOUTS))
def run(request, runs):
    return runs(request.param)


def test_loss_and_loss_moe_match_one_process_and_jax(run, single):
    _, ranks, (jloss, jmoe, _, _), _ = run
    metrics, _ = single
    np.testing.assert_allclose(metrics["loss"], jloss, **TOL)
    np.testing.assert_allclose(metrics["loss_moe"], jmoe, **TOL)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(float(res["step0_loss"]), jloss, **TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(float(res["step0_loss_moe"]), jmoe, **TOL)


def test_gradients_and_global_norm_match_one_process_and_jax(run, single):
    _, ranks, (_, _, jgrads, jnorm), _ = run
    _, grads = single
    assert len(grads) > 40
    for n, g in grads.items():
        np.testing.assert_allclose(g, jgrads[n], **TOL, err_msg=n)
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res[f"grad/{n}"], g, **TOL, err_msg=f"{n} rank {r}")
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(float(res["step0_grad_norm"]), jnorm, **TOL)
    assert jnorm > KW["gradient_clip"]  # clipping is active


def test_every_rank_holds_the_same_weights_after_the_step(run):
    """Non-expert weights (the router, the attention) bit-equal on every
    rank; the experts gathered whole equal too, and each rank's own share
    is its slice."""
    name, ranks, _, _ = run
    ep = LAYOUTS[name][1]
    for r in range(1, len(ranks)):
        for key, val in ranks[0].items():
            if key.startswith("param/"):
                assert np.array_equal(ranks[r][key], val), (r, key)
    for r, res in enumerate(ranks):
        share = 4 // ep
        e = r % ep
        w1 = "mesh_decoder.model.layers.1.moe.w1"
        np.testing.assert_array_equal(res[f"own/{w1}"], res[f"param/{w1}"][e * share:(e + 1) * share])


def test_routing_is_the_global_batchs(single):
    """Capacity factor 0.5 drops tokens, so where the dp groups' rows were
    routed alone (each with its own capacity and queue) the loss would
    differ: the dp runs' equality above is the global routing's."""
    model = LMM(TOptions(**KW))
    load_state(model, state_dict_from_flax(params()))
    for layer in model.mesh_decoder.model.layers:
        layer.dropout = 0.0
    b = make_batch()
    x = torch.tensor(np.random.default_rng(1).normal(size=(B * 30, 64)).astype(np.float32))
    with torch.no_grad():
        logits = model.mesh_decoder.model.layers[0].moe.router(x)
    assert not M.route(logits, 2, 0.5)["keep"].all()
    with torch.no_grad():
        halves = [model(*(torch.as_tensor(b[k][i:i + 2]) for k in FIELDS), train=True)
                  for i in (0, 2)]
    counts = [(b["labels"][i:i + 2, 1:] != -100).sum() for i in (0, 2)]
    assert counts[0] != counts[1]
    alone = sum(h["loss_ce"].item() * c for h, c in zip(halves, counts)) / sum(counts)
    whole = single[0]["loss_ce"]
    assert abs(alone - whole) > 5 * (TOL["atol"] + TOL["rtol"] * abs(whole)), (alone, whole)


def test_checkpoints_at_ep2_hold_every_expert_and_resume_at_ep1(runs, tmp_path):
    _, ranks, _, tmp = runs("ep2")
    saved = read_safetensors(str(tmp / "ws" / "ep0000" / "model.safetensors"))
    assert saved["mesh_decoder.model.layers.0.moe.w1"].shape == (4, 64, 256)
    full = LMM(TOptions(**dict(KW, point_num=48)))
    load_state(full, saved)  # strict: one file for any ep
    argv = ["ArAE", "--device", "cpu", "--data_root", "/nonexistent", "--synthetic_size", "8",
            "--batch_size", "2", "--num_workers", "0", *TINY, "--workspace",
            str(tmp_path / "ws1"), "--num_epochs", "2", "--resume",
            str(tmp / "ws" / "ep0000" / "model.safetensors"), "--resume_train_state", "true"]
    trainer = tmain.main(argv)
    res = ranks[0]
    assert int(res["resumed_step"]) == trainer.step == 2 * len(res["main_losses"])
    np.testing.assert_allclose(trainer.losses, res["resumed_losses"], **TOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["resumed_losses"], res["resumed_losses"])

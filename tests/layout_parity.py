"""Shared pieces of the port's tp, pp and MoE-under-sp tests
(tests/test_torch_{tp,pp,moe_sp}.py): the small LMM they train, its batch,
the JAX package's objective on a mesh of the conftest's virtual CPU
devices, and the checks that hold the port's ranks to it and to the
port's one process.

The objective is the JAX trainer's (loss + moe_aux_weight × the MoE
layers' element-count mean aux, tests/test_moe.py), taken with train=False
(dropout off on both sides, whose bits differ), on a dp × pp × sp × tp × ep
mesh with `param_shardings`' layout, the batch split over dp
(`batch_sharding`), the sequence over sp (`_device_batch` pads it) and,
under pp, the decoder's layers stacked (`stack_layer_params`) and run
through `gpipe`. The flax init is widened twofold, so that the rows' losses
per label differ.

Tolerance: atol 1e-5, rtol 1e-4 (f32 summed in another order, as
tests/test_torch_dp_train.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.parallel import (
    batch_sharding,
    make_mesh,
    param_shardings,
    set_pipeline_parallel,
    set_sequence_parallel,
    stack_layer_params,
)
from edgerunner_tpu.train.trainer import _device_batch
from edgerunner_tpu_torch.weights import state_dict_from_flax

TOL = dict(atol=1e-5, rtol=1e-4)
B, N_POINTS = 4, 48
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=32, point_num_heads=4, point_latent_dim=8,
          hidden_dim=64, num_layers=2, num_heads=4, max_seq_length=256,
          use_num_face_cond=True, checkpointing=False, point_num=N_POINTS,
          lr=1e-3, warmup_ratio=0.0, gradient_clip=0.5, nof_dropout_ratio=0.0,
          mixed_precision="no")
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
FIELDS = ("conds", "tokens", "labels", "num_faces", "lengths")
AXES = ("dp", "pp", "sp", "tp", "ep")
TINY = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "4",
        "--point_hidden_dim", "32", "--point_num_heads", "4", "--point_latent_size", "16",
        "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "48",
        "--max_seq_length", "256"]


def make_batch(L=24, ragged=True, seed=0):
    """Four rows: tokens BOS + coords + EOS, labels -100 on the condition,
    BOS and padding; rows cut to lengths that give the dp groups' halves
    different label counts (`ragged`), or all L long."""
    r = np.random.default_rng(seed)
    C = KW["num_cond_tokens"]
    lens = (L, L - 2, L - 9, L - 14) if ragged else (L,) * B
    tokens = np.zeros((B, L + 2), np.int32)
    labels = np.full((B, C + L + 2), -100, np.int32)
    for i, n in enumerate(lens):
        coords = r.integers(6, 300, n)
        tokens[i, :n + 2] = np.concatenate([[1], coords, [2]])
        labels[i, C + 1:C + n + 2] = np.concatenate([coords, [2]])
    return {"conds": r.normal(size=(B, N_POINTS, 3)).astype(np.float32),
            "tokens": tokens, "labels": labels,
            "num_faces": np.array([100, 3000, 500, 1000], np.int32),
            "lengths": np.array([C + n + 2 for n in lens], np.int32)}


@functools.lru_cache(maxsize=None)
def _params(items: tuple):
    kw = dict(items)
    jm = JLMM(Options(**kw))
    b = make_batch()
    rng = jax.random.PRNGKey(0)
    p = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                         *(jnp.asarray(b[k]) for k in FIELDS))
    p = jax.tree.map(lambda x: np.asarray(x) * 2.0, {"params": p["params"]})
    if kw.get("lora_rank"):  # adapters that move the output, so that both take gradients
        r = np.random.default_rng(1)
        p = jax.tree_util.tree_map_with_path(
            lambda kp, x: (r.normal(size=x.shape).astype(np.float32) * 0.05
                           if jax.tree_util.keystr(kp).endswith("'lora_b']") else x), p)
    return p


# options that change how a step runs, not the weights' shapes or draws
STEP_ONLY = ("checkpointing", "pp_microbatches", "moe_capacity_factor")


def params(kw: dict):
    """The JAX LMM's widened flax init for the options `kw` (cached; options
    of `STEP_ONLY` share one init)."""
    return _params(tuple(sorted((k, v) for k, v in kw.items() if k not in STEP_ONLY)))


def state(kw: dict) -> dict:
    """The same weights in the port's naming."""
    return state_dict_from_flax(params(kw))


def jax_objective(kw: dict, batch: dict, sizes: dict, microbatches: int = 0):
    """(loss, loss_moe or None, grads by port name, global norm) of the
    JAX objective on the mesh of `sizes` (axis -> size)."""
    n = [sizes.get(a, 1) for a in AXES]
    pp = n[1]
    opt = Options(**kw)
    if pp > 1:
        opt = dataclasses.replace(opt, scan_layers=True, pp_size=pp,
                                  pp_microbatches=microbatches)
    jm = JLMM(opt)
    mesh = make_mesh(n[0], n[3], n[2], pp, n[4], devices=jax.devices()[:int(np.prod(n))])
    p = params(kw)
    if pp > 1:
        p = stack_layer_params(p)
    p = jax.tree.map(lambda x, s: jax.device_put(x, s), p, param_shardings(p, mesh))
    set_sequence_parallel(mesh if n[2] > 1 else None)
    set_pipeline_parallel(mesh if pp > 1 else None, microbatches=microbatches)
    try:
        dev = _device_batch(batch, batch_sharding(mesh), sp=n[2], pad_token_id=0)

        def loss_fn(q):
            out, mut = jm.apply(q, *(dev[k] for k in FIELDS), train=False, mutable=["losses"])
            aux = jax.tree.leaves(mut)
            if not aux:
                return out["loss"], jnp.float32(0.0)
            moe = sum(jnp.sum(a) for a in aux) / sum(a.size for a in aux)
            return out["loss"] + opt.moe_aux_weight * moe, moe

        (loss, moe), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p)
    finally:
        set_sequence_parallel(None)
        set_pipeline_parallel(None)
    g = jax.tree.map(np.asarray, jax.device_get(g))
    norm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in jax.tree.leaves(g))))
    return (float(loss), float(moe) if kw.get("moe_experts") else None,
            state_dict_from_flax(g), norm)


def check_metrics(res: dict, tag: str, loss: float, loss_moe=None, norm=None):
    """The world's loss (and loss_moe, grad norm) of a run, on one rank."""
    np.testing.assert_allclose(float(res[f"{tag}/metric/loss"]), loss, **TOL)
    if loss_moe is not None:
        np.testing.assert_allclose(float(res[f"{tag}/metric/loss_moe"]), loss_moe, **TOL)
    if norm is not None:
        np.testing.assert_allclose(float(res[f"{tag}/metric/grad_norm"]), norm, **TOL)


def check_grads(res: dict, tag: str, want: dict) -> int:
    """Every gradient rank 0 gathered whole against `want` (by port name);
    returns how many were held."""
    names = [k[len(f"{tag}/grad/"):] for k in res if k.startswith(f"{tag}/grad/")]
    want = {n: g for n, g in want.items() if not n.endswith(".basis")}  # a buffer
    assert set(names) == set(want), set(names) ^ set(want)
    for n in names:
        np.testing.assert_allclose(res[f"{tag}/grad/{n}"], want[n], **TOL, err_msg=n)
    return len(names)


def check_same_replicated(ranks: list, tag: str) -> int:
    """Every parameter that no axis splits, bit-equal on every rank that
    holds it after the step; returns how many were compared."""
    seen = 0
    for r in range(1, len(ranks)):
        for key, val in ranks[r].items():
            if key.startswith(f"{tag}/own/") and key in ranks[0]:
                assert np.array_equal(val, ranks[0][key]), (r, key)
                seen += 1
    return seen

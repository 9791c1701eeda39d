"""Megatron tensor parallelism of the port (`--tp_size`) against the JAX
package's tp meshes and the port's one process, in f32 on the CPU.

One `Trainer.train_step` over gloo CPU processes (tests/
torch_layout_workers.py), each rank holding its tp share of the heads and
MLP columns and its dp group's rows of a 4-row batch, against the JAX
objective on a mesh of as many virtual devices (tests/layout_parity.py)
and the same step in one process: tp 2, dp 2 × tp 2 (tests/test_train.py
:147), LoRA at tp 2 (tests/test_lora.py:132, its lora_b drawn non-zero
so that both adapters take gradients) and tp 2 with cond_mode 'image'
(the tiny CLIP tower's heads and MLP columns split over tp, frozen as
`main default` trains it, and trained; held to the JAX image LMM's step
on one device, which a dense model gives on any mesh):

- the loss, the gradients the optimizer takes (the shards gathered whole)
  and the global norm that clipping takes;
- after the step every rank holds the same whole (replicated) weights,
  bit for bit: Megatron's f and g leave their gradients alike;
- which parameters a rank splits, and along which dimension, is what the
  JAX package's `param_shardings` gives on a tp mesh (the LMM, its LoRA
  adapters and the MDiT with its towers); a trained CLIP tower's split
  weights are no rank's whole ones, and a frozen one stays bit-unchanged;
- the MDiT's step at tp 2 (main_dit --tp_size) equals its one process;
- `main` at tp 2 writes whole tensors, which load strictly at tp 1, and
  resumes at tp 2 and at tp 1 with the same losses (residual dropout draws
  full-width masks, the same at any tp).

Tolerance: atol 1e-5, rtol 1e-4.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.models.mdit import MDiT as JMDiT
from edgerunner_tpu.parallel import make_mesh, param_shardings
from edgerunner_tpu_torch import main as tmain
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.config import parse_cli
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.models.mdit import MDiT
from edgerunner_tpu_torch.parallel import Group, tp_join, tp_slice
from edgerunner_tpu_torch.weights import (
    init_mdit_weights,
    load_state,
    mdit_state_dict_from_flax,
    read_safetensors,
    reference_state_dict,
    state_dict_from_flax,
    write_safetensors,
)
from layout_parity import (
    FIELDS,
    KW,
    TINY,
    TOL,
    check_grads,
    check_metrics,
    check_same_replicated,
    jax_objective,
    make_batch,
    params,
    state,
)
from torch_layout_workers import _trainer, layout_runs, layout_step
from torch_sp_workers import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LORA = dict(KW, lora_rank=4, lora_alpha=8.0)
# the image-conditioned ArAE: 28-pixel images in 14-pixel patches (4 + the
# class token, + the num-face token), a CLIP tower 32 wide of 4 heads
IMAGE = dict(KW, cond_mode="image", clip_image_size=28, clip_patch_size=14,
             clip_hidden_dim=32, clip_intermediate_dim=64, clip_num_layers=2,
             clip_num_heads=4, num_cond_tokens=6)
CASES = {"tp2": (KW, {"tp": 2}), "lora_tp2": (LORA, {"tp": 2}),
         "dp2xtp2": (KW, {"dp": 2, "tp": 2}),
         "image_tp2": (dict(IMAGE, freeze_encoder=True), {"tp": 2}),
         "image_tp2_trained": (dict(IMAGE, freeze_encoder=False), {"tp": 2})}
TOWER = "image_encoder."
DIT_KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
              point_hidden_dim=32, point_num_heads=4, point_latent_dim=8,
              dit_hidden_dim=32, dit_num_heads=4, dit_num_layers=2,
              clip_image_size=32, clip_patch_size=8, clip_hidden_dim=32,
              clip_num_heads=4, clip_num_layers=2, clip_intermediate_dim=64,
              hidden_dim=64, num_layers=2, num_heads=4, max_seq_length=256,
              use_num_face_cond=True, checkpointing=False, point_num=64,
              mixed_precision="no", lr=1e-3, warmup_ratio=0.0)


def dit_inputs():
    r = np.random.default_rng(4)
    batch = {"images": r.uniform(size=(4, 32, 32, 3)).astype(np.float32),
             "points": r.normal(size=(4, 64, 3)).astype(np.float32)}
    draws = {"uniform": r.uniform(size=(4, 1, 1)).astype(np.float32),
             "normal": r.normal(size=(4, 16, 8)).astype(np.float32),
             "randint": r.integers(0, 1000, 4).astype(np.int32)}
    return {"batch": batch, "draws": draws}


def dit_state():
    return {k: v.detach().numpy() for k, v in
            init_mdit_weights(MDiT(TOptions(**DIT_KW)), 3).state_dict().items()}


def main_argv(ws: str, *more) -> list:
    return ["ArAE", "--device", "cpu", "--data_root", "/nonexistent", "--synthetic_size", "4",
            "--batch_size", "2", "--num_workers", "0", *TINY, "--workspace", ws, *more]


# the image-conditioned ArAE (`default`), its CLIP tower's 4 heads split at tp 2
TINY_IMG = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
            "--clip_image_size", "28", "--clip_patch_size", "14", "--clip_hidden_dim", "32",
            "--clip_intermediate_dim", "64", "--clip_num_layers", "2", "--clip_num_heads", "4",
            "--num_cond_tokens", "5", "--point_num", "256", "--max_seq_length", "256"]


def write_tower(path: str) -> dict:
    """A random CLIP tower in HuggingFace's naming (`vision_model.*`), as
    `--resume2` takes a pretrained one: {name: array}, written to `path`."""
    opt = parse_cli(["default", *TINY_IMG])
    r = np.random.default_rng(5)
    tower = {k[len("image_encoder."):]: r.normal(size=v.shape).astype(np.float32)
             for k, v in reference_state_dict(LMM(opt)).items()
             if k.startswith("image_encoder.")}
    write_safetensors(path, tower)
    return tower


def image_batch(seed=0) -> dict:
    """`make_batch`'s rows (ragged) with 64 × 64 images in place of the
    points, resized inside the model."""
    b = make_batch(seed=seed)
    fewer = KW["num_cond_tokens"] - IMAGE["num_cond_tokens"]  # condition labels, all -100
    images = np.random.default_rng(seed + 7).uniform(size=(len(b["labels"]), 64, 64, 3))
    return {**b, "conds": images.astype(np.float32), "labels": b["labels"][:, fewer:],
            "lengths": b["lengths"] - fewer}


def batch_of(name: str) -> dict:
    return image_batch() if name.startswith("image") else make_batch()


@functools.lru_cache(maxsize=None)
def _image_params():
    """The image LMM's flax init (a frozen tower's is the same: freezing
    only stops the gradient at the tower's output)."""
    jm = JLMM(Options(**IMAGE))
    b = image_batch()
    rng = jax.random.PRNGKey(0)
    p = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                         *(jnp.asarray(b[k]) for k in FIELDS))
    return jax.tree.map(np.asarray, {"params": p["params"]})


def weights(name: str) -> dict:
    """The case's whole weights in the port's naming: the widened flax init
    of `layout_parity`, or the image LMM's flax init."""
    if name.startswith("image"):
        return state_dict_from_flax(_image_params())
    return state(CASES[name][0])


def _image_objective(freeze: bool):
    """(loss, None, grads by port name, global norm) of the JAX image LMM's
    objective on one device; a frozen tower takes no gradient there."""
    jm = JLMM(Options(**dict(IMAGE, freeze_encoder=freeze)))
    b = {k: jnp.asarray(v) for k, v in image_batch().items()}

    def loss_fn(q):
        return jm.apply(q, *(b[k] for k in FIELDS), train=False)["loss"]

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(_image_params())
    g = jax.tree.map(np.asarray, jax.device_get(g))
    norm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in jax.tree.leaves(g))))
    grads = state_dict_from_flax(g)
    if freeze:
        grads = {n: x for n, x in grads.items() if not n.startswith(TOWER)}
    return float(loss), None, grads, norm


@functools.lru_cache(maxsize=None)
def objective(name: str):
    kw, sizes = CASES[name]
    if name.startswith("image"):
        return _image_objective(kw["freeze_encoder"])
    return jax_objective(kw, make_batch(), sizes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's ranks, spawned once per world size: the 2-rank world
    also runs the MDiT at tp 2 and `main` at tp 2 (an epoch that saves,
    then a resume that runs a second, then `main default` with a CLIP tower
    through --resume2). The JAX objectives are taken while the ranks run."""
    batch = make_batch()
    tmp = tmp_path_factory.mktemp("tp")
    ws = str(tmp / "ws")
    tower_file = str(tmp / "clip_vision.safetensors")
    tower = write_tower(tower_file)
    two = [(name, kw, weights(name), batch_of(name), sizes, "arae")
           for name, (kw, sizes) in CASES.items() if len(sizes) == 1]
    two.append(("dit_tp2", DIT_KW, dit_state(), dit_inputs(), {"tp": 2}, "dit"))
    argv = [main_argv(ws, "--tp_size", "2", "--num_epochs", "1"),
            main_argv(ws + "_r", "--tp_size", "2", "--num_epochs", "2", "--resume",
                      os.path.join(ws, "ep0000", "model.safetensors"),
                      "--resume_train_state", "true"),
            ["default", "--device", "cpu", "--data_root", "/nonexistent", "--synthetic_size",
             "4", "--batch_size", "2", "--num_workers", "0", "--num_epochs", "1",
             *TINY_IMG, "--tp_size", "2", "--workspace", ws + "_img", "--resume2", tower_file]]
    four = [(name, kw, state(kw), batch, sizes, "arae") for name, (kw, sizes) in CASES.items()
            if len(sizes) == 2]
    with ThreadPoolExecutor(2) as pool:
        ranks2 = pool.submit(spawn, layout_runs, 2, tmp / "two", two, argv)
        ranks4 = pool.submit(spawn, layout_runs, 4, tmp / "four", four)
        for name in CASES:
            objective(name)
        ranks2, ranks4 = ranks2.result(), ranks4.result()
    out = {name: ranks2 if len(sizes) == 1 else ranks4 for name, (_, sizes) in CASES.items()}
    out["dit_tp2"] = ranks2
    out["ws"] = ws
    out["tower"] = tower
    return out


@pytest.fixture(scope="module")
def single():
    """Each case's step in this process, no split."""
    return {name: layout_step(_trainer(kw, weights(name), {}), batch_of(name), name)
            for name, (kw, _) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grad_norm_match_jax_and_one_process(runs, single, name):
    loss, _, _, norm = objective(name)
    check_metrics(single[name], name, loss, norm=norm)
    for res in runs[name]:
        check_metrics(res, name, loss, norm=norm)
    assert norm > KW["gradient_clip"]  # clipping is active


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_gathered_whole_match_jax_and_one_process(runs, single, name):
    _, _, grads, _ = objective(name)
    held = check_grads(runs[name][0], name, grads)
    # a frozen tower leaves the LMM its 40 gradients
    assert held == 40 if name == "image_tp2" else held > 40
    check_grads(single[name], name, grads)


@pytest.mark.parametrize("name", [*CASES, "dit_tp2"])
def test_every_rank_holds_the_same_whole_weights_after_the_step(runs, name):
    assert check_same_replicated(runs[name], name) > 10


def test_mdit_step_at_tp2_matches_one_process(runs):
    inputs = dit_inputs()
    trainer = _trainer(DIT_KW, dit_state(), {}, "dit")
    d = inputs["draws"]
    fwd = trainer.model.forward
    trainer.model.forward = lambda *a, **kw: fwd(
        *a, keep=torch.tensor(d["uniform"] >= 0.1), noise=torch.tensor(d["normal"]),
        t=torch.tensor(d["randint"]).long(), **kw)
    one = layout_step(trainer, inputs["batch"], "dit_tp2")
    res = runs["dit_tp2"][0]
    check_metrics(res, "dit_tp2", float(one["dit_tp2/metric/loss"]),
                  norm=float(one["dit_tp2/metric/grad_norm"]))
    want = {k[len("dit_tp2/grad/"):]: v for k, v in one.items() if "/grad/" in k}
    assert check_grads(res, "dit_tp2", want) > 30


def _tp_mark(x, sharding):
    """x's shape, counting 1, 2, ... along the axis that `sharding` splits
    over 'tp' (zeros if none does)."""
    axes = [i for i, a in enumerate(sharding.spec) if a is not None and "tp" in str(a)]
    if not axes:
        return np.zeros(x.shape, np.float32)
    shape = [1] * x.ndim
    shape[axes[0]] = x.shape[axes[0]]
    count = np.arange(1, x.shape[axes[0]] + 1, dtype=np.float32).reshape(shape)
    return np.broadcast_to(count, x.shape).copy()


def _split_dims(jtree, mesh, to_port) -> dict:
    """{port name: the torch dimension} of the leaves that JAX's
    `param_shardings` splits over 'tp' on `mesh`: the axis along which the
    leaf's `_tp_mark` counts after the port's conversion."""
    marks = jax.tree.map(_tp_mark, jtree, param_shardings(jtree, mesh))
    out = {}
    for n, v in to_port(marks).items():
        v = np.asarray(v)
        if n.endswith(".basis") or not v.any():  # the basis: a buffer
            continue
        (out[n],) = [d for d in range(v.ndim) if v.shape[d] > 1 and np.ptp(v, axis=d).any()]
    return out


def test_the_split_parameters_are_those_jax_param_shardings_split():
    """A model built at tp 2 splits exactly the parameters that JAX's
    `param_shardings` shards over 'tp' on a tp mesh, along the same
    dimension, each rank's shard its `tp_slice` of the whole."""
    fake = Group(None, 0, 2, False)  # construction runs no collective
    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    for kw in (KW, LORA):
        model = LMM(TOptions(**kw), tp=fake)
        split = {n: p.tp_split for n, p in model.named_parameters() if hasattr(p, "tp_split")}
        assert {n: s[0] for n, s in split.items()} == _split_dims(params(kw), mesh,
                                                                 state_dict_from_flax)
        whole = dict(LMM(TOptions(**kw)).named_parameters())
        for n, p in model.named_parameters():
            want = whole[n] if n not in split else tp_slice(whole[n], 0, 2, *split[n])
            assert p.shape == want.shape, n
    jm = JMDiT(Options(**DIT_KW))
    rng = jax.random.PRNGKey(0)
    jp = jax.tree.map(np.asarray, jax.jit(jm.init, static_argnames="train")(
        {"params": rng, "cfg": rng, "noise": rng, "time": rng},
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 64, 3)), train=True))
    dit = MDiT(TOptions(**DIT_KW), tp=fake)
    split = {n: p.tp_split[0] for n, p in dit.named_parameters() if hasattr(p, "tp_split")}
    assert split == _split_dims(jp, mesh, mdit_state_dict_from_flax)
    assert any(n.startswith("image_encoder.") for n in split)
    assert not any(".attn1." in n or ".attn2." in n for n in split)


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_tp_slice_and_join_keep_each_group_of_columns(parts):
    """A fused qkv_proj's [q | k | v] columns (3 groups) and GEGLU's
    [h | gates] (2): each rank takes its share of every group, and the
    shards join back to the whole."""
    x = torch.arange(2 * 12 * parts, dtype=torch.float32).reshape(12 * parts, 2)
    shards = [tp_slice(x, r, 2, 0, parts) for r in range(2)]
    for r, s in enumerate(shards):
        groups = x.view(parts, 12, 2)
        np.testing.assert_array_equal(s.view(parts, 6, 2), groups[:, r * 6:(r + 1) * 6])
    assert torch.equal(tp_join(shards, 0, parts), x)
    np.testing.assert_array_equal(tp_slice(x.numpy(), 1, 2, 0, parts), shards[1].numpy())


def test_an_image_tower_under_tp_is_split_as_jax_splits_it_and_frozen_bit_unchanged(runs):
    """Trained, each tower weight that JAX's `param_shardings` splits over
    tp is a rank's own shard, never among the whole ones that every rank
    holds alike, and the tower's others are; frozen, the tower is
    bit-unchanged by the step."""
    mesh = make_mesh(1, 2, devices=jax.devices()[:2])
    split = {n for n in _split_dims(_image_params(), mesh, state_dict_from_flax)
             if n.startswith(TOWER)}
    assert len(split) > 10
    own = {k[len("image_tp2_trained/own/"):] for k in runs["image_tp2_trained"][1]
           if k.startswith("image_tp2_trained/own/")}
    tower_own = {n for n in own if n.startswith(TOWER)}
    assert tower_own and not tower_own & split
    before = weights("image_tp2")
    after = {k[len("image_tp2/param/"):]: v for k, v in runs["image_tp2"][0].items()
             if k.startswith("image_tp2/param/")}
    tower = [n for n in after if n.startswith(TOWER)]
    assert len(tower) > 10
    for n in tower:
        np.testing.assert_array_equal(after[n], before[n], err_msg=n)


def test_tp2_checkpoints_load_strictly_at_tp1_and_resume(runs, tmp_path):
    ws = runs["ws"]
    saved = read_safetensors(os.path.join(ws, "ep0000", "model.safetensors"))
    assert saved["mesh_decoder.model.layers.0.self_attn.q_proj.weight"].shape == (64, 64)
    assert saved["point_encoder.cross_att.mlp.net.0.weight"].shape == (256, 32)
    load_state(LMM(TOptions(**dict(KW, point_num=48))), saved)  # strict: one file for any tp
    opt_state = torch.load(os.path.join(ws, "ep0000", "opt_state.pt"), weights_only=True)
    assert opt_state["mu"]["mesh_decoder.lm_head.weight"].shape[0] == 518
    trainer = tmain.main(main_argv(str(tmp_path / "ws1"), "--num_epochs", "2", "--resume",
                                   os.path.join(ws, "ep0000", "model.safetensors"),
                                   "--resume_train_state", "true"))
    res = runs["tp2"][0]
    assert int(res["main1/step"]) == trainer.step == 2 * len(res["main0/losses"])
    np.testing.assert_allclose(trainer.losses, res["main1/losses"], **TOL)
    np.testing.assert_array_equal(runs["tp2"][1]["main1/losses"], res["main1/losses"])


def test_resume2_tower_under_tp2_is_cut_to_the_shards_and_saved_whole(runs):
    """`main default --tp_size 2 --resume2 tower`: each rank takes its
    shares of the file's split tower entries (the q/k/v/out projections and
    fc1/fc2 of its 4 heads), so the frozen tower that trains and is saved
    (gathered whole) is the file's, bit for bit, and no entry is reported
    mismatched."""
    ws = runs["ws"] + "_img"
    assert len(runs["tp2"][0]["main2/losses"]) == 2
    saved = read_safetensors(os.path.join(ws, "model.safetensors"))
    tower = runs["tower"]
    assert "vision_model.encoder.layers.0.self_attn.q_proj.weight" in tower
    for name, w in tower.items():
        np.testing.assert_array_equal(saved["image_encoder." + name], w, err_msg=name)
    with open(os.path.join(ws, "log.txt")) as f:
        log = f.read()
    assert "merged secondary checkpoint" in log and "mismatch" not in log


def test_infer_builds_the_whole_model_whatever_tp_size():
    """infer and serve build no mesh, as the JAX ones do: --tp_size is
    ignored and the decode model is whole."""
    from edgerunner_tpu_torch.infer import load_model

    opt = TOptions(**dict(KW, tp_size=2))
    model = load_model(opt, torch.device("cpu"), dtype=torch.float32)
    assert model.mesh_decoder.model.layers[0].self_attn.q_proj.weight.shape == (64, 64)

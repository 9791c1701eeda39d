"""GPipe pipeline parallelism of the port (`--pp_size`, `--pp_microbatches`)
and the JAX package's stacked layer layout (`--scan_layers`), against the
JAX pipeline on the conftest's virtual CPU devices and the port's one
process, in f32 on the CPU.

One `Trainer.train_step` over gloo CPU processes (tests/
torch_layout_workers.py), each pp rank holding its stage of the decoder's
2 layers, against the JAX objective (tests/layout_parity.py) and the same step in
one process: pp 2 with 2 and 4 microbatches, pp 2 with gradient
checkpointing (each stage's tick replayed), dp 2 × pp 2 and pp 2 × tp 2
(tests/test_pp.py:140-320), and LoRA (`lora_rank` 4, `lora_alpha` 8) at
pp 2, its adapters split into the stages with their layers. pp 2 and
pp 2 × tp 2 are held to the JAX pipeline through `gpipe` on their meshes,
the others to one device, whose result a dense model's pipeline gives on
any mesh (LoRA: the JAX LoRA step of tests/test_torch_lora.py):

- the loss, the gradients the optimizer takes (every stage's layers
  gathered whole) and the global norm that clipping takes;
- after the step every rank holds the same whole weights outside the
  stages (the embeddings, the condition encoder, lm_head), bit for bit;
  under LoRA the base weights are bit-unchanged and every adapter moved;
- a JAX stacked (`layers_scanned`) tree loads into the port, and the
  port's stack/unstack converters match the JAX package's;
- `main` at pp 2 writes every layer whole in the per-layer naming, which
  loads strictly at pp 1; it resumes at pp 2 and at pp 1, and the loaded
  weights' held-out loss is the same at both (`--debug_eval`: residual
  dropout draws per microbatch under pp, so trained losses differ);
- the refusals: the decode paths and `main --eval_mode generate` under the
  stacked layout, `main_dit --pp_size`; MoE under dp × pp is accepted.

Tolerance: atol 1e-5, rtol 1e-4.
"""

import functools
import os
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from edgerunner_tpu.parallel import stack_layer_params as jstack
from edgerunner_tpu.parallel import unstack_layer_params as junstack
from edgerunner_tpu_torch import main as tmain
from edgerunner_tpu_torch import main_dit as tmain_dit
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.weights import (
    flax_from_state_dict,
    has_scanned_layers,
    load_state,
    normalize_layer_layout,
    read_safetensors,
    stack_layer_params,
    state_dict_from_flax,
    unstack_layer_params,
)
from layout_parity import (
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

M2 = dict(KW, pp_microbatches=2)
LORA = dict(KW, lora_rank=4, lora_alpha=8.0)
CASES = {"pp2_m2": (M2, {"pp": 2}), "pp2_m4": (dict(KW, pp_microbatches=4), {"pp": 2}),
         "pp2_remat": (dict(M2, checkpointing=True), {"pp": 2}),
         "dp2xpp2": (M2, {"dp": 2, "pp": 2}), "pp2xtp2": (M2, {"pp": 2, "tp": 2}),
         "lora_pp2": (dict(LORA, pp_microbatches=2), {"pp": 2})}
ADAPTERS = (".lora_a", ".lora_b")
# the cases held to their own JAX mesh; the others, whose dense layers give
# one device's result on any mesh, to one device (one compile for all)
ON_MESH = ("pp2_m2", "pp2xtp2")


def main_argv(ws: str, *more) -> list:
    return ["ArAE", "--device", "cpu", "--data_root", "/nonexistent", "--synthetic_size", "4",
            "--batch_size", "2", "--num_workers", "0", *TINY, "--workspace", ws, *more]


def eval_losses(ws: str) -> list:
    with open(os.path.join(ws, "log.txt")) as f:
        return [float(x) for x in re.findall(r"Eval epoch: \d+ loss: ([0-9.]+)", f.read())]


@functools.lru_cache(maxsize=None)
def _objective(name: str, lora: bool = False):
    if name not in ON_MESH:  # one device: the same weights and batch
        return jax_objective(LORA if lora else KW, make_batch(), {})
    kw, sizes = CASES[name]
    return jax_objective(kw, make_batch(), sizes, kw["pp_microbatches"])


def objective(name: str):
    """The JAX pipeline on the case's mesh, or one device (checkpointing
    and the microbatches change no value of dense layers), with LoRA's
    adapters where the case has them."""
    if name in ON_MESH:
        return _objective(name)
    return _objective("one device", "lora_rank" in CASES[name][0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's ranks, spawned once per world size, the 2-rank world
    also running `main` at pp 2: an epoch that saves, its resume for a
    second, and the saved weights' held-out loss. The JAX objectives are
    taken while the ranks run."""
    batch = make_batch()
    tmp = tmp_path_factory.mktemp("pp")
    ws = str(tmp / "ws")
    saved = os.path.join(ws, "ep0000", "model.safetensors")
    pp = ["--pp_size", "2", "--pp_microbatches", "2"]
    argv = [main_argv(ws, *pp, "--num_epochs", "1"),
            main_argv(ws + "_r", *pp, "--num_epochs", "2", "--resume", saved,
                      "--resume_train_state", "true"),
            main_argv(ws + "_e", *pp, "--num_epochs", "1", "--resume", saved,
                      "--debug_eval", "true")]
    cases = {n: (n, kw, state(kw), batch, sizes, "arae") for n, (kw, sizes) in CASES.items()}
    two = [c for n, c in cases.items() if len(CASES[n][1]) == 1]
    four = [c for n, c in cases.items() if len(CASES[n][1]) == 2]
    with ThreadPoolExecutor(2) as pool:
        ranks2 = pool.submit(spawn, layout_runs, 2, tmp / "two", two, argv)
        ranks4 = pool.submit(spawn, layout_runs, 4, tmp / "four", four)
        for name in CASES:
            objective(name)
        ranks2, ranks4 = ranks2.result(), ranks4.result()
    out = {n: ranks2 if len(sizes) == 1 else ranks4 for n, (_, sizes) in CASES.items()}
    out["ws"] = ws
    return out


@pytest.fixture(scope="module")
def single():
    """Each case's step in this process, no pipeline."""
    batch = make_batch()
    return {name: layout_step(_trainer(kw, state(kw), {}), batch, name)
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
    assert check_grads(runs[name][0], name, grads) > 40
    check_grads(single[name], name, grads)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_the_same_whole_weights_after_the_step(runs, name):
    assert check_same_replicated(runs[name], name) > 10


def test_lora_under_pp_moves_the_adapters_and_leaves_the_base_bit_unchanged(runs):
    before = state(CASES["lora_pp2"][0])
    after = {k[len("lora_pp2/param/"):]: v for k, v in runs["lora_pp2"][0].items()
             if k.startswith("lora_pp2/param/")}
    adapters = [n for n in after if n.endswith(ADAPTERS)]
    assert len(adapters) > 8 and {n.split(".")[3] for n in adapters
                                  if ".layers." in n} == {"0", "1"}
    for n, v in after.items():
        if n.endswith(ADAPTERS):
            assert not np.array_equal(v, before[n]), n
        else:
            np.testing.assert_array_equal(v, before[n], err_msg=n)


def test_each_stage_holds_its_layers_under_their_global_names():
    from edgerunner_tpu_torch.parallel import PipelineParallel

    names = []
    for p in range(2):
        stage = PipelineParallel(None, p, 2, False, microbatches=2)
        model = LMM(TOptions(**dict(KW, num_layers=4)), pp=stage)
        names.append({n.split(".")[3] for n, _ in model.named_parameters()
                      if n.startswith("mesh_decoder.model.layers.")})
    assert names == [{"0", "1"}, {"2", "3"}]


def test_stack_and_unstack_match_the_jax_converters():
    p = params(KW)
    stacked = stack_layer_params(p)
    jax.tree.map(np.testing.assert_array_equal, stacked, jstack(p))
    assert has_scanned_layers(stacked) and not has_scanned_layers(p)
    q = stacked["params"]["mesh_decoder"]["model"]["layers_scanned"]["layer"]
    assert q["self_attn"]["q_proj"]["kernel"].shape == (2, 64, 64)
    jax.tree.map(np.testing.assert_array_equal, unstack_layer_params(stacked), p)
    jax.tree.map(np.testing.assert_array_equal, junstack(stacked), p)
    assert normalize_layer_layout(p, False) is p
    assert normalize_layer_layout(stacked, True) is stacked
    # the point encoder's subtree is not restacked
    jax.tree.map(np.testing.assert_array_equal, stacked["params"]["point_encoder"],
                 p["params"]["point_encoder"])


def test_a_jax_stacked_tree_loads_into_the_port_and_back():
    p = params(KW)
    sd = state_dict_from_flax(p)
    from_stacked = state_dict_from_flax(jstack(p))
    assert set(from_stacked) == set(sd)
    for n in sd:
        np.testing.assert_array_equal(from_stacked[n], sd[n])
    load_state(LMM(TOptions(**KW)), from_stacked)  # strict
    back = flax_from_state_dict(sd, scan_layers=True)
    jax.tree.map(np.testing.assert_array_equal, back["params"]["mesh_decoder"],
                 jstack(p)["params"]["mesh_decoder"])


def test_pp2_checkpoints_load_strictly_at_pp1_and_resume(runs, tmp_path):
    ws = runs["ws"]
    saved = os.path.join(ws, "ep0000", "model.safetensors")
    state_ = read_safetensors(saved)
    assert {n.split(".")[3] for n in state_ if n.startswith("mesh_decoder.model.layers.")} \
        == {"0", "1"}
    load_state(LMM(TOptions(**KW)), state_)  # strict: one file for any pp
    opt_state = torch.load(os.path.join(ws, "ep0000", "opt_state.pt"), weights_only=True)
    assert set(opt_state["mu"]) == set(state_) - {"point_encoder.point_embed.basis"}
    res = runs["pp2_m2"][0]
    trainer = tmain.main(main_argv(str(tmp_path / "r"), "--num_epochs", "2", "--resume", saved,
                                   "--resume_train_state", "true"))
    assert int(res["main1/step"]) == trainer.step == 2 * len(res["main0/losses"])
    assert np.isfinite(trainer.losses).all() and np.isfinite(res["main1/losses"]).all()
    np.testing.assert_array_equal(runs["pp2_m2"][1]["main1/losses"], res["main1/losses"])
    tmain.main(main_argv(str(tmp_path / "e"), "--num_epochs", "1", "--resume", saved,
                         "--debug_eval", "true"))
    got, want = eval_losses(ws + "_e"), eval_losses(str(tmp_path / "e"))
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, atol=2e-6)  # the log's 6 decimals


def test_the_stacked_layout_is_refused_where_the_jax_package_refuses_it(monkeypatch, tmp_path):
    from edgerunner_tpu_torch.infer import load_model

    for change in (dict(scan_layers=True), dict(pp_size=2)):
        with pytest.raises(ValueError, match="per-layer decoder layout"):
            load_model(TOptions(**dict(KW, **change)), torch.device("cpu"))
    with pytest.raises(ValueError, match="per-layer decoder layout"):
        tmain.main(main_argv(str(tmp_path / "g"), "--pp_size", "2", "--eval_mode", "generate"))
    with pytest.raises(ValueError, match="--pp_size"):
        tmain_dit.main(["DiT", "--device", "cpu", "--pp_size", "2"])
    # MoE under dp x pp is accepted (dp -1 takes world / pp = 2 here): main
    # gets past validate and the layout's checks to joining the world
    from edgerunner_tpu_torch.train import ranks

    class Joined(Exception):
        pass

    def join(device):
        raise Joined

    monkeypatch.setattr(ranks, "init_distributed", join)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(Joined):
        tmain.main(main_argv(str(tmp_path / "m"), "--pp_size", "2", "--moe_experts", "4"))

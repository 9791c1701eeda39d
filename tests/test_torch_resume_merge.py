"""`--resume` in the port's `main`, `infer` and `serve` (which loads through
`infer.load_model`) merged over the seed's weights as the JAX package merges
it (edgerunner_tpu/train/checkpoint.py `tolerant_merge`, taken by its
main.py and `load_params_for_inference`), on the CPU at a tiny width:

* a JAX image LMM exported by tools/export_reference_ckpt.py:export_lmm,
  which writes no `image_encoder.*`, loads through `infer default --resume`
  with its tower from `--resume2`, and generates;
* a checkpoint whose position table is shorter is realigned at either end
  (`--align_posemb`), entry by entry as the JAX package's merge realigns
  the same numpy arrays;
* missing and unexpected entries are logged, by `main` into its log and by
  `infer` on stdout, and a missing entry keeps the seed's value;
* `load_state`, the parity tests' exact crossover, stays strict.
"""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.train.checkpoint import init_lmm_params
from edgerunner_tpu.train.checkpoint import tolerant_merge as jax_tolerant_merge
from edgerunner_tpu_torch import infer, main
from edgerunner_tpu_torch.config import parse_cli
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.weights import (
    load_state,
    read_safetensors,
    reference_state_dict,
    state_dict_from_flax,
    tolerant_merge,
    write_safetensors,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
        "--clip_image_size", "28", "--clip_patch_size", "14", "--clip_hidden_dim", "32",
        "--clip_intermediate_dim", "64", "--clip_num_layers", "2", "--clip_num_heads", "4",
        "--num_cond_tokens", "5", "--point_num", "256", "--max_seq_length", "256",
        "--num_workers", "0", "--seed", "3"]
POS = "mesh_decoder.model.embed_positions.weight"


def _export_lmm():
    spec = importlib.util.spec_from_file_location(
        "export_reference_ckpt", os.path.join(ROOT, "tools", "export_reference_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.export_lmm


@pytest.fixture(scope="module")
def image_lmm():
    """(the port's options, the JAX package's flax params as numpy) of a
    tiny image-conditioned LMM, initialised by the JAX package itself."""
    opt = parse_cli(["default", *TINY])
    jopt = Options(**{f.name: getattr(opt, f.name) for f in dataclasses.fields(Options)
                      if hasattr(opt, f.name)})
    params = init_lmm_params(JLMM(jopt), jopt, jax.random.PRNGKey(7))
    return opt, jax.tree.map(np.asarray, params)


def _png(path):
    from PIL import Image

    img = np.zeros((40, 40, 4), np.uint8)
    img[10:30, 8:32] = (60, 90, 30, 255)
    Image.fromarray(img).save(path)


def test_a_towerless_export_loads_through_infer_with_the_tower_from_resume2(
        image_lmm, tmp_path, capsys):
    opt, params = image_lmm
    want = state_dict_from_flax(params)
    export = _export_lmm()(params)
    assert not any(k.startswith("image_encoder.") for k in export)
    resume = str(tmp_path / "export.safetensors")
    write_safetensors(resume, export)
    # the tower in HuggingFace CLIPVisionModel's naming, as --resume2 takes it
    tower = str(tmp_path / "clip_vision.safetensors")
    write_safetensors(tower, {k[len("image_encoder."):]: v for k, v in want.items()
                              if k.startswith("image_encoder.")})
    run = dataclasses.replace(opt, resume=resume)
    model = infer.load_model(run, torch.device("cpu"), dtype=torch.float32, overlay=tower)
    got = reference_state_dict(model)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    log = capsys.readouterr().out
    tower_names = [k for k in want if k.startswith("image_encoder.")]
    assert sum("[ckpt] missing param image_encoder." in ln for ln in log.splitlines()) \
        == len(tower_names)
    # and the CLI generates from them
    image = str(tmp_path / "chair.png")
    _png(image)
    out = str(tmp_path / "out")
    infer.main(["default", "--device", "cpu", "--resume", resume, "--resume2", tower,
                "--test_path", image, "--workspace", out, "--test_max_seq_length", "64",
                "--decode_bucket", "64", "--generate_mode", "greedy", *TINY])
    assert os.path.exists(os.path.join(out, "chair_0_tokens.npy"))


@pytest.mark.parametrize("align", ["left", "right"])
def test_a_shorter_position_table_is_realigned_as_the_jax_merge_does(image_lmm, align,
                                                                      tmp_path, capsys):
    opt, params = image_lmm
    r = np.random.default_rng(11)
    ckpt = jax.tree.map(lambda x: (x + r.normal(size=x.shape)).astype(x.dtype), params)
    table = ckpt["params"]["mesh_decoder"]["model"]["embed_positions"]["embedding"]
    short = table.shape[0] - 37
    ckpt["params"]["mesh_decoder"]["model"]["embed_positions"]["embedding"] = (
        table[:short] if align == "left" else table[-short:])
    jlog, tlog = [], []
    theirs = state_dict_from_flax(jax.tree.map(np.asarray, jax_tolerant_merge(
        params, ckpt, align_posemb=align, log=jlog.append)))
    ours = tolerant_merge(state_dict_from_flax(params), state_dict_from_flax(ckpt),
                          align_posemb=align, log=tlog.append)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert [ln.split("(")[0] for ln in jlog] == [ln.split("(")[0] for ln in tlog]
    assert len(tlog) == 1 and "realigning position embeddings" in tlog[0]
    # through the CLI's loader: the file's rows at that end of the seed's table
    resume = str(tmp_path / "short.safetensors")
    write_safetensors(resume, state_dict_from_flax(ckpt))
    run = dataclasses.replace(opt, resume=resume, align_posemb=align)
    got = reference_state_dict(infer.load_model(run, torch.device("cpu"), dtype=torch.float32))
    seeded = reference_state_dict(init_weights(LMM(run), run.seed))[POS]
    want = seeded.copy()
    if align == "left":
        want[:short] = table[:short]
    else:
        want[-short:] = table[-short:]
    np.testing.assert_array_equal(got[POS], want)
    assert "realigning position embeddings" in capsys.readouterr().out


def test_main_logs_missing_and_unexpected_entries_and_keeps_the_seed(tmp_path):
    """`main --resume` of a file without one entry and with one that the
    model lacks: both are logged, the missing one keeps the seed's value,
    and every other entry is the file's (no training: --debug_eval)."""
    argv = ["ArAE", "--device", "cpu", "--data_root", "/nonexistent", "--synthetic_size", "4",
            "--batch_size", "2", "--num_epochs", "1", "--debug_eval", "true",
            "--eval_mode", "none", "--hidden_dim", "64", "--num_layers", "2",
            "--num_heads", "2", "--point_hidden_dim", "64", "--point_num_heads", "2",
            "--point_latent_size", "16", "--point_latent_dim", "8", "--num_cond_tokens", "17",
            "--point_num", "64", "--max_seq_length", "256", "--num_workers", "0"]
    opt = parse_cli(argv[:1] + argv[3:])
    src = reference_state_dict(init_weights(LMM(opt), seed=5))
    gone = "proj_cond.bias"
    assert gone in src
    state = {k: v for k, v in src.items() if k != gone}
    state["mesh_decoder.extra.weight"] = np.ones(3, np.float32)
    resume = str(tmp_path / "partial.safetensors")
    write_safetensors(resume, state)
    ws = str(tmp_path / "ws")
    trainer = main.main([*argv, "--workspace", ws, "--resume", resume])
    got = reference_state_dict(trainer.model)
    seeded = reference_state_dict(init_weights(LMM(opt), opt.seed))
    for k in src:
        np.testing.assert_array_equal(got[k], seeded[k] if k == gone else src[k], err_msg=k)
    with open(os.path.join(ws, "log.txt")) as f:
        log = f.read()
    assert f"[ckpt] missing param {gone}: keeping init" in log
    assert "[ckpt] unexpected param mesh_decoder.extra.weight" in log


def test_load_state_stays_strict(tmp_path):
    opt = parse_cli(["default", *TINY])
    model = LMM(opt)
    sd = reference_state_dict(model)
    with pytest.raises(RuntimeError):
        load_state(model, {k: v for k, v in sd.items() if k != POS})
    with pytest.raises(RuntimeError):
        load_state(model, {**sd, "extra.weight": np.zeros(3, np.float32)})
    path = str(tmp_path / "all.safetensors")
    write_safetensors(path, sd)
    load_state(LMM(opt), read_safetensors(path))

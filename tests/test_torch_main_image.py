"""The image-conditioned ArAE (the `default` preset) through the port's CLIs
on the CPU, at a tiny width: `main default` trains an epoch on synthetic
meshes with point-splat renders, with a CLIP tower overlaid from a
HuggingFace-named file (`--resume2`) that stays frozen and is saved with
the rest; `infer default` generates from a PNG with that checkpoint; `infer`
runs without a condition (cond_mode 'none'); the server refuses image mode,
whose request body the JAX server lacks; and without a card both CLIs
refuse to run unless asked for the CPU."""

import os

import numpy as np
import pytest
import torch

from edgerunner_tpu_torch import infer, main, serve
from edgerunner_tpu_torch.config import parse_cli
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.weights import read_safetensors, reference_state_dict, write_safetensors
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
        "--clip_image_size", "28", "--clip_patch_size", "14", "--clip_hidden_dim", "32",
        "--clip_intermediate_dim", "64", "--clip_num_layers", "2", "--clip_num_heads", "4",
        "--num_cond_tokens", "5", "--point_num", "256", "--max_seq_length", "256",
        "--num_workers", "2", "--seed", "1"]
TRAIN = ["default", "--device", "cpu", "--data_root", "/nonexistent", "--batch_size", "2",
         "--synthetic_size", "8", "--num_epochs", "1", "--lr", "1e-3", "--warmup_ratio", "0.1",
         *TINY]


def _png(path):
    """A 40 x 40 RGBA image: a dark square on a transparent background."""
    from PIL import Image

    img = np.zeros((40, 40, 4), np.uint8)
    img[10:30, 8:32] = (60, 90, 30, 255)
    Image.fromarray(img).save(path)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One epoch of `main default` with a random tower in HuggingFace's
    naming overlaid through --resume2."""
    root = tmp_path_factory.mktemp("image_main")
    opt = parse_cli(TRAIN[:1] + TINY)
    r = np.random.default_rng(4)
    tower = {k[len("image_encoder."):]: r.normal(size=v.shape).astype(np.float32)
             for k, v in reference_state_dict(LMM(opt)).items()
             if k.startswith("image_encoder.")}
    tower_file = str(root / "clip_vision.safetensors")
    write_safetensors(tower_file, tower)
    ws = str(root / "ws")
    trainer = main.main([*TRAIN, "--workspace", ws, "--resume2", tower_file])
    return ws, trainer, tower, tower_file


def test_main_default_trains_and_saves_the_frozen_tower(run):
    ws, trainer, tower, _ = run
    assert len(trainer.losses) == 4 and all(np.isfinite(trainer.losses))
    assert not any(n.startswith("image_encoder.") for n in trainer.params)
    saved = read_safetensors(os.path.join(ws, "model.safetensors"))
    assert saved.keys() == set(trainer.model.state_dict())
    # the overlaid tower, bit-unchanged by training, is in the checkpoint
    for name, w in tower.items():
        assert np.array_equal(saved["image_encoder." + name], w), name
    seeded = reference_state_dict(init_weights(LMM(trainer.opt), trainer.opt.seed))
    moved = [k for k in trainer.params if not np.array_equal(saved[k], seeded[k])]
    assert len(moved) == len(trainer.params)
    with open(os.path.join(ws, "log.txt")) as f:
        log = f.read()
    assert "merged secondary checkpoint" in log and "missing param mesh_decoder" in log


def test_infer_default_generates_from_a_png(run, tmp_path):
    ws, trainer, tower, tower_file = run
    image = str(tmp_path / "chair.png")
    _png(image)
    out = str(tmp_path / "out")
    infer.main(["default", "--device", "cpu", "--resume", os.path.join(ws, "model.safetensors"),
                "--resume2", tower_file, "--test_path", image, "--workspace", out,
                "--test_max_seq_length", "64", "--decode_bucket", "64",
                "--generate_mode", "greedy", *TINY])
    tokens = np.load(os.path.join(out, "chair_0_tokens.npy"))
    assert os.path.exists(os.path.join(out, "chair_0.ply")) and 0 < len(tokens) <= 64
    assert not os.path.exists(os.path.join(out, "chair_pc.obj"))  # point mode only
    # the image, read once, then the generation alone: the same stream
    opt = parse_cli(["default", "--resume", os.path.join(ws, "model.safetensors"),
                     "--workspace", str(tmp_path / "again"), "--test_max_seq_length", "64",
                     "--decode_bucket", "64", "--generate_mode", "greedy", *TINY])
    cond = infer.prepare_cond(opt, image, np.random.default_rng(opt.seed))
    assert cond.shape == (1, 512, 512, 3) and cond.dtype == np.float32
    model = infer.load_model(opt, torch.device("cpu"), overlay=tower_file)
    written = infer.generate_meshes(opt, model, None, "chair", cond,
                                    torch.Generator().manual_seed(opt.seed))
    assert [os.path.basename(p) for p in written] == ["chair_0.ply"]
    assert np.array_equal(np.load(str(tmp_path / "again" / "chair_0_tokens.npy")), tokens)


def test_infer_without_a_condition(tmp_path):
    """cond_mode 'none': no input is read; the stream starts from BOS alone."""
    out = str(tmp_path / "out")
    infer.main(["default", "--device", "cpu", "--cond_mode", "none",
                "--test_path", str(tmp_path / "unconditioned"), "--workspace", out,
                "--test_max_seq_length", "64", "--decode_bucket", "64",
                "--generate_mode", "greedy", *TINY])
    assert os.path.exists(os.path.join(out, "unconditioned_0.ply"))
    assert len(np.load(os.path.join(out, "unconditioned_0_tokens.npy"))) > 0


def test_server_refuses_image_mode():
    with pytest.raises(ValueError, match="no image request body"):
        serve.main(["default", "--device", "cpu", *TINY])
    with pytest.raises(ValueError, match="no image request body"):
        serve.build_server(parse_cli(["default", *TINY]), device="cpu")


def test_without_a_card_or_device_cpu_both_clis_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main.main(["default", "--workspace", str(tmp_path), *TINY])
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer.main(["default", "--test_path", str(tmp_path / "x.png"), *TINY])

"""The port's DiT training CLI end to end on the CPU at a tiny width: two
epochs on synthetic data (with the EMA and the held-out loss) write MDiT
checkpoints that the image-to-mesh CLI loads strictly; an ArAE checkpoint
given with `--resume` gives the frozen point encoder its weights exactly;
a run resumed from the first epoch's checkpoint with `--resume_train_state`
takes the uninterrupted run's steps, to the bit, its EMA included; and
without a card the CLI refuses to run unless asked for the CPU."""

import os

import numpy as np
import pytest
import torch

from edgerunner_tpu_torch import infer_dit, main_dit
from edgerunner_tpu_torch.config import Options
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.train.checkpoint import find_train_state
from edgerunner_tpu_torch.weights import (
    read_safetensors,
    reference_state_dict,
    write_safetensors,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
          "--point_hidden_dim", "32", "--point_num_heads", "4", "--point_latent_size", "16",
          "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "64",
          "--dit_hidden_dim", "32", "--dit_num_heads", "4", "--dit_num_layers", "2",
          "--clip_image_size", "32", "--clip_patch_size", "8", "--clip_hidden_dim", "32",
          "--clip_num_heads", "4", "--clip_num_layers", "2", "--clip_intermediate_dim", "64",
          "--max_seq_length", "256"]
TRAIN = ["DiT", "--device", "cpu", "--data_root", "/nonexistent", "--batch_size", "2",
         "--synthetic_size", "8", "--num_epochs", "2", "--lr", "1e-3", "--warmup_ratio", "0.1",
         "--num_workers", "2", "--seed", "1", "--eval_mode", "loss", "--ema_decay", "0.9",
         *WIDTHS]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws_dit"))
    return ws, main_dit.main([*TRAIN, "--workspace", ws])


def test_two_epochs_write_checkpoints_that_infer_dit_loads(run, tmp_path):
    from PIL import Image

    ws, trainer = run
    assert len(trainer.losses) == 8 and all(np.isfinite(trainer.losses))
    latest = os.path.join(ws, "model.safetensors")
    assert os.path.realpath(latest) == os.path.join(ws, "ep0001", "model.safetensors")
    for name in ("ep0000", "ep0001"):
        for f in ("model.safetensors", "ema.safetensors", "opt_state.pt", "train_state.json"):
            assert os.path.exists(os.path.join(ws, name, f)), (name, f)
    state = find_train_state(latest)
    assert state["step"] == 8 and state["loader"] == {"epoch": 2, "batch_in_epoch": 0}
    weights = read_safetensors(latest)
    for name, t in trainer.model.state_dict().items():
        assert np.array_equal(weights[name], t.numpy()), name
    ema = read_safetensors(os.path.join(ws, "ema.safetensors"))
    for name, t in trainer.ema.items():
        assert np.array_equal(ema[name], t.numpy()), name
    with open(os.path.join(ws, "log.txt")) as f:
        log = f.read()
    assert "Eval epoch: 1 loss" in log and "Eval epoch: 1 (ema) loss" in log

    img = str(tmp_path / "shape.png")
    rgba = np.zeros((48, 48, 4), np.uint8)
    rgba[10:38, 14:34] = (200, 80, 40, 255)
    Image.fromarray(rgba).save(img)
    out = str(tmp_path / "out")
    for resume2 in (latest, os.path.join(ws, "ema.safetensors")):
        infer_dit.main(["ArAE", "--device", "cpu", "--test_path", img, "--workspace", out,
                        "--resume2", resume2, "--decode_bucket", "64", "--test_num_face", "20",
                        "--generate_mode", "greedy", *WIDTHS])
        assert os.path.exists(os.path.join(out, "shape_0_20f.obj"))


def test_resume_gives_the_point_encoder_of_an_arae_checkpoint(tmp_path):
    opt = Options(cond_mode="point", point_hidden_dim=32, point_num_heads=4,
                  point_latent_size=16, point_latent_dim=8, num_cond_tokens=17, point_num=64,
                  hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=256,
                  use_num_face_cond=True)
    arae = reference_state_dict(init_weights(LMM(opt), 7))
    path = str(tmp_path / "arae.safetensors")
    write_safetensors(path, arae)
    trainer = main_dit.main([*TRAIN, "--workspace", str(tmp_path / "ws"), "--resume", path,
                             "--num_epochs", "1", "--eval_mode", "none"])
    got = trainer.model.state_dict()
    enc = [k for k in arae if k.startswith("point_encoder.")]
    assert len(enc) > 10
    for k in enc:
        assert np.array_equal(got[k].numpy(), arae[k]), k
    # the LMM's own condition projection has other shapes: kept at init
    assert got["proj_cond.weight"].shape != arae["proj_cond.weight"].shape
    with open(os.path.join(str(tmp_path / "ws"), "log.txt")) as f:
        log = f.read()
    assert "shape mismatch for proj_cond.weight" in log
    assert "unexpected param mesh_decoder." in log


def test_resume_train_state_continues_exactly(run, tmp_path):
    ws, trainer = run
    resumed = main_dit.main([*TRAIN, "--workspace", str(tmp_path / "resumed"), "--resume2",
                             os.path.join(ws, "ep0000", "model.safetensors"),
                             "--resume_train_state"])
    assert resumed.step == trainer.step == 8
    assert resumed.losses == trainer.losses[4:]
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for name, e in trainer.ema.items():
        assert torch.equal(resumed.ema[name], e), name


def test_main_dit_refuses_what_it_does_not_run(tmp_path):
    with pytest.raises(ValueError, match="sp_size"):
        main_dit.main([*TRAIN, "--workspace", str(tmp_path), "--sp_size", "2"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_dit.main(["DiT", "--workspace", str(tmp_path), *WIDTHS])

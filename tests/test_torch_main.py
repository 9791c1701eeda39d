"""The port's training CLI end to end on the CPU at a tiny width: two epochs on
synthetic data write checkpoints that the port's inference CLI loads, a run
resumed from the first epoch's checkpoint takes the same steps as the
uninterrupted run, and without a card the CLI refuses to run unless asked
for the CPU."""

import os

import numpy as np
import pytest
import torch

from edgerunner_tpu_torch import infer, main
from edgerunner_tpu_torch.data import save_mesh_file
from edgerunner_tpu_torch.data._procgen import icosphere
from edgerunner_tpu_torch.train.checkpoint import find_train_state
from edgerunner_tpu_torch.weights import (
    flax_from_state_dict,
    read_safetensors,
    state_dict_from_flax,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
        "--point_hidden_dim", "64", "--point_num_heads", "2", "--point_latent_size", "16",
        "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "64",
        "--max_seq_length", "256", "--num_workers", "2", "--seed", "1"]
TRAIN = ["ArAE", "--device", "cpu", "--data_root", "/nonexistent", "--batch_size", "2",
         "--synthetic_size", "8", "--num_epochs", "2", "--lr", "1e-3", "--warmup_ratio", "0.1",
         *TINY]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws"))
    return ws, main.main([*TRAIN, "--workspace", ws])


def test_two_epochs_write_checkpoints_that_infer_loads(run, tmp_path):
    ws, trainer = run
    assert len(trainer.losses) == 8 and all(np.isfinite(trainer.losses))
    latest = os.path.join(ws, "model.safetensors")
    assert os.path.realpath(latest) == os.path.join(ws, "ep0001", "model.safetensors")
    for name in ("ep0000", "ep0001", "best"):
        assert os.path.exists(os.path.join(ws, name, "model.safetensors"))
    assert os.path.exists(os.path.join(ws, "test_ep1_gt.obj"))
    state = find_train_state(latest)
    assert state["step"] == 8 and state["loader"] == {"epoch": 2, "batch_in_epoch": 0}
    assert state["opt_state_path"].endswith(os.path.join("ep0001", "opt_state.pt"))

    weights = read_safetensors(latest)
    model = trainer.model
    for name, t in model.state_dict().items():
        assert np.array_equal(weights[name], t.numpy()), name
    # the reference naming carries across to the JAX package's tree and back
    back = state_dict_from_flax(flax_from_state_dict(weights))
    assert back.keys() == weights.keys()
    for name in weights:
        assert np.array_equal(back[name], weights[name]), name

    mesh = str(tmp_path / "sphere.obj")
    save_mesh_file(mesh, *(np.asarray(x) for x in icosphere(1)))
    out = str(tmp_path / "out")
    infer.main(["ArAE", "--device", "cpu", "--resume", latest, "--test_path", mesh,
                "--workspace", out, "--test_max_seq_length", "64", "--decode_bucket", "64",
                "--generate_mode", "greedy", *TINY])
    assert os.path.exists(os.path.join(out, "sphere_0_1000f_tokens.npy"))


def test_resumed_run_takes_the_same_steps(run, tmp_path):
    ws, trainer = run
    resumed = main.main([*TRAIN, "--workspace", str(tmp_path / "resumed"), "--resume",
                         os.path.join(ws, "ep0000", "model.safetensors"),
                         "--resume_train_state"])
    assert resumed.step == trainer.step == 8
    assert resumed.losses == trainer.losses[4:]
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_without_a_card_or_device_cpu_it_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main.main(["ArAE", "--workspace", str(tmp_path), *TINY])

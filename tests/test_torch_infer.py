"""The port's inference CLI end to end on the CPU at a tiny width: a mesh
file in, point sampling, generation, detokenisation, a .ply and the tokens
out; with --resume the weights come from a reference-format .safetensors."""

import os

import numpy as np
import torch

from edgerunner_tpu_torch import infer
from edgerunner_tpu_torch.config import parse_cli
from edgerunner_tpu_torch.data import load_mesh, save_mesh_file

TINY = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
        "--point_hidden_dim", "64", "--point_num_heads", "2", "--point_latent_size", "16",
        "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "64",
        "--max_seq_length", "256", "--decode_bucket", "64", "--generate_mode", "greedy",
        "--test_num_face", "20", "--test_repeat", "2", "--test_batch_size", "2"]


def _cube(path):
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float64)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    save_mesh_file(path, v, f)


def test_infer_cli_on_cpu_with_seeded_and_loaded_weights(tmp_path):
    from safetensors.torch import save_file

    mesh = str(tmp_path / "cube.obj")
    _cube(mesh)
    ws = str(tmp_path / "out")
    infer.main(["ArAE", "--device", "cpu", "--test_path", mesh, "--workspace", ws, *TINY])
    names = sorted(os.listdir(ws))
    assert names == ["cube_0_20f.ply", "cube_0_20f_tokens.npy", "cube_1_20f.ply",
                     "cube_1_20f_tokens.npy", "cube_pc.obj"]
    pts, _ = load_mesh(os.path.join(ws, "cube_pc.obj"))
    assert pts.shape == (64, 3) and np.abs(pts).max() <= 0.95 + 1e-6
    seeded = np.load(os.path.join(ws, "cube_0_20f_tokens.npy"))
    assert seeded.size > 0

    opt = parse_cli(["ArAE", *TINY])
    model = infer.load_model(opt, torch.device("cpu"), dtype=torch.float32)
    ckpt = str(tmp_path / "w.safetensors")
    save_file({k: v.contiguous() for k, v in model.state_dict().items()}, ckpt)
    ws2 = str(tmp_path / "out2")
    infer.main(["ArAE", "--device", "cpu", "--test_path", mesh, "--workspace", ws2,
                "--resume", ckpt, *TINY])
    loaded = np.load(os.path.join(ws2, "cube_0_20f_tokens.npy"))
    assert loaded.size > 0 and loaded.min() >= 0

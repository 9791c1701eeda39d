"""The port's training entry points under data parallelism, on the CPU over
2 gloo processes (tests/torch_sp_workers.py `spawn`,
tests/torch_dp_workers.py `entry_run`), on a folder of procedural meshes:

- `main ArAE --dp_size 2`: each rank trains on its own shard of the folder's
  items, disjoint from the other's and equal in count; rank 0 alone writes
  the checkpoints; the ranks end with equal parameters; a run resumed with
  `--resume_train_state` from the first epoch's checkpoint, launched with
  `--dp_size -1` (world / sp = 2), repeats the uninterrupted run's second
  epoch exactly on both ranks;
- `main_dit DiT --dp_size 2` takes its steps on both ranks, equal;
- a dp × sp other than the world raises, naming torchrun; `dp_for_world`
  takes world / sp for -1;
- the port's `shard_items_for_host` agrees with the JAX package's.
"""

import os

import numpy as np
import pytest

from edgerunner_tpu.data.dataset import shard_items_for_host as jax_shard
from edgerunner_tpu_torch import main, main_dit
from edgerunner_tpu_torch.data import save_mesh_file
from edgerunner_tpu_torch.data._procgen import icosphere
from edgerunner_tpu_torch.data.dataset import shard_items_for_host
from edgerunner_tpu_torch.parallel import dp_for_world
from torch_dp_workers import entry_run
from torch_sp_workers import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MESHES = 11  # 9 for training (--testset_size 2): shards of 4, one item left out
WIDTHS = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
          "--point_hidden_dim", "32", "--point_num_heads", "4", "--point_latent_size", "16",
          "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "64",
          "--max_seq_length", "256", "--num_workers", "2", "--seed", "1",
          "--testset_size", "2", "--batch_size", "2"]
DIT_WIDTHS = ["--dit_hidden_dim", "32", "--dit_num_heads", "4", "--dit_num_layers", "2",
              "--clip_image_size", "32", "--clip_patch_size", "8", "--clip_hidden_dim", "32",
              "--clip_num_heads", "4", "--clip_num_layers", "2",
              "--clip_intermediate_dim", "64"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """MESHES jittered icospheres of 20 faces, each its own .obj."""
    root = tmp_path_factory.mktemp("meshes")
    v, f = icosphere(0)
    r = np.random.default_rng(0)
    for i in range(MESHES):
        save_mesh_file(str(root / f"m{i:02d}.obj"), v * r.uniform(0.5, 1.0, 3)
                       + r.normal(0, 0.05, v.shape), f)
    return str(root)


def train_argv(data_root, ws, *more):
    return ["ArAE", "--device", "cpu", "--data_root", data_root, "--workspace", ws,
            "--num_epochs", "2", "--lr", "1e-3", "--warmup_ratio", "0.1", *WIDTHS, *more]


@pytest.fixture(scope="module")
def dp_main(data_root, tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws"))
    ranks = spawn(entry_run, 2, tmp_path_factory.mktemp("run"), "main",
                  train_argv(data_root, ws, "--dp_size", "2"))
    return ws, ranks


def test_dp_main_shards_the_items_disjoint_and_equal(dp_main, data_root):
    _, (r0, r1) = dp_main
    a, b = set(r0["items"].tolist()), set(r1["items"].tolist())
    assert len(a) == len(b) == (MESHES - 2) // 2 and not a & b
    assert all(os.path.dirname(p) == data_root for p in a | b)
    assert int(r0["dp_size"]) == int(r1["dp_size"]) == 2


def test_dp_main_writes_once_and_leaves_equal_parameters(dp_main):
    ws, (r0, r1) = dp_main
    assert int(r0["writes"]) == 2 and int(r1["writes"]) == 0
    for name in ("ep0000", "ep0001", "best"):
        assert os.path.exists(os.path.join(ws, name, "model.safetensors"))
    # 2 steps an epoch: 4 items of a shard in batches of 2
    assert len(r0["losses"]) == 4 and np.array_equal(r0["losses"], r1["losses"])
    assert all(np.isfinite(r0["losses"]))
    params = [k for k in r0 if k.startswith("param/")]
    assert params
    for k in params:
        assert np.array_equal(r0[k], r1[k]), k


def test_dp_resume_with_dp_size_minus_one_repeats_the_run(dp_main, data_root, tmp_path):
    ws, (r0, _) = dp_main
    resumed = spawn(entry_run, 2, tmp_path / "run", "main", train_argv(
        data_root, str(tmp_path / "resumed"), "--dp_size", "-1", "--resume",
        os.path.join(ws, "ep0000", "model.safetensors"), "--resume_train_state"))
    for res in resumed:
        assert int(res["dp_size"]) == 2
        assert res["losses"].tolist() == r0["losses"][2:].tolist()
        for k in res:
            if k.startswith("param/"):
                assert np.array_equal(res[k], r0[k]), k


def test_main_dit_dp_takes_its_steps(data_root, tmp_path):
    argv = ["DiT", "--device", "cpu", "--data_root", data_root, "--workspace",
            str(tmp_path / "ws"), "--num_epochs", "1", "--lr", "1e-3", "--dp_size", "2",
            *WIDTHS, *DIT_WIDTHS]
    r0, r1 = spawn(entry_run, 2, tmp_path / "run", "main_dit", argv)
    assert int(r0["dp_size"]) == 2 and int(r0["writes"]) == 1 and int(r1["writes"]) == 0
    assert len(r0["items"]) == len(r1["items"]) == 4
    assert not set(r0["items"].tolist()) & set(r1["items"].tolist())
    assert len(r0["losses"]) == 2 and all(np.isfinite(r0["losses"]))
    for k in r0:
        if k.startswith("param/") or k == "losses":
            assert np.array_equal(r0[k], r1[k]), k


def test_dp_times_sp_other_than_the_world_raises(monkeypatch):
    argv = ["--device", "cpu", "--data_root", "/nonexistent", "--workspace", "/nonexistent/ws"]
    monkeypatch.setenv("WORLD_SIZE", "4")
    for entry, preset, more in ((main, "ArAE", ["--dp_size", "2", "--sp_size", "1"]),
                                (main, "ArAE", ["--dp_size", "3"]),
                                (main_dit, "DiT", ["--dp_size", "2"])):
        with pytest.raises(RuntimeError, match="this world has 4: launch with torchrun "
                                               "--nproc_per_node"):
            entry.main([preset, *argv, *more])
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2 -m "
                                           "edgerunner_tpu_torch.main_dit"):
        main_dit.main(["DiT", *argv, "--dp_size", "2"])


def test_dp_size_minus_one_takes_the_world_over_sp():
    assert dp_for_world(-1, 1, 8, "m") == 8
    assert dp_for_world(-1, 2, 8, "m") == 4
    assert dp_for_world(2, 2, 4, "m") == 2
    for dp, sp, world in ((-1, 3, 8), (2, 2, 2), (1, 2, 4)):
        with pytest.raises(RuntimeError, match="torchrun"):
            dp_for_world(dp, sp, world, "m")


@pytest.mark.parametrize("n,world", [(0, 2), (7, 2), (9, 2), (10, 3), (11, 4), (5, 8)])
def test_shard_items_for_host_matches_jax(n, world):
    items = [f"mesh{i}.obj" for i in range(n)]
    shards = [shard_items_for_host(items, r, world) for r in range(world)]
    assert shards == [jax_shard(items, r, world) for r in range(world)]
    assert len({len(s) for s in shards}) == 1
    assert len({x for s in shards for x in s}) == sum(len(s) for s in shards)

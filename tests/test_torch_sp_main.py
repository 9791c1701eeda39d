"""Sequence-parallel training of the port against its own unsharded
training, on the CPU, over 2 and 4 gloo processes (tests/torch_sp_workers.py).

- One `Trainer.train_step` with sp 2 and 4 against sp 1 from the same weights
  on the same batch, dropout off, gradient checkpointing on (it replays the
  ring's forward and its shifts inside the backward): an attention length
  that divides by neither (17 + 1 + 18 + 1 = 37) is padded.
  Tolerance: the loss atol 1e-5, rtol 1e-4, each parameter's update atol
  1e-5 (1% of the learning rate 1e-3), rtol 1e-4: f32, the same sums in
  another order.
- Three steps with dropout and num-face dropout on leave the parameters
  bit-identical on every rank.
- Ranks whose first batches differ are refused (dp = 1).
- `python -m edgerunner_tpu_torch.main ArAE --sp_size 2` on synthetic data:
  rank 0 alone writes the checkpoints, and a run resumed under sp with
  `--resume_train_state` from the first epoch's checkpoint repeats the
  uninterrupted run's second epoch exactly.
"""

import os

import numpy as np
import pytest
import torch

from edgerunner_tpu_torch.config import Options
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.train.trainer import Trainer, pad_for_sp
from torch_sp_workers import checksum_check, main_run, spawn, train_runs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
B, N_POINTS, L = 2, 48, 18
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
          hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=256,
          use_num_face_cond=True, checkpointing=True, point_num=N_POINTS,
          lr=1e-3, warmup_ratio=0.0, gradient_clip=0.5)
NO_NOF = dict(KW, nof_dropout_ratio=0.0)
TINY = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
        "--point_hidden_dim", "64", "--point_num_heads", "2", "--point_latent_size", "16",
        "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "64",
        "--max_seq_length", "256", "--num_workers", "2", "--seed", "1"]
TRAIN = ["ArAE", "--device", "cpu", "--data_root", "/nonexistent", "--batch_size", "2",
         "--synthetic_size", "8", "--num_epochs", "2", "--lr", "1e-3", "--warmup_ratio", "0.1",
         "--sp_size", "2", *TINY]


def make_batch(seed):
    r = np.random.default_rng(seed)
    C = KW["num_cond_tokens"]
    lens = [L, L - 5]
    tokens = np.zeros((B, L + 2), np.int32)
    labels = np.full((B, C + L + 2), -100, np.int32)
    for i, n in enumerate(lens):
        coords = r.integers(6, 300, n)
        tokens[i, :n + 2] = np.concatenate([[1], coords, [2]])
        labels[i, C + 1:C + n + 2] = np.concatenate([coords, [2]])
    return {"conds": r.normal(size=(B, N_POINTS, 3)).astype(np.float32),
            "tokens": tokens, "labels": labels,
            "num_faces": np.array([100, 3000], np.int32),
            "lengths": np.array([C + n + 2 for n in lens], np.int32)}


@pytest.fixture(scope="module")
def weights():
    model = init_weights(LMM(Options(**KW)), 0)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def solo(weights):
    """One unsharded step, dropout off: (metrics, parameters after it)."""
    from torch_sp_workers import _trainer

    trainer = _trainer(NO_NOF, weights, 1, False)
    trainer.init_state()
    m = trainer.train_step(make_batch(0))
    return m, {n: p.detach().numpy().copy() for n, p in trainer.params.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def ranks(request, weights, tmp_path_factory):
    R = request.param
    runs = [(NO_NOF, weights, [make_batch(0)], False, "det/"),
            (KW, weights, [make_batch(s) for s in (1, 2, 3)], True, "drop/")]
    return R, spawn(train_runs, R, tmp_path_factory.mktemp(f"sp{R}"), runs)


def test_pad_for_sp_suffix_pads_tokens_and_labels():
    batch = make_batch(0)
    assert batch["labels"].shape[1] == 37
    for R, width in ((1, 37), (2, 38), (4, 40)):
        out = pad_for_sp(batch, R, pad_token_id=0)
        pad = width - 37
        assert out["labels"].shape[1] == width
        assert out["tokens"].shape[1] == batch["tokens"].shape[1] + pad
        n = batch["tokens"].shape[1]
        assert np.all(out["labels"][:, 37:] == -100) and np.all(out["tokens"][:, n:] == 0)
        assert np.array_equal(out["labels"][:, :37], batch["labels"])


def test_sp_step_matches_the_unsharded_step(ranks, solo, weights):
    R, res = ranks
    m, params = solo
    for r in range(R):
        for key in ("loss", "loss_ce", "loss_kl", "grad_norm"):
            np.testing.assert_allclose(float(res[r][f"det/step0_{key}"]), m[key], **TOL,
                                       err_msg=f"rank {r} {key}")
    for n, p in params.items():
        np.testing.assert_allclose(res[0][f"det/step0/{n}"] - weights[n], p - weights[n],
                                   **TOL, err_msg=n)


def test_sp_parameters_stay_bit_identical_over_three_steps_with_dropout(ranks):
    R, res = ranks
    keys = [k for k in res[0] if k.startswith("drop/")]
    assert any(k.startswith("drop/step2/") for k in keys)
    for r in range(1, R):
        for k in keys:
            assert np.array_equal(res[r][k], res[0][k]), (r, k)
    losses = [float(res[0][f"drop/step{i}_loss"]) for i in range(3)]
    assert all(np.isfinite(losses))


@pytest.fixture(scope="module")
def sp_main(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("ws"))
    ranks = spawn(main_run, 2, tmp_path_factory.mktemp("run"), [*TRAIN, "--workspace", ws])
    return ws, ranks


def test_sp_main_writes_checkpoints_on_rank_0_only(sp_main):
    ws, (r0, r1) = sp_main
    assert int(r0["writes"]) == 2 and int(r1["writes"]) == 0
    for name in ("ep0000", "ep0001", "best"):
        assert os.path.exists(os.path.join(ws, name, "model.safetensors"))
    assert len(r0["losses"]) == 8 and np.array_equal(r0["losses"], r1["losses"])
    for k in r0:
        if k.startswith("param/"):
            assert np.array_equal(r0[k], r1[k]), k


def test_sp_resume_train_state_repeats_the_uninterrupted_run(sp_main, tmp_path):
    ws, (r0, _) = sp_main
    resumed = spawn(main_run, 2, tmp_path / "run", [
        *TRAIN, "--workspace", str(tmp_path / "resumed"), "--resume",
        os.path.join(ws, "ep0000", "model.safetensors"), "--resume_train_state"])
    for res in resumed:
        assert res["losses"].tolist() == r0["losses"][4:].tolist()
        for k in r0:
            if k.startswith("param/"):
                assert np.array_equal(res[k], r0[k]), k


def test_ranks_holding_different_batches_are_refused(tmp_path):
    """dp = 1: the trainer compares the first batch's checksum over the
    ranks, and a difference raises on every rank."""
    for res in spawn(checksum_check, 2, tmp_path):
        assert int(res["raised"]) == 1
        assert "the rank differs between the sp ranks" in str(res["message"])


def test_a_group_of_one_rank_is_no_sp():
    """A group of one rank installs no context and its collectives return
    their inputs: the trainer runs its unsharded step."""
    from edgerunner_tpu_torch.parallel import (
        SequenceParallel,
        active_sequence_parallel,
        all_reduce_,
        ring_shift,
        sequence_parallel,
    )

    one = SequenceParallel(group=None, rank=0, size=1, staged=False)
    with sequence_parallel(one):
        assert active_sequence_parallel() is None
    x = torch.arange(6.0)
    assert ring_shift([x], one)[0] is x
    all_reduce_([x], one)
    assert torch.equal(x, torch.arange(6.0))
    t = Trainer(LMM(Options(**KW)), Options(**KW), total_steps=10, layout=None)
    assert t.sp is None and t.is_main

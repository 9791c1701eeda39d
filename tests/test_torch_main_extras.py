"""The training extras of the port's `main` on the CPU at a tiny width:
--async_checkpointing (train/checkpoint.py), the profiler trace of steps
10-14 of epoch 0, --use_wandb through a stub `wandb` module, and
--eval_mode generate on one process and under dp 2 (2 gloo ranks).

The async workspace after `wait()` equals the synchronous one byte for
byte; the workspace's `model.safetensors` lags one save while a save is in
flight; a run resumed from an async save takes the uninterrupted run's
steps; the stub records the JAX main's call sequence (main.py:166-176,
:207-211, :253-262: init, the metrics every 10 steps, the epoch's
train_loss, the eval's scores with commit=False).
"""

import json
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from edgerunner_tpu_torch import main
from edgerunner_tpu_torch.config import config_defaults
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.train import checkpoint
from edgerunner_tpu_torch.train.checkpoint import CheckpointManager
from torch_dp_workers import entry_run
from torch_sp_workers import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
        "--point_hidden_dim", "64", "--point_num_heads", "2", "--point_latent_size", "16",
        "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "64",
        "--max_seq_length", "256", "--num_workers", "2", "--seed", "1"]
TRAIN = ["ArAE", "--device", "cpu", "--data_root", "/nonexistent", "--batch_size", "2",
         "--lr", "1e-3", "--warmup_ratio", "0.1", *TINY]
# 32 synthetic samples in rows of 2: 16 steps, the trace's steps 10-14 among them
EVAL = ["--synthetic_size", "32", "--num_epochs", "1", "--eval_mode", "generate",
        "--eval_gen_samples", "3", "--test_batch_size", "2", "--test_num_face", "20",
        "--decode_bucket", "64"]


def _tree(ws: str) -> dict:
    """Every file of a workspace but the log and the trace: its bytes, or
    where a link points."""
    out = {}
    for dirpath, _, files in os.walk(ws):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, ws)
            if rel == "log.txt" or rel.startswith("profile"):
                continue
            out[rel] = (("link", os.readlink(path)) if os.path.islink(path)
                        else open(path, "rb").read())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two epochs of 4 steps each, optimizer state and EMA saved, with
    synchronous and with asynchronous saves."""
    out = {}
    for mode in ("false", "true"):
        ws = str(tmp_path_factory.mktemp(f"async_{mode}"))
        out[mode] = ws, main.main([*TRAIN, "--workspace", ws, "--synthetic_size", "8",
                                   "--num_epochs", "2", "--ema_decay", "0.9",
                                   "--async_checkpointing", mode])
    return out


def test_async_workspace_equals_the_sync_one_byte_for_byte(runs):
    (ws_sync, t_sync), (ws_async, t_async) = runs["false"], runs["true"]
    assert t_async.losses == t_sync.losses and len(t_sync.losses) == 8
    sync, asyn = _tree(ws_sync), _tree(ws_async)
    assert set(asyn) == set(sync)
    for name in ("ep0000/model.safetensors", "ep0001/opt_state.pt", "ep0001/ema.safetensors",
                 "ep0001/train_state.json", "best/model.safetensors", "model.safetensors",
                 "ema.safetensors"):
        assert name in sync, name
    for name in sync:
        assert asyn[name] == sync[name], name


def test_run_resumed_from_an_async_save_takes_the_same_steps(runs, tmp_path):
    ws, trainer = runs["true"]
    resumed = main.main([*TRAIN, "--workspace", str(tmp_path / "resumed"),
                         "--synthetic_size", "8", "--num_epochs", "2", "--ema_decay", "0.9",
                         "--async_checkpointing", "true", "--resume",
                         os.path.join(ws, "ep0000", "model.safetensors"),
                         "--resume_train_state"])
    assert resumed.step == trainer.step == 8
    assert resumed.losses == trainer.losses[4:]
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for name, e in trainer.ema.items():
        assert torch.equal(e, resumed.ema[name]), name


def test_latest_lags_while_a_save_is_in_flight(tmp_path, monkeypatch):
    opt = config_defaults["ArAE"]
    model = init_weights(LMM(opt.__class__(**dict(
        vars(opt), hidden_dim=32, num_layers=1, num_heads=2, point_hidden_dim=32,
        point_num_heads=2, point_latent_size=8, point_latent_dim=4, num_cond_tokens=9))), 0)
    release, started = threading.Event(), threading.Event()
    write = checkpoint.write_snapshot

    def held(save_dir, snap):
        started.set()
        release.wait(30)
        write(save_dir, snap)

    manager = CheckpointManager(str(tmp_path), async_save=True)
    link = tmp_path / "model.safetensors"
    manager.save_epoch(0, model, loss=2.0, train_state={"step": 1}, log=lambda m: None)
    assert not os.path.lexists(link)  # nothing committed yet
    manager.wait(log=lambda m: None)
    assert os.readlink(link) == os.path.join("ep0000", "model.safetensors")
    monkeypatch.setattr(checkpoint, "write_snapshot", held)
    before = {n: p.detach().clone() for n, p in model.state_dict().items()}
    manager.save_epoch(1, model, loss=1.0, train_state={"step": 2}, log=lambda m: None)
    assert started.wait(30)
    # the next steps move the weights: the save holds the copy taken at the call
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    assert os.readlink(link) == os.path.join("ep0000", "model.safetensors")
    assert not (tmp_path / "ep0001" / "train_state.json").exists()
    release.set()
    manager.wait(log=lambda m: None)
    assert os.readlink(link) == os.path.join("ep0001", "model.safetensors")
    assert json.loads((tmp_path / "ep0001" / "train_state.json").read_text()) == {
        "step": 2, "best_loss": 1.0}
    saved = checkpoint.read_safetensors(str(link))
    for name, t in before.items():
        assert np.array_equal(saved[name], t.float().numpy()), name


def _stub_wandb(calls: list):
    stub = types.ModuleType("wandb")
    stub.init = lambda *a, **kw: calls.append(("init", a, kw))
    stub.log = lambda *a, **kw: calls.append(("log", a, kw))
    return stub


def test_one_process_traces_evaluates_and_logs_to_wandb(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls))
    ws = str(tmp_path / "ws")
    trainer = main.main([*TRAIN, *EVAL, "--workspace", ws, "--use_wandb", "true"])
    assert len(trainer.losses) == 16
    log = open(os.path.join(ws, "log.txt")).read()
    assert f"[profiler] trace written to {os.path.join(ws, 'profile')}" in log
    trace = json.load(open(os.path.join(ws, "profile", "trace.json")))
    assert any("flash_attention" in str(e.get("name", "")) or "aten::" in str(e.get("name", ""))
               for e in trace["traceEvents"])
    evals = [line for line in log.splitlines() if "Eval epoch: 0 generated meshes saved." in line]
    assert len(evals) == 1 and "chamfer=" in evals[0] and "(n=" in evals[0]
    assert sorted(n for n in os.listdir(ws) if n.startswith("testgen_")) == [
        f"testgen_ep0_{i}.obj" for i in range(3)]
    # the JAX main's call sequence
    assert [c[0] for c in calls] == ["init", "log", "log", "log"]
    (_, a, kw) = calls[0]
    assert a == () and kw["project"] == "lmm" and kw["name"] == "ws"
    assert kw["config"] == vars(trainer.opt)
    (_, a, kw) = calls[1]
    assert kw == {"step": 10} and set(a[0]) == {"loss", "loss_ce", "loss_kl", "grad_norm"}
    assert a[0]["loss"] == trainer.losses[9]
    (_, a, kw) = calls[2]
    assert kw == {} and a == ({"train_loss": sum(trainer.losses) / len(trainer.losses)},)
    (_, a, kw) = calls[3]
    assert kw == {"commit": False}
    assert set(a[0]) == {"eval_chamfer", "eval_chamfer_std", "eval_fscore", "eval_fscore_std"}


def test_dp2_rank0_evaluates_and_every_rank_traces(tmp_path):
    ws = str(tmp_path / "ws")
    ranks = spawn(entry_run, 2, tmp_path / "run", "main",
                  [*TRAIN, *EVAL, "--workspace", ws, "--dp_size", "2",
                   "--async_checkpointing", "true"])
    assert all(len(r["losses"]) == 16 and int(r["dp_size"]) == 2 for r in ranks)
    assert [int(r["writes"]) for r in ranks] == [1, 0]
    log = open(os.path.join(ws, "log.txt")).read()
    assert log.count("Eval epoch: 0 generated meshes saved.") == 1
    assert sorted(n for n in os.listdir(ws) if n.startswith("testgen_")) == [
        f"testgen_ep0_{i}.obj" for i in range(3)]
    assert sorted(os.listdir(os.path.join(ws, "profile"))) == ["trace_rank0.json",
                                                               "trace_rank1.json"]
    assert os.readlink(os.path.join(ws, "model.safetensors")) == os.path.join(
        "ep0000", "model.safetensors")

"""Checkpoints of the port's trainer (edgerunner_tpu/train/checkpoint.py:133-260).

The reference's policy (main.py:226-238): a save per epoch (and, with
`save_every_steps`, mid-epoch), a `model.safetensors` pointer at the
workspace root to the latest save, a `best/` copy of the weights with the
lowest loss, and the last two saves kept. Beside the weights, in reference
naming, each save holds the optimizer state (`opt_state.pt`) and
`train_state.json` (step, loader position, best loss), so that a resume
continues exactly. With `--ema_decay` each save also holds the weights'
moving average as `ema.safetensors`, a whole model file like the weights'
(the workspace's `ema.safetensors` points at the latest), from which a
resume restores it (`sibling_ema_path`). Each save first copies the
weights, the optimizer state and the EMA to host memory. With `async_save`
(--async_checkpointing; edgerunner_tpu/train/checkpoint.py:142-215) the
save returns then, and a background thread writes the files while training
goes on; the bookkeeping (train_state.json, the workspace's links, `best/`,
the pruning) waits for the next save or for `wait()`, so the workspace's
`model.safetensors` lags one save while a save is in flight, and at most
one is in flight. Under data or sequence parallelism every rank of the
world (`group`) holds the same weights, optimizer state and EMA: its rank
0 writes, and every rank waits at a barrier until it has (in `wait()`
under async_save).

The non-strict loads (`--resume2`, `main_dit`'s `--resume`) are a question
of the weights' format and live in weights.py (`tolerant_merge`,
`overlay_checkpoint`).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import torch
import torch.distributed as dist

from edgerunner_tpu_torch.weights import (
    load_state,
    read_safetensors,
    write_safetensors,
)

MODEL_FILE = "model.safetensors"
EMA_FILE = "ema.safetensors"
OPT_FILE = "opt_state.pt"
STATE_FILE = "train_state.json"


def _link(workspace: str, target: str, name: str):
    path = os.path.join(workspace, name)
    if os.path.lexists(path):
        os.unlink(path)
    os.symlink(target, path)


def _to_host(obj):
    """`obj` with every tensor in it copied to host memory: a snapshot that
    later steps, which update the tensors in place, leave as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def host_snapshot(model, optimizer=None, ema: Optional[dict] = None) -> dict:
    """What a save writes, copied to host memory: the weights and the EMA
    as {reference name: f32 array}, the optimizer's state dict."""
    weights = {k: v.detach().to("cpu", torch.float32, copy=True).numpy()
               for k, v in model.state_dict().items()}
    snap = {"weights": weights, "ema": None, "opt": None}
    if ema is not None:
        snap["ema"] = {**weights, **{n: t.detach().to("cpu", torch.float32, copy=True).numpy()
                                     for n, t in ema.items()}}
    if optimizer is not None:
        snap["opt"] = _to_host(optimizer.state_dict())
    return snap


def write_snapshot(save_dir: str, snap: dict):
    os.makedirs(save_dir, exist_ok=True)
    write_safetensors(os.path.join(save_dir, MODEL_FILE), snap["weights"])
    if snap["ema"] is not None:
        write_safetensors(os.path.join(save_dir, EMA_FILE), snap["ema"])
    if snap["opt"] is not None:
        torch.save(snap["opt"], os.path.join(save_dir, OPT_FILE))


class CheckpointManager:
    def __init__(self, workspace: str, keep: int = 2, group=None, async_save: bool = False):
        self.workspace = workspace
        self.keep = keep
        # every rank of the run (parallel/mesh.py); None for one process
        self.group = group if group is not None and group.size > 1 else None
        self.writes = self.group is None or self.group.rank == 0
        self.old_dirs: list[str] = []
        self.best_loss = float("inf")
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._thread_error: Optional[Exception] = None
        self._pending = None  # the bookkeeping of the save in flight
        os.makedirs(workspace, exist_ok=True)

    def _save(self, tag: str, model, optimizer=None, loss: Optional[float] = None,
              train_state: Optional[dict] = None, log=print, ema: Optional[dict] = None):
        if self.async_save:
            self.wait(log)  # the previous save: its files, then its bookkeeping
            if self.writes:
                self._write(tag, model, optimizer, loss, train_state, log, ema)
            return
        try:
            if self.writes:
                self._write(tag, model, optimizer, loss, train_state, log, ema)
        finally:
            if self.group is not None:
                dist.barrier(self.group.group)

    def _write(self, tag: str, model, optimizer, loss, train_state, log, ema):
        """The writing rank's save: the host copy, then the files and the
        bookkeeping, or under async_save the files on a background thread
        and the bookkeeping deferred."""
        save_dir = os.path.join(self.workspace, tag)
        snap = host_snapshot(model, optimizer, ema)
        bookkeeping = (tag, save_dir, loss, train_state)
        if self.async_save:
            self._start_write(save_dir, snap)
            self._pending = (bookkeeping, ema is not None)
            return
        write_snapshot(save_dir, snap)
        self._bookkeep(*bookkeeping, log, ema is not None)

    def _start_write(self, save_dir: str, snap: dict):
        def write():
            try:
                write_snapshot(save_dir, snap)
            except Exception as exc:  # noqa: BLE001 - raised again by wait()
                self._thread_error = exc

        self._thread = threading.Thread(target=write, name="checkpoint-writer")
        self._thread.start()

    def wait(self, log=print):
        """Under async_save: block until the save in flight is on disk, then
        do its bookkeeping; under dp or sp every rank waits at a barrier
        until rank 0 has. Call it at the end of training. Nothing to do
        for synchronous saves."""
        if not self.async_save:
            return
        try:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
                if self._thread_error is not None:
                    error, self._thread_error = self._thread_error, None
                    raise RuntimeError("the checkpoint writer failed") from error
            if self._pending is not None:
                (bookkeeping, has_ema), self._pending = self._pending, None
                self._bookkeep(*bookkeeping, log, has_ema)
        finally:
            if self.group is not None:
                dist.barrier(self.group.group)

    def _bookkeep(self, tag: str, save_dir: str, loss, train_state, log, has_ema: bool):
        # best first, so that train_state.json records the true best so far
        new_best = loss is not None and loss < self.best_loss
        if new_best:
            self.best_loss = loss
        if train_state is not None:
            with open(os.path.join(save_dir, STATE_FILE), "w") as f:
                json.dump({**train_state, "best_loss": self.best_loss}, f)

        _link(self.workspace, os.path.join(tag, MODEL_FILE), MODEL_FILE)
        if has_ema:
            _link(self.workspace, os.path.join(tag, EMA_FILE), EMA_FILE)
        if new_best:
            best = os.path.join(self.workspace, "best")
            os.makedirs(best, exist_ok=True)
            shutil.copyfile(os.path.join(save_dir, MODEL_FILE), os.path.join(best, MODEL_FILE))
            log(f"[ckpt] new best loss {loss:.6f}")

        self.old_dirs.append(save_dir)
        if len(self.old_dirs) > self.keep:
            shutil.rmtree(self.old_dirs.pop(0), ignore_errors=True)

    def save_epoch(self, epoch: int, model, optimizer=None, loss: Optional[float] = None,
                   train_state: Optional[dict] = None, log=print, ema: Optional[dict] = None):
        self._save(f"ep{epoch:04d}", model, optimizer, loss, train_state, log, ema)

    def save_step(self, step: int, model, optimizer=None,
                  train_state: Optional[dict] = None, log=print, ema: Optional[dict] = None):
        """Mid-epoch checkpoint (--save_every_steps)."""
        self._save(f"step{step:08d}", model, optimizer, None, train_state, log, ema)


def sibling_ema_path(resume_path: str) -> Optional[str]:
    """The EMA file beside a weights file (or beside the workspace's
    `model.safetensors` pointer, where the `ema.safetensors` pointer lies),
    if the run that wrote it kept one."""
    path = os.path.join(os.path.dirname(os.path.abspath(resume_path)), EMA_FILE)
    return path if os.path.exists(path) else None


def find_train_state(resume_path: str) -> Optional[dict]:
    """The train_state.json beside a --resume weights file (which may be the
    workspace's `model.safetensors` pointer), with `opt_state_path` set to
    the optimizer state saved beside it, or None."""
    save_dir = os.path.dirname(os.path.realpath(resume_path))
    path = os.path.join(save_dir, STATE_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        state = json.load(f)
    opt_path = os.path.join(save_dir, OPT_FILE)
    state["opt_state_path"] = opt_path if os.path.exists(opt_path) else None
    return state


def restore_train_state(resume_path: str, loader, manager: CheckpointManager, logger) -> tuple:
    """(start epoch, step, optimizer state path) of an exact continuation
    from the checkpoint `resume_path` (--resume_train_state): the loader
    and the manager's best loss restored; (0, 0, None) with a warning when
    no train_state.json lies beside it."""
    ts = find_train_state(resume_path)
    if ts is None:
        logger.warning("[resume] --resume_train_state set but no "
                       "train_state.json next to the checkpoint")
        return 0, 0, None
    step, start_epoch = int(ts.get("step", 0)), 0
    if ts.get("loader"):
        loader.restore_state(ts["loader"])
        start_epoch = loader.epoch
    opt_state_path = ts.get("opt_state_path")
    if ts.get("best_loss") is not None:
        manager.best_loss = float(ts["best_loss"])
    logger.info(f"[resume] exact continuation: step {step}, epoch {start_epoch}, "
                f"loader {ts.get('loader')}, opt_state {'yes' if opt_state_path else 'no'}")
    return start_epoch, step, opt_state_path

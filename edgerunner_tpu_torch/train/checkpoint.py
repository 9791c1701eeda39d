"""Checkpoints of the port's trainer (edgerunner_tpu/train/checkpoint.py:133-260).

The reference's policy (main.py:226-238): a save per epoch (and, with
`save_every_steps`, mid-epoch), a `model.safetensors` pointer at the
workspace root to the latest save, a `best/` copy of the weights with the
lowest loss, and the last two saves kept. Beside the weights, in reference
naming, each save holds the optimizer state (`opt_state.pt`) and
`train_state.json` (step, loader position, best loss), so that a resume
continues exactly. Saves are synchronous. Under sequence parallelism
(`sp`) every rank holds the same weights and optimizer state: rank 0 writes,
and every rank waits at a barrier until it has.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist

from edgerunner_tpu_torch.weights import reference_state_dict, write_safetensors

MODEL_FILE = "model.safetensors"
OPT_FILE = "opt_state.pt"
STATE_FILE = "train_state.json"


class CheckpointManager:
    def __init__(self, workspace: str, keep: int = 2, sp=None):
        self.workspace = workspace
        self.keep = keep
        self.sp = sp if sp is not None and sp.size > 1 else None
        self.old_dirs: list[str] = []
        self.best_loss = float("inf")
        os.makedirs(workspace, exist_ok=True)

    def _save(self, tag: str, model, optimizer=None, loss: Optional[float] = None,
              train_state: Optional[dict] = None, log=print):
        if self.sp is None:
            self._write(tag, model, optimizer, loss, train_state, log)
            return
        try:
            if self.sp.rank == 0:
                self._write(tag, model, optimizer, loss, train_state, log)
        finally:
            dist.barrier(self.sp.group)

    def _write(self, tag: str, model, optimizer, loss, train_state, log):
        save_dir = os.path.join(self.workspace, tag)
        os.makedirs(save_dir, exist_ok=True)
        write_safetensors(os.path.join(save_dir, MODEL_FILE), reference_state_dict(model))
        if optimizer is not None:
            torch.save(optimizer.state_dict(), os.path.join(save_dir, OPT_FILE))
        # best first, so that train_state.json records the true best so far
        new_best = loss is not None and loss < self.best_loss
        if new_best:
            self.best_loss = loss
        if train_state is not None:
            with open(os.path.join(save_dir, STATE_FILE), "w") as f:
                json.dump({**train_state, "best_loss": self.best_loss}, f)

        latest = os.path.join(self.workspace, MODEL_FILE)
        if os.path.lexists(latest):
            os.unlink(latest)
        os.symlink(os.path.join(tag, MODEL_FILE), latest)
        if new_best:
            best = os.path.join(self.workspace, "best")
            os.makedirs(best, exist_ok=True)
            shutil.copyfile(os.path.join(save_dir, MODEL_FILE), os.path.join(best, MODEL_FILE))
            log(f"[ckpt] new best loss {loss:.6f}")

        self.old_dirs.append(save_dir)
        if len(self.old_dirs) > self.keep:
            shutil.rmtree(self.old_dirs.pop(0), ignore_errors=True)

    def save_epoch(self, epoch: int, model, optimizer=None, loss: Optional[float] = None,
                   train_state: Optional[dict] = None, log=print):
        self._save(f"ep{epoch:04d}", model, optimizer, loss, train_state, log)

    def save_step(self, step: int, model, optimizer=None,
                  train_state: Optional[dict] = None, log=print):
        """Mid-epoch checkpoint (--save_every_steps)."""
        self._save(f"step{step:08d}", model, optimizer, None, train_state, log)


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

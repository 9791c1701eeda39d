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
resume restores it (`sibling_ema_path`). Saves are synchronous. Under
sequence parallelism (`sp`) every rank holds the same weights, optimizer
state and EMA: rank 0 writes, and every rank waits at a barrier until it
has.

`tolerant_merge` is the non-strict load of `main_dit`'s `--resume` and
`--resume2` (edgerunner_tpu/train/checkpoint.py:84-130): it copies the
entries whose name and shape match and realigns position embeddings.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from edgerunner_tpu_torch.weights import reference_state_dict, write_safetensors

MODEL_FILE = "model.safetensors"
EMA_FILE = "ema.safetensors"
OPT_FILE = "opt_state.pt"
STATE_FILE = "train_state.json"


def _realign_posemb(ckpt_w: np.ndarray, model_w: np.ndarray, align: str) -> np.ndarray:
    """A loaded position-embedding table laid onto a table of another length,
    at its left or right end (reference: main.py:77-89)."""
    out = np.array(model_w)
    n_ckpt, n_model = ckpt_w.shape[0], model_w.shape[0]
    if n_model > n_ckpt:
        if align == "right":
            out[-n_ckpt:] = ckpt_w
        else:
            out[:n_ckpt] = ckpt_w
    else:
        out = ckpt_w[:n_model] if align == "left" else ckpt_w[-n_model:]
    return out


def tolerant_merge(model_state: dict, ckpt_state: dict, align_posemb: str = "right",
                   log=print) -> dict:
    """{name: array} of the model's entries, each taken from the checkpoint
    where the name and the shape match (in the model's dtype), an
    `embed_positions` table of another length realigned, every other entry
    kept; missing, mismatched and unexpected entries are logged."""
    merged = {}
    for key, mv in model_state.items():
        mv = np.asarray(mv)
        if key not in ckpt_state:
            log(f"[ckpt] missing param {key}: keeping init")
            merged[key] = mv
            continue
        cv = np.asarray(ckpt_state[key])
        if cv.shape == mv.shape:
            merged[key] = cv.astype(mv.dtype)
        elif "embed_positions" in key and cv.ndim == 2 and cv.shape[1] == mv.shape[1]:
            log(f"[ckpt] realigning position embeddings {cv.shape} -> {mv.shape} "
                f"({align_posemb})")
            merged[key] = _realign_posemb(cv, mv, align_posemb).astype(mv.dtype)
        else:
            log(f"[ckpt] shape mismatch for {key}: ckpt {cv.shape} != model {mv.shape}, "
                f"ignored")
            merged[key] = mv
    for key in ckpt_state:
        if key not in model_state:
            log(f"[ckpt] unexpected param {key}")
    return merged


def ema_state_dict(model, ema: dict) -> dict:
    """The model's weights with each averaged parameter's EMA in its place:
    a model file that loads like the weights'."""
    state = reference_state_dict(model)
    state.update({n: t.detach().float().cpu().numpy() for n, t in ema.items()})
    return state


def _link(workspace: str, target: str, name: str):
    path = os.path.join(workspace, name)
    if os.path.lexists(path):
        os.unlink(path)
    os.symlink(target, path)


class CheckpointManager:
    def __init__(self, workspace: str, keep: int = 2, sp=None):
        self.workspace = workspace
        self.keep = keep
        self.sp = sp if sp is not None and sp.size > 1 else None
        self.old_dirs: list[str] = []
        self.best_loss = float("inf")
        os.makedirs(workspace, exist_ok=True)

    def _save(self, tag: str, model, optimizer=None, loss: Optional[float] = None,
              train_state: Optional[dict] = None, log=print, ema: Optional[dict] = None):
        if self.sp is None:
            self._write(tag, model, optimizer, loss, train_state, log, ema)
            return
        try:
            if self.sp.rank == 0:
                self._write(tag, model, optimizer, loss, train_state, log, ema)
        finally:
            dist.barrier(self.sp.group)

    def _write(self, tag: str, model, optimizer, loss, train_state, log, ema):
        save_dir = os.path.join(self.workspace, tag)
        os.makedirs(save_dir, exist_ok=True)
        write_safetensors(os.path.join(save_dir, MODEL_FILE), reference_state_dict(model))
        if ema is not None:
            write_safetensors(os.path.join(save_dir, EMA_FILE), ema_state_dict(model, ema))
        if optimizer is not None:
            torch.save(optimizer.state_dict(), os.path.join(save_dir, OPT_FILE))
        # best first, so that train_state.json records the true best so far
        new_best = loss is not None and loss < self.best_loss
        if new_best:
            self.best_loss = loss
        if train_state is not None:
            with open(os.path.join(save_dir, STATE_FILE), "w") as f:
                json.dump({**train_state, "best_loss": self.best_loss}, f)

        _link(self.workspace, os.path.join(tag, MODEL_FILE), MODEL_FILE)
        if ema is not None:
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

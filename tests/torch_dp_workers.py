"""Rank processes of the port's data-parallel tests, spawned by
`torch_sp_workers.spawn` (gloo on the CPU, one process per rank). Each
lays the world out as dp × sp with `make_layout` (rank = d · sp + s) and
takes the rows of its dp group. This module imports torch and the port
only, so the children load no JAX.
"""

import functools

import numpy as np
import torch


def _rows(batch: dict, d: int, dp: int) -> dict:
    """Dp group d's contiguous share of a global batch's rows."""
    per = len(next(iter(batch.values()))) // dp
    return {k: np.asarray(v)[d * per:(d + 1) * per] for k, v in batch.items()}


def _step_out(trainer, m) -> dict:
    out = {f"step0_{k}": np.float64(v) for k, v in m.items()}
    for name, p in trainer.params.items():
        out[f"step0/{name}"] = p.detach().numpy().copy()
    return out


def lmm_step(rank, R, tmp_path, kw, state, batch, dp_size, sp_size):
    """One `Trainer.train_step` of the LMM from the weights `state`, dropout
    off, on this rank's dp group's rows of `batch`: the world's metrics and
    every parameter after the step."""
    from edgerunner_tpu_torch.config import Options
    from edgerunner_tpu_torch.models.lmm import LMM
    from edgerunner_tpu_torch.parallel import make_layout
    from edgerunner_tpu_torch.train.trainer import Trainer
    from edgerunner_tpu_torch.weights import load_state

    dp, sp = make_layout(torch.device("cpu"), dp_size, sp_size)
    model = LMM(Options(**kw))
    load_state(model, state)
    for layer in model.mesh_decoder.model.layers:
        layer.dropout = 0.0
    trainer = Trainer(model, Options(**kw), total_steps=10, sp=sp, dp=dp)
    trainer.init_state()
    return _step_out(trainer, trainer.train_step(_rows(batch, rank // sp_size, dp_size)))


def mdit_step(rank, R, tmp_path, kw, state, batch, draws):
    """One `Trainer.train_step` of the MDiT with dp R from the weights
    `state`, on this rank's rows of `batch` with its rows of the recorded
    draws (keep, noise, t) in place of its own."""
    from edgerunner_tpu_torch.config import Options
    from edgerunner_tpu_torch.models.mdit import MDiT
    from edgerunner_tpu_torch.parallel import make_layout
    from edgerunner_tpu_torch.train.trainer import Trainer
    from edgerunner_tpu_torch.weights import load_state

    dp, _ = make_layout(torch.device("cpu"), R, 1)
    model = MDiT(Options(**kw))
    load_state(model, state)
    mine = _rows(draws, rank, R)
    model.forward = functools.partial(
        model.forward, keep=torch.tensor(mine["uniform"] >= 0.1),
        noise=torch.tensor(mine["normal"]), t=torch.tensor(mine["randint"]).long())
    trainer = Trainer(model, Options(**kw), total_steps=10, kind="dit", dp=dp)
    trainer.init_state()
    return _step_out(trainer, trainer.train_step(_rows(batch, rank, R)))


def entry_run(rank, R, tmp_path, module, argv):
    """`edgerunner_tpu_torch.<module>.main(argv)` on this rank: its losses,
    its dp size, its parameters, the checkpoints it wrote and the train
    items of its shard (`shard_items_for_host` as train/ranks.py calls it)."""
    import importlib

    from edgerunner_tpu_torch.train import checkpoint, ranks

    writes, shards = [], []
    write, shard = checkpoint.CheckpointManager._write, ranks.shard_items_for_host

    def counted(self, tag, *a, **kw):
        writes.append(tag)
        return write(self, tag, *a, **kw)

    def recorded(items, r, world):
        shards.append(shard(items, r, world))
        return shards[-1]

    checkpoint.CheckpointManager._write = counted
    ranks.shard_items_for_host = recorded
    trainer = importlib.import_module(f"edgerunner_tpu_torch.{module}").main(list(argv))
    out = {"losses": np.asarray(trainer.losses), "writes": np.asarray(len(writes)),
           "dp_size": np.asarray(1 if trainer.dp is None else trainer.dp.size),
           "items": np.asarray(shards[0] if shards else [], dtype=str)}
    for name, p in trainer.params.items():
        out[f"param/{name}"] = p.detach().numpy().copy()
    return out

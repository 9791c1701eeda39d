"""Rank processes of the port's tensor-, pipeline- and MoE-under-sp tests,
spawned by `torch_sp_workers.spawn` (gloo on the CPU, one process per
rank). Each run lays the world out with `make_layout` (rank = (((d · pp +
p) · sp + s) · tp + t) · ep + e), cuts the whole weights to its shards,
takes its dp group's rows and runs one training step. This module imports
torch and the port only, so the children load no JAX.
"""

import functools

import numpy as np
import torch

from torch_dp_workers import _rows

AXES = ("dp", "pp", "sp", "tp", "ep")


def _trainer(kw, state, sizes, kind="arae"):
    from edgerunner_tpu_torch.config import Options
    from edgerunner_tpu_torch.models.lmm import LMM
    from edgerunner_tpu_torch.models.mdit import MDiT
    from edgerunner_tpu_torch.parallel import make_layout
    from edgerunner_tpu_torch.train.trainer import Trainer
    from edgerunner_tpu_torch.weights import load_state

    layout = None  # one process
    if any(sizes.get(a, 1) > 1 for a in AXES):
        layout = make_layout(torch.device("cpu"), *(sizes.get(a, 1) for a in AXES),
                             microbatches=kw.get("pp_microbatches", 0))
    opt = Options(**kw)
    if kind == "dit":
        model = MDiT(opt, tp=None if layout is None else layout.tp)
    else:
        parts = {} if layout is None else dict(ep=layout.ep, tp=layout.tp, pp=layout.pp)
        model = LMM(opt, **parts)
        for layer in model.mesh_decoder.model.layers:
            layer.dropout = 0.0
    trainer = Trainer(model, opt, total_steps=10, kind=kind, layout=layout)
    load_state(model, trainer.shard(state))
    trainer.init_state()
    return trainer


def layout_step(trainer, batch, tag: str) -> dict:
    """One `train_step` on this rank's dp group's rows of `batch`: the
    world's metrics; on rank 0 the gradients the optimizer got and the
    parameters after the step, each gathered whole in the reference naming
    (`Trainer._gather`); on every rank its parameters that no axis splits,
    which every rank must hold alike."""
    seen, update = {}, trainer.optimizer.update

    def capture(grads):
        seen.update({n: g.clone() for n, g in grads.items()})
        return update(grads)

    trainer.optimizer.update = capture
    dp = trainer.dp
    out = {}
    if trainer.opt.moe_experts and dp is not None and trainer.pp is not None:
        # MoE under dp x pp: the held-out loss of the whole batch first
        out[f"{tag}/eval"] = np.float64(trainer.eval_epoch([batch], 0))
    m = trainer.train_step(_rows(batch, 0 if dp is None else dp.rank,
                                 1 if dp is None else dp.size))
    out.update({f"{tag}/metric/{k}": np.float64(v) for k, v in m.items()})
    if trainer.first_group:
        grads = trainer._gather(seen)
        params = trainer._gather(dict(trainer.model.named_parameters()))
        if grads is not None:
            out.update({f"{tag}/grad/{n}": g.numpy() for n, g in grads.items()})
            out.update({f"{tag}/param/{n}": p.numpy() for n, p in params.items()})
    for n, p in trainer.params.items():
        if not trainer.split_axes(n):
            out[f"{tag}/own/{n}"] = p.detach().numpy().copy()
    return out


def layout_runs(rank, R, tmp_path, runs, main_argv=None):
    """`layout_step` for each (tag, kw, state, batch, sizes, kind) of `runs`
    (a dit run's batch carries its draws: the port's MDiT takes them in
    place of its own); then, with `main_argv`, `main` with each of its
    argument lists in turn (a run that saves, then its resume): the losses
    of each and the step the last reached."""
    import torch.distributed as dist

    from edgerunner_tpu_torch import main

    out = {}
    for tag, kw, state, batch, sizes, kind in runs:
        trainer = _trainer(kw, state, sizes, kind)
        if kind == "dit":
            d = 0 if trainer.dp is None else trainer.dp.rank
            n = 1 if trainer.dp is None else trainer.dp.size
            mine = _rows(batch["draws"], d, n)
            trainer.model.forward = functools.partial(
                trainer.model.forward, keep=torch.tensor(mine["uniform"] >= 0.1),
                noise=torch.tensor(mine["normal"]), t=torch.tensor(mine["randint"]).long())
            batch = batch["batch"]
        out.update(layout_step(trainer, batch, tag))
        # every rank done with this run's groups before the next run's are made
        del trainer
        dist.barrier()
    for i, argv in enumerate(main_argv or []):
        trainer = main.main(list(argv))
        out[f"main{i}/losses"] = np.asarray(trainer.losses)
        out[f"main{i}/step"] = np.asarray(trainer.step)
    return out

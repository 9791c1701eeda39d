"""Rank processes of the port's MoE parallelism tests, spawned by
`torch_sp_workers.spawn` (gloo on the CPU, one process per rank). Each lays
the world out as dp × ep (`make_layout`, rank = d · ep + e) or dp alone,
takes its dp group's rows and runs one training step. This module imports
torch and the port only, so the children load no JAX.
"""

import numpy as np
import torch

from torch_dp_workers import _rows


def _full(t, ep):
    """An expert shard gathered into the full [E, ...] tensor over the ep
    group; any other tensor as it is."""
    from edgerunner_tpu_torch.parallel import all_gather

    return t.detach() if ep is None else torch.cat(all_gather(t.detach(), ep))


def moe_step(rank, R, tmp_path, kw, state, batch, dp_size, ep_size, main_argv=None):
    """One `Trainer.train_step` of the MoE LMM from the weights `state`
    (every expert; each rank takes its share), dropout off, on this rank's
    dp group's rows: the world's metrics, the gradients the optimizer got
    (summed over the replicas, experts gathered whole), each parameter
    after the step (experts gathered) and this rank's own tensors. With
    `main_argv`, then `main` with those arguments (an ep 2 run that saves,
    then its resume): the losses of both runs."""
    from edgerunner_tpu_torch import main
    from edgerunner_tpu_torch.config import Options
    from edgerunner_tpu_torch.models.lmm import LMM
    from edgerunner_tpu_torch.models.moe import is_expert_param
    from edgerunner_tpu_torch.parallel import make_layout
    from edgerunner_tpu_torch.train.trainer import Trainer
    from edgerunner_tpu_torch.weights import load_state

    layout = make_layout(torch.device("cpu"), dp=dp_size, ep=ep_size)
    dp, ep = layout.dp, layout.ep
    opt = Options(**kw)
    model = LMM(opt, ep=ep)
    trainer = Trainer(model, opt, total_steps=10, layout=layout)
    load_state(model, trainer.shard(state))
    for layer in model.mesh_decoder.model.layers:
        layer.dropout = 0.0
    trainer.init_state()
    seen, update = {}, trainer.optimizer.update

    def capture(grads):
        seen.update({n: g.clone() for n, g in grads.items()})
        return update(grads)

    trainer.optimizer.update = capture
    m = trainer.train_step(_rows(batch, 0 if dp is None else dp.rank, dp_size))
    out = {f"step0_{k}": np.float64(v) for k, v in m.items()}
    for name, p in trainer.params.items():
        expert = ep is not None and is_expert_param(name)
        out[f"grad/{name}"] = _full(seen[name], ep if expert else None).numpy()
        out[f"param/{name}"] = _full(p, ep if expert else None).numpy()
        out[f"own/{name}"] = p.detach().numpy().copy()
    if main_argv is not None:
        first = main.main(list(main_argv[0]))
        resumed = main.main(list(main_argv[1]))
        out["main_losses"] = np.asarray(first.losses)
        out["resumed_losses"] = np.asarray(resumed.losses)
        out["resumed_step"] = np.asarray(resumed.step)
    return out

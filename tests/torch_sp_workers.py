"""Rank processes of the port's sequence-parallel tests.

`spawn(fn, R, tmp_path, *args)` starts R CPU processes with
`torch.multiprocessing.spawn`; they join one gloo group through a `file://`
init method under tmp_path (parallel test workers never share a port), run
`fn(rank, R, tmp_path, *args)`, and each writes what it returns into
tmp_path/rank{r}.npz, which `spawn` reads back. A rank that raises fails
`spawn`. This module imports torch and the port only, so the children load
no JAX.
"""

import gc
import os

import numpy as np
import torch
import torch.multiprocessing as mp


def _entry(rank, R, tmp_path, fn, args):
    import torch.distributed as dist

    from edgerunner_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), rank=rank, world_size=R,
                     init_method=f"file://{os.path.join(tmp_path, 'init')}")
    try:
        out = fn(rank, R, tmp_path, *args)
    finally:
        # the run's groups, held by objects in reference cycles, released
        # before the process group is, and not at the interpreter's exit
        gc.collect()
        dist.destroy_process_group()
    np.savez(os.path.join(tmp_path, f"rank{rank}.npz"), **out)


def spawn(fn, R, tmp_path, *args):
    """[rank 0's dict, rank 1's, ...] of what fn returned on each rank."""
    tmp_path = str(tmp_path)
    os.makedirs(tmp_path, exist_ok=True)
    mp.spawn(_entry, args=(R, tmp_path, fn, args), nprocs=R, join=True)
    outs = []
    for r in range(R):
        with np.load(os.path.join(tmp_path, f"rank{r}.npz")) as f:
            outs.append(dict(f))
    return outs


# ------------------------------------------------------------------ ring ----

def ring_cases(rank, R, tmp_path, q, k, v, w):
    """Ring attention of the full arrays over the group, causal and not:
    outputs and the gradients of sum(out * w) summed over the ranks, and the
    row-5 calls this rank made in the forward and in the backward."""
    import torch.distributed as dist

    from edgerunner_tpu_torch.ops import ring_attention as RA
    from edgerunner_tpu_torch.parallel import SequenceParallel

    sp = SequenceParallel.world(torch.device("cpu"))
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = RA.flash_attention_lse, RA.flash_attention_lse_bwd

    def count_fwd(*a, **kw):
        calls["fwd"].append(kw["causal"])
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"].append(kw["causal"])
        return bwd(*a, **kw)

    RA.flash_attention_lse, RA.flash_attention_lse_bwd = count_fwd, count_bwd
    out = {}
    for causal in (True, False):
        calls["fwd"].clear()
        calls["bwd"].clear()
        x = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        o = RA.ring_self_attention(*x, sp, causal=causal)
        grads = torch.autograd.grad((o * torch.tensor(w)).sum(), x)
        for g in grads:
            dist.all_reduce(g)
        tag = "causal" if causal else "full"
        out[f"{tag}_out"] = o.detach().numpy()
        for name, g in zip("qkv", grads):
            out[f"{tag}_d{name}"] = g.numpy()
        for d in ("fwd", "bwd"):
            out[f"{tag}_{d}_calls"] = np.asarray(calls[d], np.int32)
    return out


# ----------------------------------------------------------------- train ----

def _trainer(kw, state, R, dropout: bool):
    from edgerunner_tpu_torch.config import Options
    from edgerunner_tpu_torch.models.lmm import LMM
    from edgerunner_tpu_torch.parallel import make_layout
    from edgerunner_tpu_torch.train.trainer import Trainer
    from edgerunner_tpu_torch.weights import load_state

    model = LMM(Options(**kw))
    load_state(model, state)
    if not dropout:
        for layer in model.mesh_decoder.model.layers:
            layer.dropout = 0.0
    layout = make_layout(torch.device("cpu"), sp=R) if R > 1 else None
    return Trainer(model, Options(**kw), total_steps=10, layout=layout)


def train_steps(rank, R, tmp_path, kw, state, batches, dropout, tag=""):
    """Trainer steps on `batches` from the weights `state`, the decoder's
    dropout on or off: every step's metrics, and every parameter after each
    step, under keys that start with `tag`."""
    trainer = _trainer(kw, state, R, dropout)
    trainer.init_state()
    out = {}
    for i, batch in enumerate(batches):
        m = trainer.train_step(batch)
        for key, val in m.items():
            out[f"{tag}step{i}_{key}"] = np.float64(val)
        for name, p in trainer.params.items():
            out[f"{tag}step{i}/{name}"] = p.detach().numpy().copy()
    return out


def train_runs(rank, R, tmp_path, runs):
    """`train_steps` of each (kw, state, batches, dropout, tag) in `runs`."""
    out = {}
    for run in runs:
        out.update(train_steps(rank, R, tmp_path, *run))
    return out


def main_run(rank, R, tmp_path, argv):
    """`edgerunner_tpu_torch.main` on this rank: its losses, its parameters,
    and how many checkpoints it wrote."""
    from edgerunner_tpu_torch import main
    from edgerunner_tpu_torch.train import checkpoint

    writes = []
    write = checkpoint.CheckpointManager._write

    def counted(self, tag, *a, **kw):
        writes.append(tag)
        return write(self, tag, *a, **kw)

    checkpoint.CheckpointManager._write = counted
    trainer = main.main(list(argv))
    out = {"losses": np.asarray(trainer.losses), "writes": np.asarray(len(writes))}
    for name, p in trainer.params.items():
        out[f"param/{name}"] = p.detach().numpy().copy()
    return out


def checksum_check(rank, R, tmp_path):
    """`assert_same_on_every_rank` of an equal value, then of the rank."""
    from edgerunner_tpu_torch.parallel import SequenceParallel, assert_same_on_every_rank

    sp = SequenceParallel.world(torch.device("cpu"))
    assert_same_on_every_rank(torch.tensor(1.5), "a shared value", sp)
    try:
        assert_same_on_every_rank(torch.tensor(float(rank)), "the rank", sp)
    except RuntimeError as exc:
        return {"raised": np.asarray(1), "message": np.asarray(str(exc))}
    return {"raised": np.asarray(0), "message": np.asarray("")}

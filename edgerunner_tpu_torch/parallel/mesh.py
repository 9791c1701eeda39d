"""Process groups and the sequence-parallel context of the port
(edgerunner_tpu/parallel/mesh.py: `maybe_initialize_distributed` :25,
`make_mesh` :60, `set_sequence_parallel` / `active_sequence_parallel`
:106-116).

The JAX package runs one controller over a mesh and lets GSPMD and
`ppermute` move the shards. Here every rank is a process: `init_distributed`
joins the torchrun world (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) or
a given init method (`file://...` in the tests), and the sp group is the
whole world, which is JAX's mesh of `sp_size` devices with dp = 1. Each rank
runs on `cuda:{LOCAL_RANK % device_count}` (`rank_device`).

The backend follows one rule (`choose_backend`): NCCL when every rank has a
card of its own, gloo when ranks share a card or run on the CPU (NCCL
refuses two ranks on one device). Gloo moves host memory, so under gloo the
collectives of CUDA tensors stage through pinned host buffers
(parallel/collectives.py); the kernels still run on the card.

`sequence_parallel(sp)` installs the context that ops/attention.py and the
decoder read, and clears it on exit, as the JAX trainer scopes its context
to its train and eval loops (trainer.py:235-244): generation and the eval
mesh dump never see it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, Optional

import torch
import torch.distributed as dist


def choose_backend(device: torch.device, world_size: int) -> str:
    """'nccl' when every rank has a card of its own, else 'gloo' (ranks that
    share a card, or ranks on the CPU)."""
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device_type: str) -> torch.device:
    """This rank's device: `cuda:{LOCAL_RANK % device_count}`, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(device: torch.device, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None, init_method: str = "env://") -> str:
    """Join the process group of `world_size` ranks (default: torchrun's
    WORLD_SIZE and RANK) by `init_method`, with the backend that
    `choose_backend` picks for `device`. Returns the backend."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    backend = choose_backend(device, world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return backend


@dataclasses.dataclass(frozen=True)
class SequenceParallel:
    """A sequence-parallel group: `size` ranks, each holding positions
    [rank * S, (rank + 1) * S) of every sequence. `staged` marks a gloo group
    over CUDA tensors, whose collectives go through pinned host buffers."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    staged: bool

    @classmethod
    def world(cls, device: torch.device) -> "SequenceParallel":
        """The group of every rank (dp = 1)."""
        staged = device.type == "cuda" and dist.get_backend() == "gloo"
        return cls(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), staged)

    def describe(self) -> str:
        """The backend choice, for rank 0's log."""
        backend = dist.get_backend(self.group)
        where = ("one card each" if backend == "nccl" else
                 "a shared card, staged through pinned host memory" if self.staged
                 else "the CPU")
        return f"[sp] {self.size} ranks on {where}: backend {backend}"

    def shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's equal share of `x` along `dim`."""
        T = x.shape[dim]
        if T % self.size:
            raise ValueError(f"length {T} does not divide over {self.size} sp ranks; "
                             "the trainer pads its batches to a multiple")
        S = T // self.size
        return x.narrow(dim, self.rank * S, S)


_SP: Optional[SequenceParallel] = None


@contextlib.contextmanager
def sequence_parallel(sp: Optional[SequenceParallel]) -> Iterator[None]:
    """Install `sp` (None or a group of one rank: nothing) for the body."""
    global _SP
    prev, _SP = _SP, (sp if sp is not None and sp.size > 1 else None)
    try:
        yield
    finally:
        _SP = prev


def active_sequence_parallel() -> Optional[SequenceParallel]:
    return _SP

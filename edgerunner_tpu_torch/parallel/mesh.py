"""Process groups and the parallel contexts of the port
(edgerunner_tpu/parallel/mesh.py: `maybe_initialize_distributed` :25,
`make_mesh` :60, `set_sequence_parallel` / `active_sequence_parallel`
:106-116).

The JAX package runs one controller over a mesh and lets GSPMD and
`ppermute` move the shards. Here every rank is a process: `init_distributed`
joins the torchrun world (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) or
a given init method (`file://...` in the tests), and `make_layout` lays the
world out as `make_mesh` lays out its devices: dp × sp ranks, dp outermost
and sp innermost (rank = d · sp + s), so that an sp group is a run of
consecutive ranks (`dp_for_world` holds the sizes to the world, dp -1
taking world / sp). With dp 1 the sp group is the whole world
(`SequenceParallel.world`). Each rank runs on
`cuda:{LOCAL_RANK % device_count}` (`rank_device`).

The backend follows one rule for the whole world (`choose_backend`): NCCL
when every rank has a card of its own, gloo when ranks share a card or run
on the CPU (NCCL refuses two ranks on one device). Gloo moves host memory,
so in a gloo group the collectives of CUDA tensors stage through pinned
host buffers (parallel/collectives.py); the kernels still run on the card.

`sequence_parallel(sp)` and `data_parallel(dp)` install the contexts that
ops/attention.py and the models read, and clear them on exit, as the JAX
trainer scopes its context to its train and eval loops (trainer.py:235-244):
generation and the eval mesh dump never see them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, Optional, Tuple

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
        """The group of every rank: the sp group when dp = 1, and the group
        over which a dp × sp trainer sums its gradients."""
        staged = device.type == "cuda" and dist.get_backend() == "gloo"
        return cls(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), staged)

    def placement(self) -> str:
        """Where the group's ranks run, and its backend."""
        backend = dist.get_backend(self.group)
        where = ("one card each" if backend == "nccl" else
                 "a shared card, staged through pinned host memory" if self.staged
                 else "the CPU")
        return f"{self.size} ranks on {where}: backend {backend}"

    def describe(self) -> str:
        """The backend choice, for rank 0's log."""
        return f"[sp] {self.placement()}"

    def shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's equal share of `x` along `dim`."""
        T = x.shape[dim]
        if T % self.size:
            raise ValueError(f"length {T} does not divide over {self.size} sp ranks; "
                             "the trainer pads its batches to a multiple")
        S = T // self.size
        return x.narrow(dim, self.rank * S, S)


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The dp axis of a dp × sp world: this rank is in dp group `rank` of
    `size`, each group of `sp_size` ranks holding the same rows; `world` is
    the group of every rank, over which gradients and metrics are summed."""

    rank: int
    size: int
    sp_size: int
    world: SequenceParallel

    def describe(self) -> str:
        """The layout and backend, for rank 0's log."""
        return f"[dp] {self.size} groups of {self.sp_size} sp rank(s), {self.world.placement()}"


def dp_for_world(dp_size: int, sp_size: int, world: int, module: str) -> int:
    """The dp size of a world of `world` ranks, by `make_mesh`'s rule
    (edgerunner_tpu/parallel/mesh.py:60-80): dp -1 takes world // sp; any
    dp × sp other than the world raises, naming the torchrun command that
    launches `module` with a matching world."""
    dp = world // sp_size if dp_size == -1 else dp_size
    if dp < 1 or dp * sp_size != world:
        dp = max(dp, 1)
        n = dp * sp_size
        raise RuntimeError(
            f"--dp_size {dp_size} x --sp_size {sp_size} needs {n} ranks (--dp_size -1 "
            f"takes the world / sp), and this world has {world}: launch with torchrun "
            f"--nproc_per_node {n} -m {module} ... --dp_size {dp} --sp_size {sp_size}")
    return dp


def make_layout(device: torch.device, dp_size: int, sp_size: int
                ) -> Tuple[Optional[DataParallel], Optional[SequenceParallel]]:
    """(dp, sp) of this rank in the initialised world of dp_size × sp_size
    ranks, laid out as `make_mesh` lays its devices: rank = d · sp + s, so
    the sp group of dp group d is ranks [d · sp, (d + 1) · sp). Every rank
    creates every sp group, in the same order (`dist.new_group` is
    collective). None stands for an axis of size 1."""
    world = SequenceParallel.world(device)
    if dp_size * sp_size != world.size:
        raise RuntimeError(f"dp {dp_size} x sp {sp_size} is not the world's {world.size} ranks")
    d, s = divmod(world.rank, sp_size)
    sp = None
    if sp_size > 1 and dp_size == 1:
        sp = world
    elif sp_size > 1:
        groups = [dist.new_group(list(range(g * sp_size, (g + 1) * sp_size)))
                  for g in range(dp_size)]
        sp = SequenceParallel(groups[d], s, sp_size, world.staged)
    dp = DataParallel(d, dp_size, sp_size, world) if dp_size > 1 else None
    return dp, sp


_SP: Optional[SequenceParallel] = None
_DP: Optional[DataParallel] = None


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


@contextlib.contextmanager
def data_parallel(dp: Optional[DataParallel]) -> Iterator[None]:
    """Install `dp` (None or one group: nothing) for the body: the losses
    become this rank's share of the dp groups' whole batch (models/lmm.py,
    models/mdit.py)."""
    global _DP
    prev, _DP = _DP, (dp if dp is not None and dp.size > 1 else None)
    try:
        yield
    finally:
        _DP = prev


def active_data_parallel() -> Optional[DataParallel]:
    return _DP

"""Process groups and the parallel contexts of the port
(edgerunner_tpu/parallel/mesh.py: `maybe_initialize_distributed` :25,
`make_mesh` :60-80, `set_sequence_parallel` / `active_sequence_parallel`
:106-116, `TP_RULES` and `param_shardings` :147-231, which the port's
models hold as each split parameter's `tp_split` mark, models/layers.py).

The JAX package runs one controller over a ('dp', 'pp', 'sp', 'tp', 'ep')
mesh and lets GSPMD, `shard_map` and `ppermute` move the shards. Here every
rank is a process: `init_distributed` joins the torchrun world (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) or a given init method
(`file://...` in the tests), and `make_layout` lays the world out as
`make_mesh` lays out its devices, dp outermost and ep innermost:

    rank = (((d · pp + p) · sp + s) · tp + t) · ep + e

so that the ranks of an sp, tp or ep group are close together. For each
axis of size above 1 the layout holds this rank's group along it (the
ranks that differ from it in that coordinate alone), and `data`, the ranks
that differ in d and s alone: they hold the same parameters and each a
share of the batch's rows (dp) or positions (sp), so gradients and metrics
are summed over them (train/trainer.py). `dp_for_world` holds the sizes to
the world (dp -1 takes the world / (pp · sp · tp · ep)). Each rank runs on
`cuda:{LOCAL_RANK % device_count}` (`rank_device`).

What each axis shards:
* dp  the rows of the batch; every parameter is whole on each dp group;
* pp  the decoder's layers, L / pp consecutive ones per rank
      (parallel/pipeline.py, models/shape_opt.py);
* sp  the positions of every sequence (ops/ring_attention.py);
* tp  the Megatron layout: attention heads and MLP columns
      (models/layers.py, models/shape_opt.py);
* ep  the experts of every MoE layer (models/moe.py).

The backend follows one rule (`choose_backend`), decided once by the ranks
of each machine: NCCL when every rank on it has a card of its own (across
torchrun's nodes too), gloo when ranks share a card or run on the CPU
(NCCL refuses two ranks on one device). An NCCL failure fails the run:
nothing falls back to gloo. Gloo moves host memory,
so in a gloo group the collectives of CUDA tensors stage through pinned
host buffers (parallel/collectives.py); the kernels still run on the card.

`sequence_parallel(sp)` and `data_parallel(dp)` install the contexts that
ops/attention.py and the models read, and clear them on exit, as the JAX
trainer scopes its context to its train and eval loops (trainer.py:235-244):
generation and the eval mesh dump never see them. The tp, pp and ep groups
are given to the models when they are built: a rank's model holds only its
shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("dp", "pp", "sp", "tp", "ep")


def local_world_size(world_size: int) -> int:
    """The ranks on this machine: torchrun's LOCAL_WORLD_SIZE, or the whole
    world when it is unset (`torch.multiprocessing.spawn` in one process)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def choose_backend(device: torch.device, world_size: int) -> str:
    """'nccl' when every rank of this machine has a card of its own (its
    `local_world_size` ranks at most its cards: `rank_device` gives local
    rank r card r), else 'gloo' (ranks that share a card, or ranks on the
    CPU). Decided per machine, so that `torchrun --nnodes N` takes NCCL
    when each node has a card per rank."""
    if device.type == "cuda" and local_world_size(world_size) <= torch.cuda.device_count():
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
class Group:
    """A group of `size` ranks, this one its rank `rank`. `staged` marks a
    gloo group over CUDA tensors, whose collectives go through pinned host
    buffers."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    staged: bool

    @classmethod
    def world(cls, device: torch.device):
        """The group of every rank."""
        staged = device.type == "cuda" and dist.get_backend() == "gloo"
        return cls(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), staged)

    def placement(self) -> str:
        """Where the group's ranks run, and its backend."""
        backend = dist.get_backend(self.group)
        where = ("one card each" if backend == "nccl" else
                 "a shared card, staged through pinned host memory" if self.staged
                 else "the CPU")
        return f"{self.size} ranks on {where}: backend {backend}"


@dataclasses.dataclass(frozen=True)
class SequenceParallel(Group):
    """A sequence-parallel group: each rank holds positions
    [rank * S, (rank + 1) * S) of every sequence."""

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
class TensorParallel(Group):
    """A Megatron tensor-parallel group: each rank holds its share of the
    heads and MLP columns (models/layers.py), and the same rows."""

    def describe(self) -> str:
        return f"[tp] groups of {self.size} ranks, {self.placement()}"


@dataclasses.dataclass(frozen=True)
class PipelineParallel(Group):
    """A GPipe group: rank p holds the decoder's layers [p · L/S, (p + 1) ·
    L/S) and runs them on `microbatches` microbatches of every batch
    (parallel/pipeline.py)."""

    microbatches: int = 1

    def describe(self) -> str:
        return (f"[pp] {self.size} stages, {self.microbatches} microbatches, "
                f"{self.placement()}")


@dataclasses.dataclass(frozen=True)
class ExpertParallel(Group):
    """An expert-parallel group: its ranks hold the same rows, each E / ep
    of every MoE layer's experts, experts [rank · E/ep, (rank + 1) · E/ep)
    (models/moe.py)."""

    def describe(self) -> str:
        return f"[ep] groups of {self.size} ranks, {self.placement()}"


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The dp axis: this rank is in dp group `rank` of `size`, each group of
    sp × pp × tp × ep ranks holding the same rows. `data` is the group of
    ranks that hold this rank's parameters, one per (dp, sp) coordinate,
    in the order d · sp + s; `world` is every rank."""

    rank: int
    size: int
    sp_size: int
    world: Group
    data: Group

    def describe(self) -> str:
        """The layout and backend, for rank 0's log."""
        per = self.world.size // self.size
        return f"[dp] {self.size} groups of {per} rank(s), {self.world.placement()}"


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in a dp × pp × sp × tp × ep world: `coords` and
    `sizes` by axis name, the group along each axis of size above 1 (None
    for the others), `world`, `data` (the ranks over which gradients and
    metrics are summed) and `model` (the pp × tp × ep ranks that together
    hold one copy of the model); None for a group of this rank alone."""

    world: Group
    coords: Dict[str, int]
    sizes: Dict[str, int]
    dp: Optional[DataParallel] = None
    pp: Optional[PipelineParallel] = None
    sp: Optional[SequenceParallel] = None
    tp: Optional[TensorParallel] = None
    ep: Optional[ExpertParallel] = None
    data: Optional[Group] = None
    model: Optional[Group] = None

    def describe(self) -> list:
        """One log line per axis of size above 1."""
        return [a.describe() for a in (self.dp, self.pp, self.sp, self.tp, self.ep)
                if a is not None]


def dp_for_world(dp_size: int, sp_size: int, world: int, module: str, ep_size: int = 1,
                 tp_size: int = 1, pp_size: int = 1) -> int:
    """The dp size of a world of `world` ranks, by `make_mesh`'s rule
    (edgerunner_tpu/parallel/mesh.py:60-80): dp -1 takes world // (pp · sp
    · tp · ep); any dp × pp × sp × tp × ep other than the world raises,
    naming the torchrun command that launches `module` with a matching
    world."""
    inner = pp_size * sp_size * tp_size * ep_size
    dp = world // inner if dp_size == -1 else dp_size
    if dp < 1 or dp * inner != world:
        dp = max(dp, 1)
        n = dp * inner
        others = [(name, size) for name, size in (("pp", pp_size), ("tp", tp_size),
                                                  ("ep", ep_size)) if size > 1]
        product = "".join(f" x --{name}_size {size}" for name, size in others)
        flags = "".join(f" --{name}_size {size}" for name, size in others)
        raise RuntimeError(
            f"--dp_size {dp_size} x --sp_size {sp_size}{product} needs {n} ranks (--dp_size "
            f"-1 takes the world / (pp x sp x tp x ep)), and this world has {world}: launch "
            f"with torchrun --nproc_per_node {n} -m {module} ... --dp_size {dp} --sp_size "
            f"{sp_size}{flags}")
    return dp


def make_layout(device: torch.device, dp: int = 1, pp: int = 1, sp: int = 1, tp: int = 1,
                ep: int = 1, microbatches: int = 0) -> Layout:
    """This rank's `Layout` in the initialised world of dp × pp × sp × tp ×
    ep ranks, placed as `make_mesh` places its devices (rank = (((d · pp +
    p) · sp + s) · tp + t) · ep + e). Every rank creates every group, in the
    same order (`dist.new_group` is collective); an axis that spans the
    whole world takes the world's group. `microbatches` (0: pp) is the
    pipeline's."""
    world = Group.world(device)
    sizes = dict(zip(AXES, (dp, pp, sp, tp, ep)))
    if dp * pp * sp * tp * ep != world.size:
        raise RuntimeError(f"dp {dp} x pp {pp} x sp {sp} x tp {tp} x ep {ep} is not the "
                           f"world's {world.size} ranks")
    shape = [sizes[a] for a in AXES]
    coords, r = {}, world.rank
    for a in reversed(AXES):
        r, coords[a] = divmod(r, sizes[a])

    def rank_of(c: dict) -> int:
        out = 0
        for a, n in zip(AXES, shape):
            out = out * n + c[a]
        return out

    def groups(varying: tuple) -> Optional[Tuple[dist.ProcessGroup, int, int]]:
        """(this rank's group over the `varying` axes, its rank in it, size),
        every such group of the world created; None for a group of one."""
        size = 1
        for a in varying:
            size *= sizes[a]
        if size == 1:
            return None
        if size == world.size:
            return world.group, world.rank, size
        fixed = [a for a in AXES if a not in varying]
        mine = None
        for outer in itertools.product(*(range(sizes[a]) for a in fixed)):
            base = dict(zip(fixed, outer))
            members = sorted(rank_of({**base, **dict(zip(varying, inner))})
                             for inner in itertools.product(*(range(sizes[a])
                                                              for a in varying)))
            g = dist.new_group(members)
            if world.rank in members:
                mine = (g, members.index(world.rank), size)
        return mine

    def axis(cls, name, **kw):
        g = groups((name,))
        return None if g is None else cls(*g, world.staged, **kw)

    data_g, model_g = groups(("dp", "sp")), groups(("pp", "tp", "ep"))
    data = None if data_g is None else Group(*data_g, world.staged)
    layout = Layout(
        world=world, coords=coords, sizes=sizes,
        dp=(DataParallel(coords["dp"], dp, sp, world, data) if dp > 1 else None),
        pp=axis(PipelineParallel, "pp", microbatches=microbatches or pp),
        sp=axis(SequenceParallel, "sp"), tp=axis(TensorParallel, "tp"),
        ep=axis(ExpertParallel, "ep"), data=data,
        model=None if model_g is None else Group(*model_g, world.staged))
    return layout


def tp_slice(x, rank: int, size: int, dim: int, parts: int = 1):
    """Rank `rank`'s share of the whole tensor (or array) `x` split over
    `size` ranks along `dim` in `parts` groups: of each group, the rank's
    contiguous chunk. A fused qkv_proj's columns are [all q | all k | all
    v] (3 groups) and GEGLU's fc_in's [h | gates] (2 groups)."""
    n = x.shape[dim] // parts
    chunk = n // size
    pieces = [x[(slice(None),) * dim + (slice(g * n + rank * chunk, g * n + (rank + 1) * chunk),)]
              for g in range(parts)]
    if parts == 1:
        return pieces[0]
    if isinstance(x, torch.Tensor):
        return torch.cat(pieces, dim)
    import numpy as np

    return np.concatenate(pieces, dim)


def tp_join(shards: list, dim: int, parts: int = 1) -> torch.Tensor:
    """The whole tensor from the ranks' shards (in rank order): the inverse
    of `tp_slice`."""
    if parts == 1:
        return torch.cat(shards, dim)
    split = [s.chunk(parts, dim) for s in shards]
    return torch.cat([split[r][g] for g in range(parts) for r in range(len(shards))], dim)


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

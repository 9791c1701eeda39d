"""How a training rank joins the dp × sp world, logs and takes its share of
the data: shared by the training CLIs (`main`, `main_dit`)."""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from edgerunner_tpu_torch.data.dataset import shard_items_for_host
from edgerunner_tpu_torch.parallel import (
    DataParallel,
    SequenceParallel,
    dp_for_world,
    init_distributed,
    make_layout,
    rank_device,
)
from edgerunner_tpu_torch.utils import init_logger


def run_ranks(opt, device: torch.device, module: str, train_fn):
    """`train_fn(opt, device, sp, dp)` on this rank of a world of dp × sp
    ranks (`dp_for_world`'s rule; a world of one runs unsharded): joins the
    torchrun world unless one is initialised, lays it out (`make_layout`)
    and leaves it on exit."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    dp_size = dp_for_world(opt.dp_size, opt.sp_size, world, module)
    if world == 1:
        return train_fn(opt, device)
    device = rank_device(device.type)
    owned = not dist.is_initialized()
    if owned:
        init_distributed(device)
    try:
        dp, sp = make_layout(device, dp_size, opt.sp_size)
        return train_fn(opt, device, sp, dp)
    finally:
        if owned:
            dist.destroy_process_group()


def rank_logger(opt, dp: Optional[DataParallel], sp: Optional[SequenceParallel]):
    """The workspace's log.txt on rank 0 of the world; a disabled logger on
    every other rank."""
    os.makedirs(opt.workspace, exist_ok=True)
    world = dp.world if dp is not None else sp
    if world is None or world.rank == 0:
        logger = init_logger(os.path.join(opt.workspace, "log.txt"))
    else:
        logger = logging.getLogger(f"edgerunner_tpu_torch.rank{world.rank}")
        logger.disabled = True
    logger.info(str(opt))
    for axis in (dp, sp):
        if axis is not None:
            logger.info(axis.describe())
    return logger


def shard_train_items(dataset, dp: Optional[DataParallel], logger):
    """Each dp group's disjoint, equal share of a dataset's items (the JAX
    main's per-host split, main.py:93-101); a dataset without items (the
    synthetic set) is left whole."""
    if dp is not None and getattr(dataset, "items", None):
        dataset.items = shard_items_for_host(dataset.items, dp.rank, dp.size)
        logger.info(f"dp group {dp.rank}/{dp.size}: {len(dataset.items)} train items")

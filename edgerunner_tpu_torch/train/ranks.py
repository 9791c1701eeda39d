"""How a training rank joins the dp × pp × sp × tp × ep world, logs and
takes its share of the data: shared by the training CLIs (`main`,
`main_dit`)."""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from edgerunner_tpu_torch.data.dataset import shard_items_for_host
from edgerunner_tpu_torch.parallel import (
    DataParallel,
    Layout,
    dp_for_world,
    init_distributed,
    make_layout,
    rank_device,
)
from edgerunner_tpu_torch.utils import init_logger


def run_ranks(opt, device: torch.device, module: str, train_fn):
    """`train_fn(opt, device, layout)` on this rank of a world of dp × pp ×
    sp × tp × ep ranks (`dp_for_world`'s rule; a world of one runs
    unsharded, as `train_fn(opt, device)`): joins the torchrun world unless
    one is initialised, lays it out (`make_layout`) and leaves it on exit."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    dp_size = dp_for_world(opt.dp_size, opt.sp_size, world, module, opt.ep_size,
                           opt.tp_size, opt.pp_size)
    if world == 1:
        return train_fn(opt, device)
    device = rank_device(device.type)
    owned = not dist.is_initialized()
    if owned:
        init_distributed(device)
    try:
        layout = make_layout(device, dp_size, opt.pp_size, opt.sp_size, opt.tp_size,
                             opt.ep_size, opt.pp_microbatches)
        return train_fn(opt, device, layout)
    finally:
        if owned:
            dist.destroy_process_group()


def rank_logger(opt, layout: Optional[Layout]):
    """The workspace's log.txt on rank 0 of the world; a disabled logger on
    every other rank."""
    os.makedirs(opt.workspace, exist_ok=True)
    if layout is None or layout.world.rank == 0:
        logger = init_logger(os.path.join(opt.workspace, "log.txt"))
    else:
        logger = logging.getLogger(f"edgerunner_tpu_torch.rank{layout.world.rank}")
        logger.disabled = True
    logger.info(str(opt))
    for line in ([] if layout is None else layout.describe()):
        logger.info(line)
    return logger


def shard_train_items(dataset, dp: Optional[DataParallel], logger):
    """Each dp group's disjoint, equal share of a dataset's items (the JAX
    main's per-host split, main.py:93-101); a dataset without items (the
    synthetic set) is left whole."""
    if dp is not None and getattr(dataset, "items", None):
        dataset.items = shard_items_for_host(dataset.items, dp.rank, dp.size)
        logger.info(f"dp group {dp.rank}/{dp.size}: {len(dataset.items)} train items")

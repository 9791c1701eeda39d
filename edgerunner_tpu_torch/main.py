"""ArAE training CLI of the port (the counterpart of main.py:40-270).

    python -m edgerunner_tpu_torch.main ArAE --data_root ./data \\
        --workspace ./workspace [--device cuda|cpu] [--flags]

Data: a local directory of .obj/.ply meshes (optionally listed with their
face counts in a manifest.json); the synthetic procedural dataset when
data_root does not exist. Weights start from `--seed`, or from a
`.safetensors` file the port wrote (`--resume`, loaded strictly); with
`--resume_train_state` the step, the optimizer state and the loader's
position come back too, and training continues exactly. Each epoch saves a
checkpoint (train/checkpoint.py); with `--eval_mode loss` the held-out loss
is logged and one batch's ground-truth and argmax meshes are written. With
`--ema_decay` the weights' moving average is kept, saved beside each
checkpoint, restored on resume and evaluated too. The
model trains on the card unless `--device cpu` is given; without a card and
without `--device cpu` it raises.

Sequence parallelism (the sequence of every batch split over N ranks, the
decoder's attention as a ring; train/trainer.py) runs one process per rank:

    torchrun --nproc_per_node N -m edgerunner_tpu_torch.main ArAE --sp_size N ...

Rank r runs on `cuda:{LOCAL_RANK % device_count}` (or the CPU with
`--device cpu`), over NCCL when every rank has a card of its own and gloo
otherwise (parallel/mesh.py). `--sp_size` must equal the world's size: a
mismatch raises, it never trains unsharded. Rank 0 logs and writes the
checkpoints; the process group is destroyed on exit.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from edgerunner_tpu_torch.config import parse_cli, validate
from edgerunner_tpu_torch.data import save_mesh
from edgerunner_tpu_torch.data.dataset import DataLoader, MeshFolderDataset, SyntheticMeshDataset
from edgerunner_tpu_torch.infer import resolve_device
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.parallel import SequenceParallel, init_distributed, rank_device
from edgerunner_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_train_state,
    sibling_ema_path,
)
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.utils import get_tokenizer, init_logger
from edgerunner_tpu_torch.weights import load_state, read_safetensors


def save_eval_meshes(trainer: Trainer, test_loader, opt, tokenizer, epoch: int):
    """Ground-truth and argmax-predicted meshes of one held-out batch
    (reference: main.py:253-264)."""
    batch = next(iter(test_loader))
    logits = trainer.eval_step(batch)["logits"]
    C = opt.num_cond_tokens
    n_tok = int(batch["num_tokens"][0])
    coords = np.asarray(batch["labels"][0])[C + 1:n_tok - 1]
    pred = logits[0].argmax(-1).cpu().numpy()[C:n_tok - 2]
    save_mesh(coords, opt, os.path.join(opt.workspace, f"test_ep{epoch}_gt.obj"),
              tokenizer=tokenizer)
    save_mesh(pred, opt, os.path.join(opt.workspace, f"test_ep{epoch}.obj"),
              tokenizer=tokenizer)


def main(argv: Optional[List[str]] = None) -> Trainer:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    device = resolve_device(args.device)
    opt = validate(parse_cli(rest, prog="python -m edgerunner_tpu_torch.main"))
    if opt.cond_mode == "point_latent":
        raise ValueError("cond_mode 'point_latent' takes the DiT's latents "
                         "(edgerunner_tpu_torch.infer_dit, serve --resume2); main trains "
                         "the ArAE on point clouds, and the DiT that makes the latents "
                         "trains with python -m edgerunner_tpu_torch.main_dit DiT")
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if opt.sp_size != world:
        raise RuntimeError(
            f"--sp_size {opt.sp_size} needs as many ranks, and this world has {world}: "
            f"launch with torchrun --nproc_per_node {opt.sp_size} -m "
            f"edgerunner_tpu_torch.main ... --sp_size {opt.sp_size}")
    if world == 1:
        return train(opt, device)
    device = rank_device(device.type)
    owned = not dist.is_initialized()
    if owned:
        init_distributed(device)
    try:
        return train(opt, device, SequenceParallel.world(device))
    finally:
        if owned:
            dist.destroy_process_group()


def train(opt, device: torch.device, sp: Optional[SequenceParallel] = None) -> Trainer:
    """The training run of `main` on this rank."""
    os.makedirs(opt.workspace, exist_ok=True)
    if sp is None or sp.rank == 0:
        logger = init_logger(os.path.join(opt.workspace, "log.txt"))
    else:
        logger = logging.getLogger(f"edgerunner_tpu_torch.rank{sp.rank}")
        logger.disabled = True
    logger.info(str(opt))
    if sp is not None:
        logger.info(sp.describe())
    if opt.resume is None and opt.warmup_ratio == 0 and opt.lr > 1.5e-4:
        logger.warning(
            "training from scratch with warmup_ratio=0 and lr "
            f"{opt.lr:g}: the post-LN decoder is likely to collapse to "
            "unigram predictions (see evidence/warmup_study.md). "
            "Recommended: --warmup_ratio 0.01 or more, or lr <= 1e-4.")

    tokenizer, _ = get_tokenizer(opt)
    if os.path.isdir(opt.data_root):
        train_dataset = MeshFolderDataset(opt, training=True, tokenizer=tokenizer)
        test_dataset = MeshFolderDataset(opt, training=False, tokenizer=tokenizer)
    else:
        logger.warning(f"data_root {opt.data_root} not found; using synthetic data")
        train_dataset = SyntheticMeshDataset(opt, size=opt.synthetic_size, training=True,
                                             tokenizer=tokenizer)
        test_dataset = SyntheticMeshDataset(opt, size=max(opt.synthetic_size // 16, 4),
                                            training=False, tokenizer=tokenizer)
    logger.info(f"train dataset size: {len(train_dataset)}")
    logger.info(f"test dataset size: {len(test_dataset)}")
    train_loader = DataLoader(train_dataset, opt, opt.batch_size, shuffle=True, seed=opt.seed)
    test_loader = DataLoader(test_dataset, opt, opt.batch_size, shuffle=False,
                             drop_last=False, seed=opt.seed)

    total_steps = opt.num_epochs * len(train_loader) // opt.gradient_accumulation_steps
    model = init_weights(LMM(opt, device=device), opt.seed)
    trainer = Trainer(model, opt, total_steps, logger=logger, sp=sp)
    manager = CheckpointManager(opt.workspace, keep=2, sp=sp)

    start_epoch, resume_step, opt_state_path = 0, 0, None
    if opt.resume is not None:
        load_state(model, read_safetensors(opt.resume))
        logger.info(f"loaded weights from {opt.resume}")
        if opt.resume_train_state:
            start_epoch, resume_step, opt_state_path = restore_train_state(
                opt.resume, train_loader, manager, logger)
    num_params = sum(p.numel() for p in model.parameters())
    logger.info(f"total param count: {num_params / 1e6:.3f} M")
    ema_path = sibling_ema_path(opt.resume) if opt.ema_decay > 0 and opt.resume else None
    trainer.init_state(step=resume_step, opt_state_path=opt_state_path, ema_path=ema_path)

    def on_step(step, metrics):
        if opt.save_every_steps and step % opt.save_every_steps == 0:
            manager.save_step(step, model,
                              trainer.optimizer if opt.save_optimizer_state else None,
                              train_state={"step": step, "loader": train_loader.state()},
                              log=logger.info, ema=trainer.ema)

    for epoch in range(start_epoch, opt.num_epochs):
        if not opt.debug_eval:
            avg_loss = trainer.train_epoch(train_loader, epoch, on_step=on_step)
            if (opt.save_every_epochs <= 1 or (epoch + 1) % opt.save_every_epochs == 0
                    or epoch == opt.num_epochs - 1):
                manager.save_epoch(
                    epoch, model, trainer.optimizer if opt.save_optimizer_state else None,
                    loss=avg_loss,
                    train_state={"step": trainer.step, "loader": train_loader.state()},
                    log=logger.info, ema=trainer.ema)
        else:
            logger.info(f"epoch: {epoch} skip training for debug !!!")
        if opt.eval_mode == "loss":
            trainer.eval_epoch(test_loader, epoch)
            if trainer.ema is not None:
                trainer.eval_epoch(test_loader, epoch, use_ema=True)
            if not trainer.is_main:
                continue
            # meto streams may be invalid early in training: a failed dump is
            # logged and training goes on, as in the reference
            try:
                save_eval_meshes(trainer, test_loader, opt, tokenizer, epoch)
            except Exception as e:  # noqa: BLE001
                logger.warning(f"failed to save validation mesh: {e}")
    return trainer


if __name__ == "__main__":
    main()

"""DiT training CLI of the port (the counterpart of main_dit.py:50-153;
reference: main_dit.py:33-238).

    python -m edgerunner_tpu_torch.main_dit DiT --data_root ./data \\
        --workspace ./workspace_dit [--resume arae.safetensors] \\
        [--resume2 mdit.safetensors [--resume_train_state]] [--device cuda|cpu]

Trains the MDiT (models/mdit.py): the DiT denoiser with proj_cond and
norm_cond, on the frozen CLIP tower's image features and the frozen point
encoder's latents. Data: a local directory of meshes, each with render
views beside it or rendered as a point splat (data/dataset_dit.py); the
synthetic procedural meshes when data_root does not exist. Weights start
from `--seed` (`init_mdit_weights`); `--resume` (an ArAE checkpoint, whose
`point_encoder.*` entries give the point encoder) and then `--resume2` (an
MDiT checkpoint) are merged over them, each entry whose name and shape
match (`tolerant_merge`). With `--resume_train_state` the step, the
optimizer state, the loader's position and the EMA come back from
`--resume2`'s checkpoint, and training continues exactly. Each epoch (or
every `save_every_epochs`, and every `save_every_steps` steps) saves an MDiT
`.safetensors` that `infer_dit --resume2` and `serve --resume2` load
strictly; with `--eval_mode loss` the held-out loss (and the EMA's) is
logged (`--eval_mode generate` evaluates nothing here, as in the JAX
package); `--async_checkpointing true` writes each save on a background
thread (train/checkpoint.py). The model trains on the card, under bf16 autocast with
`mixed_precision` bf16, unless `--device cpu` is given (f32); without a card
and without `--device cpu` it raises.

Data parallelism, one process per rank (train/trainer.py):

    torchrun --nproc_per_node N -m edgerunner_tpu_torch.main_dit DiT --dp_size N ...

Each rank trains on its own equal shard of the data's items (the synthetic
set is not sharded), `--batch_size` rows per rank; the gradients are summed
over the ranks. Rank 0 logs and writes the checkpoints. `--tp_size T`
(T × D ranks) splits the DiT's feed-forwards and the frozen towers'
attention and MLPs over T ranks, as the JAX DiT step shares the Trainer's
tp mesh (main_dit.py:84); the saves hold whole tensors. `--sp_size`,
`--pp_size` and `--ep_size` stay `main`'s: the JAX package's DiT step has
no sequence parallelism either, the MDiT no ShapeOPT layers to stage and
no experts.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from edgerunner_tpu_torch.config import parse_cli, validate
from edgerunner_tpu_torch.data.dataset import DataLoader
from edgerunner_tpu_torch.data.dataset_dit import DiTMeshDataset, collate_dit
from edgerunner_tpu_torch.infer import resolve_device
from edgerunner_tpu_torch.main import seeded_weights
from edgerunner_tpu_torch.models.mdit import MDiT
from edgerunner_tpu_torch.parallel import Layout
from edgerunner_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_train_state,
    sibling_ema_path,
)
from edgerunner_tpu_torch.train.ranks import rank_logger, run_ranks, shard_train_items
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.weights import (
    init_mdit_weights,
    load_state,
    read_safetensors,
    reference_state_dict,
    tolerant_merge,
)


def main(argv: Optional[List[str]] = None) -> Trainer:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    device = resolve_device(args.device)
    opt = validate(parse_cli(rest, prog="python -m edgerunner_tpu_torch.main_dit"))
    if opt.sp_size != 1 or opt.ep_size != 1 or opt.pp_size != 1:
        # the MDiT has no ShapeOPT layer stack for the JAX pipeline to stage:
        # under pp the JAX DiT step would run the same batch on every device
        raise ValueError("main_dit splits batches over ranks by rows (--dp_size) and its "
                         "feed-forwards and towers by --tp_size; --sp_size, --pp_size and "
                         "--ep_size are main's")
    return run_ranks(opt, device, "edgerunner_tpu_torch.main_dit", train)


def train(opt, device: torch.device, layout: Optional[Layout] = None) -> Trainer:
    """The training run of `main` on this rank."""
    logger = rank_logger(opt, layout)
    dp = None if layout is None else layout.dp

    train_dataset = DiTMeshDataset(opt, training=True)
    test_dataset = DiTMeshDataset(opt, training=False)
    if train_dataset.synthetic is not None:
        logger.warning(f"data_root {opt.data_root} not found; using synthetic data")
    shard_train_items(train_dataset, dp, logger)
    logger.info(f"train dataset size: {len(train_dataset)}")
    train_loader = DataLoader(train_dataset, opt, opt.batch_size, shuffle=True, seed=opt.seed,
                              collate_fn=collate_dit)
    test_loader = DataLoader(test_dataset, opt, opt.batch_size, shuffle=False,
                             drop_last=False, seed=opt.seed, collate_fn=collate_dit)

    total_steps = opt.num_epochs * len(train_loader) // opt.gradient_accumulation_steps
    tp = None if layout is None else layout.tp
    model = MDiT(opt, device=device, tp=tp)
    trainer = Trainer(model, opt, total_steps, logger=logger, kind="dit", layout=layout)
    seeded_weights(model, trainer, lambda dev: MDiT(opt, device=dev), opt.seed,
                   init=init_mdit_weights)
    # --resume: the ArAE checkpoint that carries the pretrained point
    # encoder; --resume2: the MDiT itself (reference: main_dit.py:55-88)
    for path in (opt.resume, opt.resume2):
        if path is not None:
            load_state(model, tolerant_merge(reference_state_dict(model),
                                             trainer.shard(read_safetensors(path)),
                                             align_posemb=opt.align_posemb,
                                             log=logger.warning))
            logger.info(f"merged weights from {path}")
    manager = CheckpointManager(opt.workspace, keep=2, group=trainer.world,
                                async_save=opt.async_checkpointing)

    start_epoch, resume_step, opt_state_path = 0, 0, None
    if opt.resume_train_state and opt.resume2 is not None:
        start_epoch, resume_step, opt_state_path = restore_train_state(
            opt.resume2, train_loader, manager, logger)
    num_params = sum(p.numel() for p in model.parameters())
    logger.info(f"total param count: {num_params / 1e6:.3f} M, trainable "
                f"{sum(p.numel() for p in trainer.params.values()) / 1e6:.3f} M")
    ema_path = sibling_ema_path(opt.resume2) if opt.ema_decay > 0 and opt.resume2 else None
    trainer.init_state(step=resume_step, opt_state_path=opt_state_path, ema_path=ema_path)

    def save(save_fn, *args, **kw):
        weights, optimizer, ema = trainer.checkpoint_parts(opt.save_optimizer_state)
        save_fn(*args, weights, optimizer, ema=ema, log=logger.info, **kw)

    def on_step(step, metrics):
        if opt.save_every_steps and step % opt.save_every_steps == 0:
            save(manager.save_step, step,
                 train_state={"step": step, "loader": train_loader.state()})

    for epoch in range(start_epoch, opt.num_epochs):
        if not opt.debug_eval:
            avg_loss = trainer.train_epoch(train_loader, epoch, on_step=on_step)
            if (opt.save_every_epochs <= 1 or (epoch + 1) % opt.save_every_epochs == 0
                    or epoch == opt.num_epochs - 1):
                save(manager.save_epoch, epoch, loss=avg_loss,
                     train_state={"step": trainer.step, "loader": train_loader.state()})
        else:
            logger.info(f"epoch: {epoch} skip training for debug !!!")
        if opt.eval_mode == "loss":
            trainer.eval_epoch(test_loader, epoch)
            if trainer.ema is not None:
                # the EMA is what gets deployed; its loss is tracked too
                trainer.eval_epoch(test_loader, epoch, use_ema=True)
    # the last asynchronous save on disk, and its bookkeeping
    manager.wait(log=logger.info)
    return trainer


if __name__ == "__main__":
    main()

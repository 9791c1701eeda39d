"""ArAE training CLI of the port (the counterpart of main.py:40-270).

    python -m edgerunner_tpu_torch.main ArAE --data_root ./data \\
        --workspace ./workspace [--device cuda|cpu] [--flags]
    python -m edgerunner_tpu_torch.main default ...   (image-conditioned)

Data: a local directory of .obj/.ply meshes (optionally listed with their
face counts in a manifest.json); the synthetic procedural dataset when
data_root does not exist. In image mode (the default preset) each mesh is
paired with a render view beside it, or with a point-splat render of its
surface (data/dataset.py), and the CLIP tower stays frozen under
`freeze_encoder`: it takes no optimizer state and is saved with the rest.
Weights start from `--seed`; `--resume` merges a `.safetensors` file over
them as the JAX package's main does (`merge_checkpoint`: entries whose name
and shape match are taken, position embeddings of another length realigned
by `--align_posemb`, every missing, mismatched and unexpected entry
logged); `--resume2` then merges a second, possibly
partial file over them (`overlay_checkpoint`: a pretrained CLIP tower, in
the port's or HuggingFace's naming); with `--resume_train_state` the step,
the optimizer state and the loader's position come back too, and training
continues exactly. Each epoch saves a
checkpoint (train/checkpoint.py); with `--eval_mode loss` the held-out loss
is logged and one batch's ground-truth and argmax meshes are written. With
`--ema_decay` the weights' moving average is kept, saved beside each
checkpoint, restored on resume and evaluated too. The
model trains on the card unless `--device cpu` is given; without a card and
without `--device cpu` it raises.

Data and sequence parallelism (train/trainer.py) run one process per rank,
dp × sp ranks in all:

    torchrun --nproc_per_node N -m edgerunner_tpu_torch.main ArAE --dp_size N
    torchrun --nproc_per_node N*M -m edgerunner_tpu_torch.main ArAE --dp_size N --sp_size M

Each of the dp groups trains on its own shard of the data's items
(`shard_items_for_host`; the synthetic set is not sharded), `--batch_size`
rows per rank, so the global batch is batch_size × dp; the M ranks of a dp
group split each sequence, the decoder's attention as a ring. `--dp_size
-1`, the default, takes world / sp. Rank r runs on
`cuda:{LOCAL_RANK % device_count}` (or the CPU with `--device cpu`), over
NCCL when every rank has a card of its own and gloo otherwise
(parallel/mesh.py). A dp × sp other than the world's size raises: it never
trains unsharded. Rank 0 logs and writes the checkpoints; every dp group
evaluates the whole test set; the process group is destroyed on exit.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from edgerunner_tpu_torch.config import parse_cli, validate
from edgerunner_tpu_torch.data import save_mesh
from edgerunner_tpu_torch.data.dataset import (
    DataLoader,
    MeshFolderDataset,
    SyntheticMeshDataset,
)
from edgerunner_tpu_torch.infer import resolve_device
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.parallel import DataParallel, SequenceParallel
from edgerunner_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_train_state,
    sibling_ema_path,
)
from edgerunner_tpu_torch.train.ranks import rank_logger, run_ranks, shard_train_items
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.utils import get_tokenizer
from edgerunner_tpu_torch.weights import merge_checkpoint, overlay_checkpoint, read_safetensors


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
    return run_ranks(opt, device, "edgerunner_tpu_torch.main", train)


def train(opt, device: torch.device, sp: Optional[SequenceParallel] = None,
          dp: Optional[DataParallel] = None) -> Trainer:
    """The training run of `main` on this rank."""
    logger = rank_logger(opt, dp, sp)
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
    shard_train_items(train_dataset, dp, logger)
    logger.info(f"train dataset size: {len(train_dataset)}")
    logger.info(f"test dataset size: {len(test_dataset)}")
    train_loader = DataLoader(train_dataset, opt, opt.batch_size, shuffle=True, seed=opt.seed)
    test_loader = DataLoader(test_dataset, opt, opt.batch_size, shuffle=False,
                             drop_last=False, seed=opt.seed)

    total_steps = opt.num_epochs * len(train_loader) // opt.gradient_accumulation_steps
    model = init_weights(LMM(opt, device=device), opt.seed)
    trainer = Trainer(model, opt, total_steps, logger=logger, sp=sp, dp=dp)
    manager = CheckpointManager(opt.workspace, keep=2, group=trainer.world)

    start_epoch, resume_step, opt_state_path = 0, 0, None
    if opt.resume is not None:
        merge_checkpoint(model, read_safetensors(opt.resume), opt.align_posemb,
                         log=logger.warning)
        logger.info(f"loaded weights from {opt.resume}")
        if opt.resume_train_state:
            start_epoch, resume_step, opt_state_path = restore_train_state(
                opt.resume, train_loader, manager, logger)
    if opt.resume2 is not None:
        overlay_checkpoint(model, opt.resume2, opt.align_posemb, log=logger.warning)
        logger.info(f"merged secondary checkpoint from {opt.resume2}")
    num_params = sum(p.numel() for p in model.parameters())
    logger.info(f"total param count: {num_params / 1e6:.3f} M, trainable "
                f"{sum(p.numel() for p in trainer.params.values()) / 1e6:.3f} M")
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

"""ArAE training CLI of the port (the counterpart of main.py:40-270).

    python -m edgerunner_tpu_torch.main ArAE --data_root ./data \\
        --workspace ./workspace [--device cuda|cpu] [--flags]
    python -m edgerunner_tpu_torch.main default ...   (image-conditioned)

Data: a directory of .obj/.ply meshes (optionally listed with their face
counts in a manifest.json), local or remote: an http(s) or s3 root whose
manifest.json lists them, each fetched when read (data/fetch.py, data/s3.py);
with `--dataset objxl`, a colon-separated list of local roots, mixed
(`MixedDataset`; the first root also gives the test split); the synthetic
procedural dataset when data_root does not exist. In image mode (the
default preset) each mesh is paired with a render view beside it, or with
a point-splat render of its surface (data/dataset.py), and the CLIP tower
stays frozen under `freeze_encoder`: it takes no optimizer state and is
saved with the rest.
Weights start from `--seed`; `--resume` merges a `.safetensors` file over
them as the JAX package's main does (`merge_checkpoint`: entries whose name
and shape match are taken, position embeddings of another length realigned
by `--align_posemb`, every missing, mismatched and unexpected entry
logged); `--resume2` then merges a second, possibly
partial file over them (`overlay_state`: a pretrained CLIP tower, in
the port's or HuggingFace's naming); with `--resume_train_state` the step,
the optimizer state and the loader's position come back too, and training
continues exactly. Each epoch saves a
checkpoint (train/checkpoint.py; with `--async_checkpointing true` written
by a background thread, the last one committed at the end); steps 10-14 of
epoch 0 are traced into `<workspace>/profile` (torch.profiler, a Chrome
trace). With `--eval_mode loss` the held-out loss is logged and one batch's
ground-truth and argmax meshes are written; with `--eval_mode generate`,
`eval_gen_samples` held-out conditions are decoded in the run's compute
dtype and scored (chamfer, F-score; eval.py), the first four written as
testgen_ep{epoch}_{i}.obj. `--use_wandb true` logs the metrics every 10
steps, each epoch's loss and the eval's scores to Weights & Biases (the
`wandb` package, imported only then). With
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
trains unsharded.

The MoE decoder (`--moe_experts E --moe_top_k K`) trains in one process or
under dp, and with expert parallelism over dp × ep ranks:

    torchrun --nproc_per_node N*M -m edgerunner_tpu_torch.main ArAE \
        --moe_experts 4 --moe_top_k 2 --ep_size M [--dp_size N]

Each ep group of M consecutive ranks takes the same rows and holds E / M
of every layer's experts (models/moe.py); checkpoints hold every expert and
load at any ep. Megatron tensor parallelism and GPipe pipeline parallelism
split the model further, and compose with dp (and tp with pp):

    torchrun --nproc_per_node T*D -m edgerunner_tpu_torch.main ArAE --tp_size T [--dp_size D]
    torchrun --nproc_per_node S*D -m edgerunner_tpu_torch.main ArAE --pp_size S \
        [--pp_microbatches M] [--dp_size D]

Each tp group of T ranks holds H / T of every attention's heads, F / T of
every MLP's columns and V / T of `lm_head`'s vocabulary; each
pp rank holds L / S consecutive decoder layers and runs them on M
microbatches (0: S) of its rows, which `--batch_size` must divide
(`--pp_size` > 1 sets `--scan_layers`, the JAX package's stacked layout:
the port's checkpoints keep the per-layer naming at every pp). The
weights of every layout are the one-process model's of the same seed,
cut to the rank's shards; checkpoints hold whole tensors, gathered to
rank 0, and load at any layout. MoE routes the whole batch under sp too,
and under dp × pp each of the JAX pipeline's microbatches whole, whose
rows the dp groups trade before each step (train/trainer.py
`jax_microbatch_rows`).
LoRA fine-tuning (`--resume dense.safetensors --lora_rank 8
--lora_alpha 16`) updates the adapters only;
`python -m edgerunner_tpu_torch.merge_lora` folds them back. Rank 0 logs and writes the checkpoints; every dp group
evaluates the whole test set's loss, rank 0 alone the generate eval (and
wandb), while the other ranks wait; every rank writes its own trace; the
process group is destroyed on exit.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from edgerunner_tpu_torch.config import parse_cli, refuse_stacked_layout, validate
from edgerunner_tpu_torch.data import save_mesh
from edgerunner_tpu_torch.data.dataset import (
    DataLoader,
    MeshFolderDataset,
    MixedDataset,
    SyntheticMeshDataset,
)
from edgerunner_tpu_torch.data.fetch import is_remote
from edgerunner_tpu_torch.eval import generate_eval
from edgerunner_tpu_torch.infer import resolve_device
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.parallel import Layout
from edgerunner_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_train_state,
    sibling_ema_path,
)
from edgerunner_tpu_torch.train.ranks import rank_logger, run_ranks, shard_train_items
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.utils import get_tokenizer
from edgerunner_tpu_torch.weights import (
    load_state,
    merge_checkpoint,
    overlay_state,
    read_safetensors,
)


def save_eval_meshes(trainer: Trainer, test_loader, opt, tokenizer, epoch: int):
    """Ground-truth and argmax-predicted meshes of one held-out batch
    (reference: main.py:253-264), written by rank 0 (under ep its ep group
    runs the forward with it)."""
    batch = next(iter(test_loader))
    logits = trainer.eval_step(batch)["logits"]
    if not trainer.is_main:
        return
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
    if opt.eval_mode == "generate":
        refuse_stacked_layout(opt, "main --eval_mode generate")
    return run_ranks(opt, device, "edgerunner_tpu_torch.main", train)


def model_kwargs(layout: Optional[Layout]) -> dict:
    """The groups a rank's model is built with: its shares under ep, tp, pp."""
    if layout is None:
        return {}
    return {"ep": layout.ep, "tp": layout.tp, "pp": layout.pp}


def seeded_weights(model, trainer: Trainer, build, seed: int, init=init_weights):
    """`model` with the seed's weights (`init(model, seed)`): when the
    layout splits the model, those of the one-process model cut to this
    rank's shards, so that every layout starts from the same weights. The
    whole model (`build("cpu")`) lies in host memory and draws on the
    rank's device, as the one process does there: the card holds only the
    rank's shards and one tensor being drawn."""
    if not trainer.split:
        return init(model, seed)
    whole = init(build("cpu"), seed, draw_device=trainer.device)
    model.load_state_dict(trainer.shard(whole.state_dict()))
    del whole
    return model


def train(opt, device: torch.device, layout: Optional[Layout] = None) -> Trainer:
    """The training run of `main` on this rank."""
    logger = rank_logger(opt, layout)
    dp = None if layout is None else layout.dp
    if opt.resume is None and opt.warmup_ratio == 0 and opt.lr > 1.5e-4:
        logger.warning(
            "training from scratch with warmup_ratio=0 and lr "
            f"{opt.lr:g}: the post-LN decoder is likely to collapse to "
            "unigram predictions (see evidence/warmup_study.md). "
            "Recommended: --warmup_ratio 0.01 or more, or lr <= 1e-4.")

    tokenizer, _ = get_tokenizer(opt)
    # a remote root streams its items; several local roots mix under objxl
    # (the JAX main, main.py:72-91)
    remote = is_remote(opt.data_root)
    first_root = opt.data_root if remote else opt.data_root.split(":")[0]
    if remote or os.path.isdir(first_root):
        if opt.dataset == "objxl" and ":" in opt.data_root and not remote:
            train_dataset = MixedDataset(opt, training=True, tokenizer=tokenizer)
        else:
            train_dataset = MeshFolderDataset(opt, training=True, tokenizer=tokenizer,
                                              root=first_root)
        test_dataset = MeshFolderDataset(opt, training=False, tokenizer=tokenizer,
                                         root=first_root)
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
    model = LMM(opt, device=device, **model_kwargs(layout))
    trainer = Trainer(model, opt, total_steps, logger=logger, layout=layout)
    seeded_weights(model, trainer, lambda dev: LMM(opt, device=dev), opt.seed)
    manager = CheckpointManager(opt.workspace, keep=2, group=trainer.world,
                                async_save=opt.async_checkpointing)

    start_epoch, resume_step, opt_state_path = 0, 0, None
    if opt.resume is not None:
        merge_checkpoint(model, trainer.shard(read_safetensors(opt.resume)),
                         opt.align_posemb, log=logger.warning)
        logger.info(f"loaded weights from {opt.resume}")
        if opt.resume_train_state:
            start_epoch, resume_step, opt_state_path = restore_train_state(
                opt.resume, train_loader, manager, logger)
    if opt.resume2 is not None:
        merge_checkpoint(model, trainer.shard(overlay_state(opt.resume2)), opt.align_posemb,
                         log=logger.warning)
        logger.info(f"merged secondary checkpoint from {opt.resume2}")
    num_params = sum(p.numel() for p in model.parameters())
    updated = trainer.optimizer.updated
    logger.info(f"total param count: {num_params / 1e6:.3f} M, trainable "
                f"{sum(trainer.params[n].numel() for n in updated) / 1e6:.3f} M")
    ema_path = sibling_ema_path(opt.resume) if opt.ema_decay > 0 and opt.resume else None
    trainer.init_state(step=resume_step, opt_state_path=opt_state_path, ema_path=ema_path)
    wandb = None
    if opt.use_wandb and trainer.is_main:
        import wandb

        wandb.init(project="lmm", name=os.path.basename(opt.workspace), config=vars(opt))

    def on_step(step, metrics):
        if wandb is not None and step % 10 == 0:
            wandb.log({k: float(v) for k, v in metrics.items()}, step=step)
        if opt.save_every_steps and step % opt.save_every_steps == 0:
            weights, optimizer, ema = trainer.checkpoint_parts(opt.save_optimizer_state)
            manager.save_step(step, weights, optimizer,
                              train_state={"step": step, "loader": train_loader.state()},
                              log=logger.info, ema=ema)

    for epoch in range(start_epoch, opt.num_epochs):
        if not opt.debug_eval:
            avg_loss = trainer.train_epoch(train_loader, epoch, on_step=on_step,
                                           profile_dir=os.path.join(opt.workspace, "profile"))
            if (opt.save_every_epochs <= 1 or (epoch + 1) % opt.save_every_epochs == 0
                    or epoch == opt.num_epochs - 1):
                weights, optimizer, ema = trainer.checkpoint_parts(opt.save_optimizer_state)
                manager.save_epoch(
                    epoch, weights, optimizer, loss=avg_loss,
                    train_state={"step": trainer.step, "loader": train_loader.state()},
                    log=logger.info, ema=ema)
            if wandb is not None:
                wandb.log({"train_loss": avg_loss})
        else:
            logger.info(f"epoch: {epoch} skip training for debug !!!")
        if opt.eval_mode == "loss":
            trainer.eval_epoch(test_loader, epoch)
            if trainer.ema is not None:
                trainer.eval_epoch(test_loader, epoch, use_ema=True)
            if not trainer.first_group:
                continue
            # meto streams may be invalid early in training: a failed dump is
            # logged and training goes on, as in the reference
            try:
                save_eval_meshes(trainer, test_loader, opt, tokenizer, epoch)
            except Exception as e:  # noqa: BLE001
                logger.warning(f"failed to save validation mesh: {e}")
        elif opt.eval_mode == "generate":
            if trainer.tp is not None:
                # the decode paths hold no tp split: rank 0 decodes the
                # weights gathered whole
                weights = trainer.checkpoint_parts(with_optimizer=False)[0].state_dict()
                if trainer.is_main:
                    whole = load_state(LMM(opt, device=device), weights)
                    log_generate_eval(whole, test_loader, opt, tokenizer, epoch, logger, wandb)
                    del whole
                del weights
            elif trainer.first_group:
                log_generate_eval(model, test_loader, opt, tokenizer, epoch, logger, wandb,
                                  write=trainer.is_main)
            if trainer.world is not None:
                dist.barrier(trainer.world.group)
    # the last asynchronous save on disk, and its bookkeeping
    manager.wait(log=logger.info)
    return trainer


def log_generate_eval(model, test_loader, opt, tokenizer, epoch: int, logger, wandb=None,
                      write: bool = True):
    """--eval_mode generate (reference: main.py:240-265): decode and score
    held-out samples, log the scores (and send them to wandb); without
    `write` (the other ranks of rank 0's ep group, which decode with it)
    no mesh is written."""
    stats = generate_eval(model, test_loader, opt, tokenizer=tokenizer, epoch=epoch,
                          workspace=opt.workspace if write else None, log=logger.warning)
    msg = f"Eval epoch: {epoch} generated meshes saved."
    if stats["n"]:
        msg += (f" chamfer={stats['chamfer_mean']:.5f}±{stats['chamfer_std']:.5f}"
                f" fscore={stats['fscore_mean']:.3f}±{stats['fscore_std']:.3f}"
                f" (n={stats['n']})")
        if wandb is not None:
            wandb.log({"eval_chamfer": stats["chamfer_mean"],
                       "eval_chamfer_std": stats["chamfer_std"],
                       "eval_fscore": stats["fscore_mean"],
                       "eval_fscore_std": stats["fscore_std"]}, commit=False)
    logger.info(msg)
    return stats


if __name__ == "__main__":
    main()

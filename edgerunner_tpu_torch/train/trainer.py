"""Training harness of the port (edgerunner_tpu/train/trainer.py).

One device: f32 master parameters, the forward and backward under bf16
autocast on the card (the counterpart of flax's `dtype=bf16` with f32
params) and in f32 on the CPU, then the JAX package's optimizer
(train/state.py) over the trainable parameters. Each step's random draws
come from its own seeds, derived from (opt.seed, step), the counterpart of
`fold_in(rng, step)`: a generator for num-face dropout, and the default
generators, forked for the step, for the decoder's dropout (gradient
checkpointing replays them identically).

The model kind picks the batch and the call, as the JAX package's
`step_builder` and `eval_builder` do: 'arae' (the LMM: conds, tokens,
labels, num_faces, lengths; metrics loss, loss_ce, loss_kl, loss_mtp) and
'dit' (the MDiT: images and points; its condition-dropout, noise and
timestep draws come from the step's generator, the eval's from a generator
seeded with opt.seed, the same for every batch as JAX's `eval_needs_rng`
passes one key; metric loss). With `--ema_decay` d every parameter's
moving average `ema <- ema * d + p * (1 - d)` follows each step, from the
loaded weights or a saved EMA; `eval_epoch(use_ema=True)` evaluates it.

Sequence parallelism (`sp`, a parallel/mesh.py `SequenceParallel` of R
ranks): every rank of the group takes the same batch, suffix-pads tokens
and labels to a multiple of R (`pad_for_sp`; labels -100, tokens PAD), and
runs the step under the sp context, which the trainer installs for its
train and eval steps only: the decoder runs on the rank's shard, its
attention as the ring.

Data parallelism (`dp`, a parallel/mesh.py `DataParallel` of G groups of
R ranks each): each dp group takes rows of its own, `--batch_size` per
rank (the JAX package's per-host batch, trainer.py:135-140), so the global
batch is batch_size × G; the step runs under the dp context, in which the
losses are the group's share of the global batch's loss (models/lmm.py,
models/mdit.py), and each step's random draws fold in the dp rank, so that
the groups drop out with masks of their own. No DDP wrapper: DDP would
divide by the world's size, and the shares already add up to the loss.

Each rank's loss is its share of the whole, so the gradients are summed
over every rank of the world (bucketed) before the optimizer clips them by
their global norm, and every rank takes the same update. Weights start
equal on every rank: `init_state` broadcasts rank 0's. Training metrics
are summed over the world; only its rank 0 logs. The first batch is
checked equal over the sp group (dp groups hold other rows). Eval, as in
the JAX package, is not sharded over dp: every dp group evaluates the
whole batch, summed over its sp ranks, so the logged loss is the
one-process loss.

Expert parallelism (`ep`, a parallel/mesh.py `ExpertParallel`, from
`--ep_size` with `--moe_experts`): the ranks of an ep group take the same
rows (the batch is split over dp only) and each holds E / ep of every MoE
layer's experts (models/moe.py); each computes the whole loss of its
group's rows, the whole gradient of every non-expert parameter and its
experts' own. So gradients and metrics are summed over the ranks that hold
the same experts, one per dp group (`ep.replicas`), and the norm that
clipping takes counts the non-expert part once and the experts' summed over
the ep group. Saves gather the experts and their optimizer state into full
[E, ...] tensors (`checkpoint_parts`), which load at any ep: each rank
slices its share of a file's experts (`shard_experts`). Under dp with MoE
every group's rows are padded to the longest group's length first, so
that the step routes one global batch, as the JAX step's has one length.
MoE's aux loss joins the metrics as loss_moe, in the JAX log's format.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call

from edgerunner_tpu_torch.data.dataset import batch_checksum
from edgerunner_tpu_torch.models.moe import is_expert_param, shard_experts
from edgerunner_tpu_torch.parallel import (
    DataParallel,
    ExpertParallel,
    SequenceParallel,
    all_gather,
    all_reduce_,
    assert_same_on_every_rank,
    broadcast_,
    data_parallel,
    gather_to_first,
    sequence_parallel,
)
from edgerunner_tpu_torch.train.state import (
    frozen_param_keys,
    global_norm,
    make_optimizer,
    trainable_parameters,
)
from edgerunner_tpu_torch.weights import read_safetensors

METRICS = ("loss", "loss_ce", "loss_kl", "loss_mtp", "loss_moe")
# the steps of epoch 0 that `train_epoch(profile_dir=...)` traces, first and last
PROFILE_STEPS = (10, 14)


def _lmm_call(model, b, train, generator):
    return model(b["conds"], b["tokens"], b["labels"], b["num_faces"], b["lengths"],
                 train=train, generator=generator)


def _dit_call(model, b, train, generator):
    return model(b["images"], b["points"], train=train, generator=generator)


# each model kind's batch keys and call
MODEL_KINDS = {"arae": (("conds", "tokens", "labels", "num_faces", "lengths"), _lmm_call),
               "dit": (("images", "points"), _dit_call)}


def step_seeds(seed: int, step: int, dp_rank: int = 0) -> tuple:
    """(num-face dropout seed, dropout seed) of one training step of dp
    group `dp_rank` (group 0 draws as one process does)."""
    key = (seed, step) if dp_rank == 0 else (seed, step, dp_rank)
    return tuple(int(x) for x in np.random.SeedSequence(key).generate_state(2))


def device_mem_gb(device: torch.device) -> str:
    """'used/total G' like the reference's memory log (main.py:192-193);
    empty off the card."""
    if device.type != "cuda":
        return ""
    used = torch.cuda.memory_allocated(device) / 1024 ** 3
    total = torch.cuda.get_device_properties(device).total_memory / 1024 ** 3
    return f"{used:.2f}/{total:.2f}G"


def pad_for_sp(batch: dict, size: int, pad_token_id: int) -> dict:
    """Suffix-pad tokens and labels so that the attention length (the labels'
    length) divides over `size` sp ranks (edgerunner_tpu/train/trainer.py:58-82):
    labels with -100, tokens with PAD. Causal attention over a suffix pad
    leaves every position that the loss reads unchanged."""
    return pad_to_length(batch, (-np.asarray(batch["labels"]).shape[1]) % size, pad_token_id)


def pad_to_length(batch: dict, pad: int, pad_token_id: int) -> dict:
    """`pad` more positions of tokens (PAD) and labels (-100)."""
    if not pad:
        return batch
    out = dict(batch)
    for key, fill in (("tokens", pad_token_id), ("labels", -100)):
        out[key] = np.pad(np.asarray(batch[key]), ((0, 0), (0, pad)), constant_values=fill)
    return out


class Trainer:
    def __init__(self, model, opt, total_steps: int, logger=None,
                 sp: Optional[SequenceParallel] = None, kind: str = "arae",
                 dp: Optional[DataParallel] = None, ep: Optional[ExpertParallel] = None):
        self.model = model
        self.opt = opt
        self.logger = logger
        self.kind = kind
        self.batch_keys, self.call = MODEL_KINDS[kind]
        self.sp = sp if sp is not None and sp.size > 1 else None
        self.dp = dp if dp is not None and dp.size > 1 else None
        self.ep = ep if ep is not None and ep.size > 1 else None
        # every rank; it logs and saves from its rank 0
        self.world = (self.dp.world if self.dp is not None else
                      self.sp if self.sp is not None else
                      self.ep.world if self.ep is not None else None)
        # gradients and training metrics are summed over these ranks: every
        # rank, or under ep the ranks holding this rank's experts
        self.sums = self.ep.replicas if self.ep is not None else self.world
        self.is_main = self.world is None or self.world.rank == 0
        # rank 0, and under ep the rest of its ep group, which its forward needs
        self.first_group = self.is_main or (self.ep is not None and (
            self.dp is None or self.dp.rank == 0))
        self.device = next(model.parameters()).device
        self.params = trainable_parameters(model, frozen_param_keys(opt, kind))
        self.optimizer, self.schedule = make_optimizer(
            opt, self.params, total_steps, norm=self._ep_norm if self.ep is not None else None)
        self.autocast = self.device.type == "cuda" and opt.mixed_precision == "bf16"
        self.ema_decay = float(opt.ema_decay or 0.0)
        self.ema: Optional[dict] = None  # {name: f32 tensor} of every parameter
        self.step = 0
        self.losses: list[float] = []  # every training step's loss, in order

    def log(self, msg: str):
        if not self.is_main:
            return
        if self.logger is not None:
            self.logger.info(msg)
        else:
            print(msg)

    def _ep_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the whole model's gradients under ep: the
        non-expert part, the same on every rank of the group, once; the
        experts' squares summed over the group."""
        dense = [g for n, g in grads.items() if not is_expert_param(n)]
        experts = [(g.float() ** 2).sum() for n, g in grads.items() if is_expert_param(n)]
        sq = torch.stack(experts).sum().reshape(1)
        all_reduce_([sq], self.ep)
        return torch.sqrt(global_norm(dense) ** 2 + sq[0])

    def shard(self, state: dict) -> dict:
        """A saved state's full [E, ...] expert entries cut to this rank's
        experts under ep; `state` itself otherwise."""
        if self.ep is None:
            return state
        return shard_experts(state, self.ep, self.opt.moe_experts)

    def init_state(self, step: int = 0, opt_state_path: Optional[str] = None,
                   ema_path: Optional[str] = None):
        """`step` restarts the schedule and the step seeds where a run left
        off; `opt_state_path` restores a saved optimizer state. Under sp or
        dp, every rank takes rank 0's weights (under ep, an expert shard its
        first replica's). With --ema_decay the EMA starts from the weights,
        or from the EMA file `ema_path`. Saved experts are cut to this
        rank's under ep."""
        self.step = step
        if self.ep is not None:
            broadcast_([p for n, p in self.params.items() if not is_expert_param(n)],
                       self.world)
            if self.sums is not None:
                broadcast_([p for n, p in self.params.items() if is_expert_param(n)],
                           self.sums)
        elif self.world is not None:
            broadcast_(list(self.params.values()), self.world)
        if self.ema_decay > 0:
            saved = self.shard(read_safetensors(ema_path)) if ema_path else None
            self.ema = {n: (p.detach().clone() if saved is None else
                            torch.as_tensor(saved[n]).to(self.device, p.dtype))
                        for n, p in self.model.named_parameters()}
        if opt_state_path:
            state = torch.load(opt_state_path, map_location="cpu", weights_only=True)
            for table in ("mu", "nu", "acc"):
                if state.get(table) is not None:
                    state[table] = self.shard(state[table])
            self.optimizer.load_state_dict(state)

    def checkpoint_parts(self, with_optimizer: bool = True) -> tuple:
        """(weights, optimizer, EMA) for a save, each with `state_dict()`
        (the EMA a dict): the live model and optimizer, or under ep every
        expert tensor gathered into its full [E, ...] on the host of the ep
        group's rank 0 (collective over the ep groups of dp group 0, whose
        rank 0 writes; the others return what nobody writes)."""
        optimizer = self.optimizer if with_optimizer else None
        if self.ep is None:
            return self.model, optimizer, self.ema
        if not self.first_group:
            return _Saved({}), None, None

        def full(tensors: Optional[dict]) -> Optional[dict]:
            if tensors is None:
                return None
            return {n: (gather_to_first(t, self.ep) if is_expert_param(n) else t.detach())
                    for n, t in tensors.items()}

        weights = _Saved(full(self.model.state_dict()))
        ema = full(self.ema)
        if optimizer is not None:
            state = dict(optimizer.state_dict())
            for table in ("mu", "nu", "acc"):
                state[table] = full(state[table])
            optimizer = _Saved(state)
        return weights, optimizer, ema

    def forward(self, batch: dict, *, train: bool, generator=None, use_ema: bool = False
                ) -> dict:
        b = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()
             if k in self.batch_keys}
        model = self.model
        if use_ema:
            def model(*args, **kw):
                return functional_call(self.model, self.ema, args, kw)
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.autocast):
            return self.call(model, b, train, generator)

    @torch.no_grad()
    def update_ema(self):
        d = self.ema_decay
        for n, p in self.model.named_parameters():
            self.ema[n].mul_(d).add_(p * (1.0 - d))

    def _sp_batch(self, batch: dict) -> dict:
        if self.sp is None:
            return batch
        return pad_for_sp(batch, self.sp.size, self.opt.pad_token_id)

    def _dp_moe_batch(self, batch: dict) -> dict:
        """Under dp with MoE, this group's rows padded to the longest
        group's length: the step routes one global batch."""
        if self.dp is None or not self.opt.moe_experts:
            return batch
        T = np.asarray(batch["labels"]).shape[1]
        longest = max(int(t) for t in all_gather(
            torch.tensor([T], device=self.device), self.dp.world))
        return pad_to_length(batch, longest - T, self.opt.pad_token_id)

    @staticmethod
    def _summed(out: dict, group: Optional[SequenceParallel]) -> dict:
        """Host floats of the metrics in `out`, summed over `group`."""
        keys = [k for k in METRICS if k in out]
        vals = torch.stack([out[k].detach().float() for k in keys])
        if group is not None:
            all_reduce_([vals], group)
        return dict(zip(keys, vals.tolist()))

    def train_step(self, batch: dict) -> dict:
        """One forward, backward and optimizer (micro-)step on this rank's
        rows `batch`; host floats of the world's metrics."""
        dp_rank = 0 if self.dp is None else self.dp.rank
        nof_seed, drop_seed = step_seeds(self.opt.seed, self.step, dp_rank)
        generator = torch.Generator(device=self.device).manual_seed(nof_seed)
        cuda = self.device.type == "cuda"
        batch = self._dp_moe_batch(batch)
        with torch.random.fork_rng(devices=[self.device.index or 0] if cuda else []), \
                sequence_parallel(self.sp), data_parallel(self.dp):
            torch.manual_seed(drop_seed)
            out = self.forward(self._sp_batch(batch), train=True, generator=generator)
            grads = torch.autograd.grad(out["loss"], list(self.params.values()))
        if self.sums is not None:
            all_reduce_(grads, self.sums)
        gnorm = self.optimizer.update(dict(zip(self.params, grads)))
        if self.ema is not None:
            self.update_ema()
        self.step += 1
        metrics = self._summed(out, self.sums)
        metrics["grad_norm"] = float(gnorm)
        self.losses.append(metrics["loss"])
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """The whole model on the whole batch: no sp context (the eval mesh
        dump reads every position's logits)."""
        return self.forward(batch, train=False)

    def train_epoch(self, loader, epoch: int,
                    on_step: Optional[Callable[[int, dict], None]] = None,
                    profile_dir: Optional[str] = None) -> float:
        """One pass over the loader; logs every 10 steps in the JAX package's
        format (trainer.py:262-287). Returns the mean loss. With
        `profile_dir`, steps 10-14 of epoch 0 run under torch.profiler (the
        CPU, and the card's kernels on the card), exported as a Chrome
        trace, trace.json (trace_rank{r}.json under dp or sp) in
        `profile_dir`, as the JAX trainer traces them
        (trainer.py:257-267); an epoch that ends sooner writes the steps it
        traced."""
        t_start = t_step = time.time()
        total, n = 0.0, 0
        num_batches = len(loader)
        prof = None
        for i, batch in enumerate(loader):
            if profile_dir and epoch == 0 and i == PROFILE_STEPS[0]:
                prof = self._start_profiler()
            if i == 0 and self.sp is not None:
                # every rank of an sp group must hold the same batch
                assert_same_on_every_rank(batch_checksum(batch).to(self.device),
                                          "the first batch", self.sp)
            m = self.train_step(batch)
            total += m["loss"]
            n += 1
            if on_step is not None:
                on_step(self.step, m)
            if i % 10 == 0:
                dt_step = (time.time() - t_step) / 10 if i else time.time() - t_step
                t_step = time.time()
                log = (f"{epoch:03d}:{i}/{num_batches} lr: {self.schedule(self.step):.7f} "
                       f"loss: {m['loss']:.6f} ({dt_step:.2f}s/it)")
                mem = device_mem_gb(self.device)
                if mem:
                    log = log.replace(" lr:", f" mem: {mem} lr:", 1)
                log += f" gnorm: {m['grad_norm']:.3f}"
                for k in ("loss_ce", "loss_kl", "loss_mtp", "loss_moe"):
                    if k in m:
                        log += f" {k}: {m[k]:.6f}"
                self.log(log)
            if prof is not None and i == PROFILE_STEPS[1]:
                self._write_trace(prof, profile_dir)
                prof = None
        if prof is not None:
            self._write_trace(prof, profile_dir)
        avg = total / max(n, 1)
        self.log(f"Train epoch: {epoch} loss: {avg:.6f} "
                 f"time: {(time.time() - t_start) / 60:.2f}min")
        return avg

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _write_trace(self, prof, profile_dir: str):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        name = "trace.json" if self.world is None else f"trace_rank{self.world.rank}.json"
        prof.export_chrome_trace(os.path.join(profile_dir, name))
        self.log(f"[profiler] trace written to {profile_dir}")

    @torch.no_grad()
    def eval_loss(self, batch: dict, use_ema: bool = False) -> float:
        """The held-out loss of `batch` (of the EMA's weights with `use_ema`),
        under sp summed over the ranks of the sp group; every dp group takes
        the whole batch."""
        # the DiT's draws from opt.seed, the same for every batch
        generator = (torch.Generator(device=self.device).manual_seed(self.opt.seed)
                     if self.kind == "dit" else None)
        with sequence_parallel(self.sp):
            return self._summed(self.forward(self._sp_batch(batch), train=False,
                                             generator=generator, use_ema=use_ema),
                                self.sp)["loss"]

    def eval_epoch(self, loader, epoch: int, use_ema: bool = False) -> float:
        if use_ema and self.ema is None:
            raise ValueError("use_ema needs --ema_decay > 0")
        total, n = 0.0, 0
        for batch in loader:
            total += self.eval_loss(batch, use_ema)
            n += 1
        avg = total / max(n, 1)
        self.log(f"Eval epoch: {epoch}{' (ema)' if use_ema else ''} loss: {avg:.6f}")
        return avg


class _Saved:
    """A gathered state in place of a module or an optimizer in a save."""

    def __init__(self, state: dict):
        self.state = state

    def state_dict(self) -> dict:
        return self.state

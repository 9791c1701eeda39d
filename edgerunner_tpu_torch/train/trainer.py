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
the same experts, one per dp group (`layout.data`), and the norm that
clipping takes counts the non-expert part once and the experts' summed over
the ep group. Saves gather the experts and their optimizer state into full
[E, ...] tensors (`checkpoint_parts`), which load at any ep: each rank
slices its share of a file's experts (`shard`). Under dp with MoE
every group's rows are padded to the longest group's length first, so
that the step routes one global batch, as the JAX step's has one length;
under dp × pp the groups then trade rows (`jax_microbatch_rows`), so that
each microbatch routes the global rows of the JAX pipeline's microbatch,
in its order. The eval paths (`eval_step`, `eval_loss`, `eval_epoch`)
trade none: every dp group evaluates the whole batch outside the dp
context, so its microbatches are the JAX pipeline's already.
MoE's aux loss joins the metrics as loss_moe, in the JAX log's format.

All of these, and tensor and pipeline parallelism, come as one `layout`
(parallel/mesh.py `make_layout`: dp × pp × sp × tp × ep ranks). A rank's
model holds only its shards: its tp share of the heads and MLP columns
(models/layers.py), its pp stage of the decoder's layers (models/
shape_opt.py, parallel/pipeline.py), its ep share of the experts. Every
parameter that a rank holds whole is the same, and takes the same
gradient, on every rank of its tp, pp and ep groups: Megatron's f and g
and the pipeline's broadcasts make it so. So gradients and metrics are
summed over `layout.data` alone, the dp × sp ranks that hold the same
parameters, and the norm that clipping takes sums each parameter's
squares once: over the ranks that split it, from the first rank of the
others (`_norm`). Saves gather every split parameter, and its optimizer
state and EMA, into the whole tensor in the reference naming on rank 0
(`checkpoint_parts`), so a file loads at any layout; a load cuts a whole
file to this rank's shards (`shard`). Under pp the eval batches' rows are
padded to a multiple of the microbatches with rows that carry no label,
as the JAX trainer pads them (trainer.py:311).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call

from edgerunner_tpu_torch.data.dataset import batch_checksum
from edgerunner_tpu_torch.models.moe import is_expert_param
from edgerunner_tpu_torch.parallel import (
    Group,
    Layout,
    all_gather,
    all_reduce_,
    assert_same_on_every_rank,
    broadcast_,
    data_parallel,
    gather_list,
    sequence_parallel,
    tp_join,
    tp_slice,
)
from edgerunner_tpu_torch.train.state import (
    frozen_param_keys,
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


LAYER_PREFIX = "mesh_decoder.model.layers."


def layer_index(name: str) -> Optional[int]:
    """The decoder layer of a parameter name, or None outside the layers."""
    if not name.startswith(LAYER_PREFIX):
        return None
    return int(name[len(LAYER_PREFIX):].split(".", 1)[0])


def pad_rows(batch: dict, multiple: int) -> dict:
    """The batch's rows padded to a multiple of `multiple` with copies of
    its first row whose labels are all -100 (edgerunner_tpu/train/
    trainer.py:90-112): the loss's sum and its count of labels are
    unchanged."""
    b = len(np.asarray(batch["labels"]))
    pad = (-b) % multiple
    if not pad:
        return batch
    out = {}
    for k, v in batch.items():
        if k == "paths":
            out[k] = v
            continue
        v = np.asarray(v)
        fill = np.repeat(v[:1], pad, axis=0)
        if k == "labels":
            fill = np.full_like(fill, -100)
        out[k] = np.concatenate([v, fill], axis=0)
    return out


def jax_microbatch_rows(batch: dict, dp, microbatches: int, device) -> dict:
    """The rows of dp group `dp.rank` under dp × pp as the JAX pipeline
    cuts the global batch (edgerunner_tpu/parallel/pipeline.py:43-93): its
    body sees the B = G · b rows of the G groups in dp order and takes
    microbatch m as rows [m · B/M, (m + 1) · B/M). So the group's local
    microbatch m (its rows [m · b/M, (m + 1) · b/M)) takes the global rows
    m · B/M + d · b/M + [0, b/M), and `route` (models/moe.py), which
    queues a microbatch's tokens in (dp group, row) order over `dp.data`,
    routes each JAX microbatch whole in JAX's row order. One all-gather of
    every array over `dp.data` (the ranks that share this rank's pp, tp
    and ep coordinates); `jax_microbatch_rows.bytes` counts the bytes that
    this rank takes from the others. The loss and its label count are sums
    over rows, so a step's sums do not change."""
    G, d = dp.size, dp.rank
    b = len(np.asarray(batch["labels"]))
    per = b // microbatches
    take = torch.tensor([m * G * per + d * per + i for m in range(microbatches)
                         for i in range(per)])
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(np.ascontiguousarray(v), device=device)
        parts = all_gather(v, dp.data)  # sp is 1 under pp: one part per dp group
        jax_microbatch_rows.bytes += v.numel() * v.element_size() * (len(parts) - 1)
        every = torch.cat(parts)
        out[k] = every[take.to(every.device)].cpu().numpy()
    return out


jax_microbatch_rows.bytes = 0


class Trainer:
    def __init__(self, model, opt, total_steps: int, logger=None, kind: str = "arae",
                 layout: Optional[Layout] = None):
        self.model = model
        self.opt = opt
        self.logger = logger
        self.kind = kind
        self.batch_keys, self.call = MODEL_KINDS[kind]
        self.layout = layout
        L = layout
        self.dp, self.pp, self.sp, self.tp, self.ep = (
            (None,) * 5 if L is None else (L.dp, L.pp, L.sp, L.tp, L.ep))
        # every rank; it logs and saves from its rank 0
        self.world = None if L is None else L.world
        # gradients and training metrics are summed over these ranks
        self.sums = None if L is None else L.data
        self.is_main = self.world is None or self.world.rank == 0
        # rank 0 and the rest of its copy of the model, which its forward needs
        self.first_group = L is None or L.coords["dp"] == L.coords["sp"] == 0
        self.device = next(model.parameters()).device
        # the parameters split over tp: (dimension, groups) by name
        self.tp_splits = {n: p.tp_split for n, p in model.named_parameters()
                          if hasattr(p, "tp_split")}
        self.params = trainable_parameters(model, frozen_param_keys(opt, kind))
        self.split = L is not None and L.model is not None
        self.optimizer, self.schedule = make_optimizer(
            opt, self.params, total_steps, norm=self._norm if self.split else None)
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

    def split_axes(self, name: str) -> tuple:
        """The axes among pp, tp and ep over which this rank holds a share
        of the parameter `name` (the others hold it whole)."""
        axes = []
        if self.pp is not None and layer_index(name) is not None:
            axes.append("pp")
        if self.tp is not None and name in self.tp_splits:
            axes.append("tp")
        if self.ep is not None and is_expert_param(name):
            axes.append("ep")
        return tuple(axes)

    def _norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the whole model's gradients when pp, tp or ep
        split it: each rank adds the squares of the gradients it holds a
        share of, and of the whole ones only where it is the first rank of
        the axes that do not split them, and the sums are added over the
        ranks that hold one copy of the model (`layout.model`)."""
        coords = self.layout.coords
        mine = []
        for n, g in grads.items():
            axes = self.split_axes(n)
            if all(coords[a] == 0 for a in ("pp", "tp", "ep") if a not in axes):
                mine.append((g.float() ** 2).sum())
        sq = (torch.stack(mine).sum() if mine
              else torch.zeros((), device=self.device)).reshape(1)
        all_reduce_([sq], self.layout.model)
        return torch.sqrt(sq[0])

    def shard(self, state: dict) -> dict:
        """A whole state dict (a saved file, an optimizer table; arrays or
        tensors) cut to this rank's shards: under pp the entries of its
        stage's layers alone, under ep its experts of every [E, ...] entry,
        under tp its share of every entry marked `tp_split` (an entry
        already of the rank's shape is kept as it is). `state` itself when
        nothing is split."""
        if not self.split:
            return state
        out = {}
        stage = None
        if self.pp is not None:
            per = self.opt.num_layers // self.pp.size
            stage = range(self.pp.rank * per, (self.pp.rank + 1) * per)
        E = self.opt.moe_experts
        params = dict(self.model.named_parameters())
        for n, v in state.items():
            i = layer_index(n)
            if stage is not None and i is not None and i not in stage:
                continue
            if self.ep is not None and is_expert_param(n) and v.shape[0] == E:
                local = E // self.ep.size
                v = v[self.ep.rank * local:(self.ep.rank + 1) * local]
            spec = self.tp_splits.get(n)
            if spec is not None and v.shape[spec[0]] != params[n].shape[spec[0]]:
                v = tp_slice(v, self.tp.rank, self.tp.size, *spec)
            out[n] = v
        return out

    def init_state(self, step: int = 0, opt_state_path: Optional[str] = None,
                   ema_path: Optional[str] = None):
        """`step` restarts the schedule and the step seeds where a run left
        off; `opt_state_path` restores a saved optimizer state. Every rank
        takes the weights of the first rank of the ranks that hold the same
        parameters (`layout.data`). With --ema_decay the EMA starts from
        the weights, or from the EMA file `ema_path`. Saved states are cut
        to this rank's shards."""
        self.step = step
        if self.sums is not None:
            broadcast_(list(self.params.values()), self.sums)
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

    def _gather(self, tensors: dict) -> Optional[dict]:
        """The whole tensors of `tensors` (named as the model's parameters)
        on the host of rank 0 of the model's copy, in the reference naming:
        each tp split joined over its tp group, each expert tensor over its
        ep group, each stage's layers over the pp group, in that order, so
        that each gather runs among the ranks that hold the previous one's
        result. Collective over `layout.model`; None on its other ranks."""
        if not self.split:
            return {n: t.detach() for n, t in tensors.items()} if self.is_main else None
        c = self.layout.coords
        items, stages, at = [], None, 0
        for n, t in tensors.items():
            t, axes = t.detach(), self.split_axes(n)
            if "tp" in axes:
                parts = gather_list(t, self.tp)
                t = None if parts is None else tp_join(parts, *self.tp_splits[n])
            if "ep" in axes and c["tp"] == 0:
                parts = gather_list(t, self.ep)
                t = None if parts is None else torch.cat(parts)
            if "pp" in axes:
                if c["tp"] or c["ep"]:
                    continue
                parts = gather_list(t, self.pp)
                if parts is None:
                    continue
                if stages is None:  # the stages' layers go where the first one's begin
                    stages, at = [[] for _ in parts], len(items)
                per = self.opt.num_layers // self.pp.size
                i, rest = layer_index(n) - self.pp.rank * per, n.split(".", 4)[4]
                for p, x in enumerate(parts):
                    stages[p].append((f"{LAYER_PREFIX}{p * per + i}.{rest}", x))
                continue
            items.append((n, t))
        if not self.is_main:
            return None
        if stages is not None:
            items[at:at] = [kv for stage in stages for kv in stage]
        return dict(items)

    def checkpoint_parts(self, with_optimizer: bool = True) -> tuple:
        """(weights, optimizer, EMA) for a save, each with `state_dict()`
        (the EMA a dict): the live model and optimizer, or when pp, tp or
        ep split the model every tensor gathered whole on rank 0's host
        (collective over the ranks of dp group 0 and sp rank 0, whose rank
        0 writes; the others return what nobody writes)."""
        optimizer = self.optimizer if with_optimizer else None
        if not self.split:
            return self.model, optimizer, self.ema
        if not self.first_group:
            return _Saved({}), None, None
        weights = _Saved(self._gather(self.model.state_dict()) or {})
        ema = None if self.ema is None else self._gather(self.ema)
        if optimizer is not None:
            state = dict(optimizer.state_dict())
            for table in ("mu", "nu", "acc"):
                if state[table] is not None:
                    state[table] = self._gather(state[table])
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
        group's length: the step routes one global batch. Under dp × pp
        with more than one microbatch, then the rows of JAX's microbatches
        (`jax_microbatch_rows`)."""
        if self.dp is None or not self.opt.moe_experts:
            return batch
        T = np.asarray(batch["labels"]).shape[1]
        longest = max(int(t) for t in all_gather(
            torch.tensor([T], device=self.device), self.dp.data))
        batch = pad_to_length(batch, longest - T, self.opt.pad_token_id)
        if self.pp is None or self.pp.microbatches == 1:
            return batch
        return jax_microbatch_rows({k: batch[k] for k in self.batch_keys}, self.dp,
                                   self.pp.microbatches, self.device)

    @staticmethod
    def _summed(out: dict, group: Optional[Group]) -> dict:
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
        dump reads every position's logits); under pp its rows padded to the
        microbatches, the padding's logits after the batch's."""
        if self.pp is not None:
            batch = pad_rows(batch, self.pp.microbatches)
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
            if self.pp is not None:
                batch = pad_rows(batch, self.pp.microbatches)
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

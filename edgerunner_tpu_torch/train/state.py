"""Optimizer and learning-rate schedule of the port (edgerunner_tpu/train/state.py).

The JAX package's optimizer, written out in plain PyTorch: global-norm
gradient clipping, then AdamW with b1 0.9, b2 0.95, eps 1e-8 and decoupled
weight decay, its first moment kept in bf16 and its second in f32, under a
cosine schedule with linear warmup and a 0.1 floor; with
`gradient_accumulation_steps` > 1 the gradients are averaged over that many
micro-steps first, as `optax.MultiSteps` does. The update repeats the
operand order of the JAX package's fused update (`_fused_apply`,
state.py:157-199), down to the `b1 * mu` product rounded in bf16 before the
f32 add, so that both packages take the same step. `torch.optim.AdamW` cannot
keep a bf16 moment beside f32 parameters, hence the update is written here.
The JAX optimizer is fused XLA, not a Pallas kernel, so nothing here is a
kernel either.

Frozen submodules (`frozen_param_keys`: the MDiT's CLIP tower and point
encoder) take no gradient and no optimizer state: the optimizer holds the
trainable parameters only, which is what the JAX package's masked AdamW
with `set_to_zero` does (state.py:115-150). Their gradients there are zero,
so the global norm that clipping sees is the same.

LoRA (`--lora_rank`) is another mask (state.py:112-136): the chain clips
by the global norm of every gradient, the base weights' included (the JAX
LoRADense has no stop_gradient on its kernel), then AdamW updates, and
decays, only the adapters (`LORA_TRAINABLE_KEYS`); the base weights take
no update and no AdamW state. So the optimizer takes every trainable
parameter's gradient and `updated` names the adapters.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.95, 1e-8
MU_DTYPE = torch.bfloat16
# the parameters that LoRA fine-tuning updates (state.py:112-114)
LORA_TRAINABLE_KEYS = ("lora_a", "lora_b")


def cosine_warmup_schedule(base_lr: float, total_steps: int, warmup_ratio: float = 0.01,
                           min_ratio: float = 0.1, num_cycles: float = 0.5
                           ) -> Callable[[int], float]:
    """step -> learning rate, in f32 as the JAX schedule computes it
    (edgerunner_tpu/train/state.py:63-80; reference main.py:136-141)."""
    f32 = np.float32

    def schedule(step: int) -> float:
        progress = f32(step) / f32(max(1, total_steps))
        if warmup_ratio > 0 and progress < warmup_ratio:
            factor = progress / f32(max(warmup_ratio, 1e-9))
        else:
            prog2 = (progress - f32(warmup_ratio)) / f32(1 - warmup_ratio)
            cos = f32(min_ratio) + f32((1 - min_ratio) * 0.5) * (
                f32(1.0) + np.cos(f32(np.pi * num_cycles * 2.0) * prog2))
            factor = max(f32(min_ratio), cos)
        return float(f32(base_lr) * factor)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class AdamW:
    """Clip + AdamW + gradient accumulation over named f32 parameters.

    `update(grads)` takes one micro-step's gradients {name: tensor} of every
    parameter in `params` and returns their global norm (`norm`, by default
    `global_norm` of them all); every `accumulate`-th call applies the update
    to the parameters named in `updated` (default: all) in place (the JAX
    package returns new arrays); only they have AdamW state. `count` is the
    number of updates applied, the step of the schedule.
    """

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable[[int], float], *,
                 weight_decay: float, clip: float, accumulate: int = 1,
                 updated: Optional[list] = None,
                 norm: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None):
        self.params = params
        self.updated = list(params) if updated is None else [n for n in params if n in updated]
        self.norm = norm or (lambda grads: global_norm(grads.values()))
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip = clip
        self.accumulate = accumulate
        self.count = 0
        self.mu = {n: torch.zeros_like(params[n], dtype=MU_DTYPE) for n in self.updated}
        self.nu = {n: torch.zeros_like(params[n], dtype=torch.float32) for n in self.updated}
        self.mini_step = 0
        self.acc: Optional[Dict[str, torch.Tensor]] = (
            {n: torch.zeros_like(p) for n, p in params.items()} if accumulate > 1 else None)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        gnorm = self.norm(grads)
        if self.acc is None:
            self._apply(grads, gnorm)
            return gnorm
        # optax.MultiSteps: a running mean of the micro-steps' gradients
        for n, g in grads.items():
            self.acc[n] += (g.float() - self.acc[n]) / (self.mini_step + 1)
        if self.mini_step == self.accumulate - 1:
            self._apply(self.acc, self.norm(self.acc))
            for a in self.acc.values():
                a.zero_()
            self.mini_step = 0
        else:
            self.mini_step += 1
        return gnorm

    def _apply(self, grads, gnorm):
        f32 = np.float32
        gscale = torch.where(gnorm > self.clip, self.clip / gnorm, 1.0)
        count_inc = self.count + 1
        lr = self.schedule(self.count)
        bc1 = float(f32(1.0) - f32(B1) ** f32(count_inc))
        bc2 = float(f32(1.0) - f32(B2) ** f32(count_inc))
        for n in self.updated:
            p = self.params[n]
            g = grads[n].float() * gscale
            mu, nu = self.mu[n], self.nu[n]
            # the b1 * mu product is rounded in mu's bf16 before the f32 add
            mu2 = (1.0 - B1) * g + B1 * mu
            nu2 = (1.0 - B2) * (g * g) + B2 * nu
            u = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + EPS) + self.weight_decay * p
            p.sub_(lr * u)
            mu.copy_(mu2)
            nu.copy_(nu2)
        self.count = count_inc

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu,
                "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                             (self.acc, state["acc"])):
            if mine is None:
                continue
            if set(mine) != set(theirs):
                raise ValueError("optimizer state does not match the model's parameters")
            for n, t in mine.items():
                t.copy_(theirs[n])


def frozen_param_keys(opt, kind: str) -> tuple:
    """Module names whose parameters are not optimized
    (edgerunner_tpu/train/state.py:83-96): for 'dit' the CLIP tower and the
    point encoder, always (reference: models_dit.py:54,75); for 'arae' the
    CLIP tower of an image-conditioned model with freeze_encoder."""
    if kind == "dit":
        return ("image_encoder", "point_encoder")
    if kind == "arae":
        if opt.cond_mode == "image" and opt.freeze_encoder:
            return ("image_encoder",)
        return ()
    raise ValueError(f"unknown model kind {kind!r}")


def trainable_parameters(model: torch.nn.Module, frozen_keys: tuple = ()
                         ) -> Dict[str, torch.Tensor]:
    """{name: parameter} of the parameters outside the modules named in
    `frozen_keys` (a name matches any component of the dotted path, as the
    JAX mask matches any key of the tree path); the others are set to
    requires_grad=False."""
    out = {}
    for name, p in model.named_parameters():
        if frozen_keys and any(part in frozen_keys for part in name.split(".")):
            p.requires_grad_(False)
        else:
            out[name] = p
    return out


def lora_parameter_names(params) -> list:
    """The adapters among parameter names: the ones LoRA updates."""
    return [n for n in params if n.split(".")[-1] in LORA_TRAINABLE_KEYS]


def make_optimizer(opt, params: Dict[str, torch.Tensor], total_steps: int, norm=None):
    """(AdamW, schedule) for an Options, as the JAX package's
    `make_optimizer` builds them (state.py:116-150); `params` are the
    trainable parameters (`trainable_parameters`), all clipped by their
    global norm (`norm`: AdamW's default, or expert parallelism's); under
    `lora_rank` only the adapters are updated."""
    schedule = cosine_warmup_schedule(opt.lr, total_steps, warmup_ratio=opt.warmup_ratio)
    updated = lora_parameter_names(params) if opt.lora_rank else None
    return AdamW(params, schedule, weight_decay=opt.weight_decay, clip=opt.gradient_clip,
                 accumulate=opt.gradient_accumulation_steps, updated=updated,
                 norm=norm), schedule

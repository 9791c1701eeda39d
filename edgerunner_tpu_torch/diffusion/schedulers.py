"""Diffusion noise schedule and DDIM sampler of the port
(edgerunner_tpu/diffusion/schedulers.py).

DDPM for training (add_noise, velocity targets, SNR) and DDIM for sampling,
configured as the reference's diffusers schedulers are (core/models_dit.py:
80-101): scaled_linear betas 0.00085..0.012 over 1000 steps, v-prediction,
'leading' timestep spacing with steps_offset 1, set_alpha_to_one=False.
`alphas_cumprod` is built in float64 numpy and only then cast to f32, as the
JAX package builds it: an f32 linspace gives other values. `ddim_step` takes
a host int timestep, so that a sampling loop reads no value from the device.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _alphas_cumprod(num_train_timesteps: int, beta_start: float, beta_end: float) -> np.ndarray:
    # scaled_linear: betas are linear in sqrt space
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
    out = np.cumprod(1.0 - betas).astype(np.float32)
    out.setflags(write=False)
    return out


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "v_prediction"  # or "epsilon"

    @property
    def alphas_np(self) -> np.ndarray:
        """alphas_cumprod [T] as f32 numpy (read-only)."""
        return _alphas_cumprod(self.num_train_timesteps, self.beta_start, self.beta_end)

    @property
    def alphas_cumprod(self) -> torch.Tensor:
        return torch.from_numpy(self.alphas_np.copy())

    def _at(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """alphas_cumprod[t] broadcast against `like` ([B] ints -> [B, 1, ...])."""
        a = self.alphas_cumprod.to(like.device)[t.to(like.device).long()]
        return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))

    # ------------------------------------------------------------- training --
    def add_noise(self, x0, noise, t):
        """q(x_t | x_0): sqrt(a_t) x0 + sqrt(1-a_t) eps. t: [B] ints."""
        a = self._at(t, x0)
        return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise

    def get_velocity(self, x0, noise, t):
        """v-prediction target (diffusers get_velocity)."""
        a = self._at(t, x0)
        return torch.sqrt(a) * noise - torch.sqrt(1 - a) * x0

    def snr(self, t):
        """Signal-to-noise ratio per timestep (diffusers compute_snr)."""
        a = self.alphas_cumprod.to(t.device)[t.long()]
        return a / (1 - a)

    def min_snr_weight(self, t, gamma: float):
        """min-SNR-gamma loss weights (reference: models_dit.py:168-173)."""
        snr = self.snr(t)
        w = torch.clamp(snr, max=gamma)
        if self.prediction_type == "epsilon":
            return w / snr
        return w / (snr + 1)


def ddim_timesteps(schedule: DiffusionSchedule, num_inference_steps: int,
                   steps_offset: int = 1) -> np.ndarray:
    """'leading' spacing (diffusers): descending timesteps + offset."""
    ratio = schedule.num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1].astype(np.int64)
    return ts + steps_offset


def ddim_step(schedule: DiffusionSchedule, model_out, t: int, sample,
              num_inference_steps: int):
    """One deterministic DDIM update (eta=0), set_alpha_to_one=False.

    t is a host int. The coefficients are f32 scalars, rounded as the JAX
    package's f32 ops round them, so the update is the same f32 arithmetic.
    """
    ac = schedule.alphas_np
    prev_t = int(t) - schedule.num_train_timesteps // num_inference_steps
    one = np.float32(1.0)
    a_t = ac[int(t)]
    # set_alpha_to_one=False -> final alpha is alphas_cumprod[0]
    a_prev = ac[prev_t] if prev_t >= 0 else ac[0]
    sa, s1a = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
    if schedule.prediction_type == "v_prediction":
        x0 = sa * sample - s1a * model_out
        eps = sa * model_out + s1a * sample
    elif schedule.prediction_type == "epsilon":
        eps = model_out
        x0 = (sample - s1a * eps) / sa
    else:
        raise ValueError(schedule.prediction_type)
    return float(np.sqrt(a_prev)) * x0 + float(np.sqrt(one - a_prev)) * eps

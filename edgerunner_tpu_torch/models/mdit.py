"""MDiT of the port, the latent-diffusion top model: image -> point latent
(edgerunner_tpu/models/mdit.py).

The reference MDiT (core/models_dit.py:33-229): a frozen CLIP ViT-H image
conditioner (`image_encoder`, then `proj_cond` and `norm_cond`), the DiT
denoiser (`dit`) and the frozen point encoder (`point_encoder`, from the
ArAE checkpoint; it makes the training targets, and is built here so that a
DiT checkpoint loads with strict=True). `MDiT.forward` is the training loss
(edgerunner_tpu/models/mdit.py:73-103): v-prediction (or epsilon) with
min-SNR-gamma weighting and 10% condition dropout; the frozen towers run
without gradient, and the DiT checkpoints each layer under
`opt.checkpointing`. `run_mdit` is the DDIM sampling loop with
classifier-free guidance at scale 7.5 (reference: MDiT.run,
models_dit.py:184-229), an img2img start from given latents included.
Under tensor parallelism (`tp`, main_dit --tp_size) the towers' attention
and MLPs and the DiT's feed-forwards hold this rank's share; the DiT's
attn1/attn2 stay whole, as the JAX package's `TP_RULES` do not name them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from edgerunner_tpu_torch.diffusion import DiffusionSchedule, ddim_step, ddim_timesteps
from edgerunner_tpu_torch.models.clip_vit import (
    CLIPVisionTower,
    clip_config_from_options,
    preprocess_images,
)
from edgerunner_tpu_torch.models.dit import DiT
from edgerunner_tpu_torch.models.layers import LN_EPS
from edgerunner_tpu_torch.models.point_encoder import PointEncoderEmbed
from edgerunner_tpu_torch.parallel import active_data_parallel, dp_total


class MDiT(nn.Module):
    """`use_kernels=False` runs the plain attention versions on every device:
    the reference path that a kernel path is checked against."""

    def __init__(self, opt, *, dtype=torch.float32, device=None, use_kernels: bool = True,
                 tp=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.opt = opt
        self.dit = DiT(opt.dit_hidden_dim, opt.dit_num_heads, opt.point_latent_size,
                       opt.point_latent_dim, opt.dit_num_layers, use_kernels=use_kernels,
                       remat=opt.checkpointing, tp=tp, **kw)
        self.image_encoder = CLIPVisionTower(clip_config_from_options(opt), tp=tp, **kw)
        self.proj_cond = nn.Linear(opt.clip_hidden_dim, opt.dit_hidden_dim, **kw)
        self.norm_cond = nn.LayerNorm(opt.dit_hidden_dim, eps=LN_EPS, **kw)
        self.point_encoder = PointEncoderEmbed(
            opt.point_hidden_dim, opt.point_num_heads, opt.point_latent_size,
            opt.point_latent_dim, use_kernels=use_kernels, tp=tp, **kw)
        self.schedule = DiffusionSchedule(prediction_type=opt.noise_scheduler_predtype)

    def get_cond(self, images):
        """images [B, H, W, 3] in [0,1] -> [B, 257, dit_hidden]
        (reference: models_dit.py:104-115); the frozen tower takes no gradient."""
        with torch.no_grad():
            feats = self.image_encoder(preprocess_images(images,
                                                         size=self.opt.clip_image_size))
        return self.norm_cond(self.proj_cond(feats))

    def encode_points(self, points):
        """The frozen point encoder's latents [B, latent_size, latent_dim]:
        the training targets, without gradient."""
        with torch.no_grad():
            return self.point_encoder(points)

    def forward(self, images, points, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None) -> dict:
        """The training loss (reference: models_dit.py:119-181) of images
        [B, H, W, 3] in [0,1] and surface points [B, N, 3]: {"loss": f32
        scalar}. Three draws, in this order from `generator` unless given:
        `keep` [B, 1, 1] bool (uniform >= 0.1, drawn and applied with `train`
        only: the condition is dropped for the rest), `noise` f32 normals of
        the latents' shape, `t` [B] ints in [0, 1000). Under a dp context
        (parallel/mesh.py) the loss is this rank's share of the mean over
        every dp group's rows: its own mean × B / (the groups' rows), so
        that the shares add up to the JAX package's mean over the whole
        batch (edgerunner_tpu/models/mdit.py:101-104)."""
        opt = self.opt
        B = points.shape[0]
        dev = points.device
        cond = self.get_cond(images)
        if train:
            if keep is None:
                keep = torch.rand((B, 1, 1), generator=generator, device=dev) >= 0.1
            cond = cond * keep.to(dev, cond.dtype)
        latents = torch.nan_to_num(self.encode_points(points)).float()
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=dev)
        if t is None:
            t = torch.randint(0, self.schedule.num_train_timesteps, (B,), generator=generator,
                              device=dev)
        noise, t = noise.to(dev, torch.float32), t.to(dev)
        pred = self.dit(self.schedule.add_noise(latents, noise, t), cond, t)
        if self.schedule.prediction_type == "epsilon":
            target = noise
        else:
            target = self.schedule.get_velocity(latents, noise, t)
        err = (pred.float() - target).square()
        if opt.snr_gamma is None:
            loss = err.mean()
        else:
            w = self.schedule.min_snr_weight(t, opt.snr_gamma)
            loss = (err.mean(dim=tuple(range(1, err.dim()))) * w).mean()
        dp = active_data_parallel()
        if dp is not None:
            rows = torch.tensor(B, device=dev)
            loss = loss * (rows / dp_total(rows, dp))
        return {"loss": loss}

    def prepare_cond_cfg(self, images):
        """[uncond; cond] stacked on the batch: zeros, then get_cond."""
        cond = self.get_cond(images)
        return torch.cat([torch.zeros_like(cond), cond], dim=0)

    def denoise_step(self, latents, cond_cat, t: int, guidance_scale: float,
                     num_inference_steps: int):
        """One CFG DDIM update of latents [B, N, D] (f32) at host timestep t;
        cond_cat = [uncond; cond] on the batch, [2B, M, C]."""
        latent_in = torch.cat([latents, latents], dim=0)
        t_in = torch.full((latent_in.shape[0],), int(t), dtype=torch.int32,
                          device=latents.device)
        pred = self.dit(latent_in, cond_cat, t_in).float()
        uncond, cond = pred.chunk(2, dim=0)
        guided = uncond + guidance_scale * (cond - uncond)
        return ddim_step(self.schedule, guided, t, latents, num_inference_steps)


@torch.no_grad()
def run_mdit(model: MDiT, images, *, num_inference_steps: int = 100,
             guidance_scale: float = 7.5, num_repeat: int = 1,
             latents: Optional[torch.Tensor] = None, strength: float = 0.5,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DDIM sampling loop (reference: MDiT.run, models_dit.py:184-229).

    images [B, H, W, 3] in [0,1] (numpy or tensor). Returns the final
    latents [B * num_repeat, latent_size, latent_dim] in f32, repeats of one
    image next to each other. The initial noise is drawn from `generator`
    (one on the model's device, seeded with opt.seed when None), or is
    `noise` when given. With `latents` (img2img) the loop starts at step
    int(num_inference_steps * strength) from those latents noised to its
    timestep.
    """
    opt = model.opt
    device = next(model.parameters()).device
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(opt.seed)
    schedule = model.schedule
    ts = ddim_timesteps(schedule, num_inference_steps)

    cond_cat = model.prepare_cond_cfg(images)
    if num_repeat > 1:
        # jnp.repeat: each row repeated in place, [u0, u0, u1, u1, c0, c0, ...],
        # in line with denoise_step's [latents; latents]
        cond_cat = cond_cat.repeat_interleave(num_repeat, dim=0)
    shape = ((images.shape[0] * num_repeat, opt.point_latent_size, opt.point_latent_dim)
             if latents is None else tuple(latents.shape))
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
    if latents is None:
        lat, init_step = noise, 0
    else:
        init_step = int(num_inference_steps * strength)
        t0 = torch.full((shape[0],), int(ts[init_step]), device=device)
        lat = schedule.add_noise(torch.as_tensor(latents, dtype=torch.float32, device=device),
                                 noise, t0)
    for i in range(init_step, num_inference_steps):
        lat = model.denoise_step(lat, cond_cat, int(ts[i]), guidance_scale,
                                 num_inference_steps)
    return lat

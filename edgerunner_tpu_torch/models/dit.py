"""DiT denoiser over point latents of the port (edgerunner_tpu/models/dit.py).

The reference's PixArt-alpha-style DiT (core/transformer/dit.py:100-196):
adaLN-single conditioning (a learned scale_shift_table plus a 6-way
modulation per timestep), self-attention over the latent sequence,
cross-attention on the image features, GEGLU feed-forward. Parameter names
are the ones tools/export_reference_ckpt.py:_dit emits.

Kept as in the reference: the residual base after each modulated LayerNorm
is the *modulated* stream (dit.py:128-139), not the PixArt paper's pre-norm
residual; the LayerNorms are affine-free with eps 1e-6; the cross-attention
has neither LayerNorm nor gate; the final scale_shift_table is added to the
timestep embedding, not to its 6-way projection. Both attentions go through
`ops/attention.py`, so a CUDA tensor reaches the flash-attention kernel
(kernel A): at full width the self-attention is [2R, 2048, 2048, 16, 64] and
the cross-attention [2R, 2048 x 257, 16, 64], neither causal.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from edgerunner_tpu_torch.models.layers import (
    CrossAttention,
    FeedForward,
    SelfAttention,
    maybe_checkpoint,
)

DIT_LN_EPS = 1e-6


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: float = 10000.0):
    """Sinusoidal timestep features [B, dim] (reference: dit.py:45-76,
    flip_sin_to_cos=False, downscale_freq_shift=0)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=t.device) / half
    ang = t.float()[:, None] * torch.exp(exponent)[None]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _norm(x):
    """The affine-free LayerNorm of the DiT (eps 1e-6), computed in f32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=DIT_LN_EPS).to(x.dtype)


class TimestepEmbedding(nn.Module):
    """MLP over sinusoidal features (reference: dit.py:79-96)."""

    def __init__(self, in_dim: int, dim: int, **kw):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim, **kw)
        self.linear_2 = nn.Linear(dim, dim, **kw)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb.to(self.linear_1.weight.dtype))))


class DiTLayer(nn.Module):
    """adaLN-single transformer block (reference: dit.py:100-140); `remat`
    checkpoints the whole block (edgerunner_tpu/models/dit.py:58-85). The
    block has no dropout, so its replay in the backward pass is exact."""

    def __init__(self, dim: int, num_heads: int, *, use_kernels: bool = True,
                 remat: bool = False, tp=None, **kw):
        super().__init__()
        self.remat = remat
        self.scale_shift_table = nn.Parameter(torch.empty(6, dim, **kw))
        # attn1/attn2 stay whole under tp: the JAX package's TP_RULES do not name them
        self.attn1 = SelfAttention(dim, dim, num_heads, use_kernels=use_kernels, **kw)
        self.attn2 = CrossAttention(dim, dim, dim, num_heads, use_kernels=use_kernels, **kw)
        self.ff = FeedForward(dim, tp=tp, **kw)

    def forward(self, x, c, t_adaln):
        return maybe_checkpoint(self.remat, self._body, x, c, t_adaln)

    def _body(self, x, c, t_adaln):
        # x [B, N, C]; c [B, M, C]; t_adaln [B, 6, C]
        mods = (self.scale_shift_table[None].float() + t_adaln.float()).to(x.dtype)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods.chunk(6, dim=1)
        x = _norm(x) * (1 + scale_msa) + shift_msa
        x = x + gate_msa * self.attn1(x)
        x = x + self.attn2(x, c)
        x = _norm(x) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.ff(x)


class DiT(nn.Module):
    """Latent denoiser (reference: dit.py:143-196): latents [B, N,
    latent_dim], image features [B, M, hidden], timesteps [B] -> the model
    output (velocity or noise) [B, N, latent_dim]. `remat` checkpoints each
    layer (MDiT sets it from opt.checkpointing)."""

    def __init__(self, hidden_dim: int = 1024, num_heads: int = 16, latent_size: int = 2048,
                 latent_dim: int = 64, num_layers: int = 24, *, use_kernels: bool = True,
                 remat: bool = False, tp=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.hidden_dim = hidden_dim
        self.proj_in = nn.Linear(latent_dim, hidden_dim, **kw)
        self.pos_embed = nn.Parameter(torch.empty(1, latent_size, hidden_dim, **kw))
        self.timestep_proj = TimestepEmbedding(256, hidden_dim, **kw)
        self.adaln_linear = nn.Linear(hidden_dim, 6 * hidden_dim, **kw)
        self.layers = nn.ModuleList(DiTLayer(hidden_dim, num_heads, use_kernels=use_kernels,
                                             remat=remat, tp=tp, **kw)
                                    for _ in range(num_layers))
        self.scale_shift_table = nn.Parameter(torch.empty(2, hidden_dim, **kw))
        self.proj_out = nn.Linear(hidden_dim, latent_dim, **kw)

    def forward(self, x, c, t):
        B = x.shape[0]
        dtype = self.proj_in.weight.dtype
        x = self.proj_in(x.to(dtype)) + self.pos_embed
        t_emb = self.timestep_proj(timestep_embedding(t))
        t_adaln = self.adaln_linear(F.silu(t_emb)).reshape(B, 6, self.hidden_dim)
        c = c.to(dtype)
        for layer in self.layers:
            x = layer(x, c, t_adaln)
        mods = (self.scale_shift_table[None].float() + t_emb[:, None].float()).to(dtype)
        shift, scale = mods.chunk(2, dim=1)
        x = _norm(x) * (1 + scale) + shift
        return self.proj_out(x)

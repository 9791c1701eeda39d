"""Point-cloud latent encoders of the port (edgerunner_tpu/models/point_encoder.py:22-113).

Queries cross-attend over frequency-embedded surface points and project to
a compact latent (reference: point.py:23-205): a bank of learned queries
(point_encoder_mode 'embed'), or the embeds of farthest-point-sampled
points of the cloud itself ('downsample').
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from edgerunner_tpu_torch.models.layers import LN_EPS, ResCrossAttBlock
from edgerunner_tpu_torch.ops.pointops import farthest_point_sample


def point_freq_basis(freq_embed_dim: int = 48) -> np.ndarray:
    """Per-axis power-of-two frequency basis, [3, freq_embed_dim // 2]
    (reference: point.py:44-50)."""
    if freq_embed_dim % 6:
        raise ValueError(f"freq_embed_dim must divide by 6, got {freq_embed_dim}")
    n = freq_embed_dim // 6
    e = (2.0 ** np.arange(n)) * np.pi
    z = np.zeros(n)
    return np.stack([np.concatenate([e, z, z]), np.concatenate([z, e, z]),
                     np.concatenate([z, z, e])]).astype(np.float32)


class PointEmbed(nn.Module):
    """sin/cos frequency features + raw xyz -> linear (reference: point.py:37-65).

    `basis` is the fixed frequency table, not a weight. It is a buffer so that
    it appears in the state_dict under the reference's name, and it stays
    f32 whatever the weights' dtype: the features of f32 points are taken in
    f32, as the JAX package takes them.
    """

    def __init__(self, dim: int = 512, freq_embed_dim: int = 48, *,
                 device=None, dtype=None):
        super().__init__()
        self.register_buffer(
            "basis", torch.tensor(point_freq_basis(freq_embed_dim), device=device))
        self.mlp = nn.Linear(freq_embed_dim + 3, dim, device=device, dtype=dtype)

    def forward(self, pts):
        # f32 under autocast too: a bf16 product would lose the high frequencies
        with torch.autocast(pts.device.type, enabled=False):
            proj = pts @ self.basis.to(pts.dtype)
        feats = torch.cat([torch.sin(proj), torch.cos(proj), pts], dim=-1)
        return self.mlp(feats.to(self.mlp.weight.dtype))


class PointEncoderEmbed(nn.Module):
    """Learned-query cross-attention encoder (point_encoder_mode='embed',
    reference: point.py:172-205). `remat` checkpoints the cross-attention
    block, as the JAX package does under `checkpointing` (lmm.py:50-58)."""

    def __init__(self, hidden_dim: int = 1024, num_heads: int = 16,
                 latent_size: int = 2048, latent_dim: int = 64, *,
                 use_kernels: bool = True, remat: bool = False, tp=None, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.query_embed = nn.Parameter(torch.empty(1, latent_size, hidden_dim, **kw))
        self.point_embed = PointEmbed(hidden_dim, **kw)
        self.ln = nn.LayerNorm(hidden_dim, eps=LN_EPS, **kw)
        self.cross_att = ResCrossAttBlock(hidden_dim, num_heads, use_kernels=use_kernels,
                                          remat=remat, tp=tp, **kw)
        self.linear = nn.Linear(hidden_dim, latent_dim, **kw)

    def forward(self, pts):
        """pts [B, N, 3] -> latent [B, latent_size, latent_dim]."""
        x = self.ln(self.point_embed(pts))
        q = self.query_embed.expand(pts.shape[0], -1, -1)
        return self.linear(self.cross_att(q, x))


class PointEncoderFPS(nn.Module):
    """Farthest-point-sampled queries (point_encoder_mode='downsample',
    edgerunner_tpu/models/point_encoder.py:83-106; reference: point.py:129-169).
    `point_embed` embeds every point, which then goes through `ln`, and the
    `latent_size` points that farthest-point sampling picks, which do not;
    those are the queries of `cross_att`. There is no `query_embed`. The
    sampling takes no gradient and runs outside the checkpointed block."""

    def __init__(self, hidden_dim: int = 1024, num_heads: int = 16,
                 latent_size: int = 2048, latent_dim: int = 64, *,
                 use_kernels: bool = True, remat: bool = False, tp=None, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.latent_size = latent_size
        self.point_embed = PointEmbed(hidden_dim, **kw)
        self.ln = nn.LayerNorm(hidden_dim, eps=LN_EPS, **kw)
        self.cross_att = ResCrossAttBlock(hidden_dim, num_heads, use_kernels=use_kernels,
                                          remat=remat, tp=tp, **kw)
        self.linear = nn.Linear(hidden_dim, latent_dim, **kw)

    def forward(self, pts):
        """pts [B, N, 3] -> latent [B, latent_size, latent_dim]."""
        x = self.ln(self.point_embed(pts))
        idx = farthest_point_sample(pts, self.latent_size)
        query_pts = torch.take_along_dim(pts, idx[..., None], dim=1)
        return self.linear(self.cross_att(self.point_embed(query_pts), x))


def latent_kl(latent: torch.Tensor) -> torch.Tensor:
    """Deterministic-"VAE" regularizer: 0.5 * sum(latent^2), in f32 or wider
    (reference: point.py:33-35)."""
    return 0.5 * latent.to(torch.promote_types(latent.dtype, torch.float32)).square().sum()

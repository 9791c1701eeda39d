"""CLIP vision tower of the port, the frozen image conditioner
(edgerunner_tpu/models/clip_vit.py).

The reference conditions on laion/CLIP-ViT-H-14's last_hidden_state
[B, 257, 1280] (core/models.py:41). Parameter names are HuggingFace
`CLIPVisionModel`'s (`vision_model.embeddings...`, `vision_model.encoder.
layers.{i}...`), the names the JAX package's `convert_hf_clip_params` reads,
so a real ViT-H/14 state_dict loads with strict=True once `clip_state_from_hf`
has dropped the two entries the tower never reads. The attention is plain
PyTorch (einsum and softmax in f32), as it is plain XLA in the JAX package:
its head dim 80 is not one the flash kernels take. The MLP's GELU is the
exact erf form, the patch conv has no bias, every LayerNorm uses eps 1e-5.
Under tensor parallelism (`tp`) each layer's attention holds its share of
the heads and its MLP its share of fc1's columns (models/layers.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edgerunner_tpu_torch.models.layers import (
    normal_,
    row_linear,
    split_columns,
    split_rows,
    tp_for,
)
from edgerunner_tpu_torch.parallel.collectives import copy_to_tp

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

# HF CLIPVisionModel entries that the tower never reads (the JAX converter
# skips them too): the pooled output's LayerNorm and the position-id buffer
HF_UNUSED = ("vision_model.post_layernorm.weight", "vision_model.post_layernorm.bias",
             "vision_model.embeddings.position_ids")


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    # ViT-H/14 geometry
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1


def clip_config_from_options(opt) -> CLIPVisionConfig:
    """The tower's config from Options (defaults = ViT-H/14)."""
    return CLIPVisionConfig(
        image_size=opt.clip_image_size, patch_size=opt.clip_patch_size,
        hidden_size=opt.clip_hidden_dim, intermediate_size=opt.clip_intermediate_dim,
        num_layers=opt.clip_num_layers, num_heads=opt.clip_num_heads)


class CLIPAttention(nn.Module):
    """Under `tp` this rank's heads (models/layers.py)."""

    def __init__(self, c: CLIPVisionConfig, tp=None, **kw):
        super().__init__()
        self.tp = tp_for(tp, c.num_heads)
        n = 1 if self.tp is None else self.tp.size
        self.num_heads, self.head_dim = c.num_heads // n, c.hidden_size // c.num_heads
        width = c.hidden_size // n
        self.q_proj = nn.Linear(c.hidden_size, width, **kw)
        self.k_proj = nn.Linear(c.hidden_size, width, **kw)
        self.v_proj = nn.Linear(c.hidden_size, width, **kw)
        self.out_proj = nn.Linear(width, c.hidden_size, **kw)
        if self.tp is not None:
            for lin in (self.q_proj, self.k_proj, self.v_proj):
                split_columns(lin)
            split_rows(self.out_proj)

    def forward(self, x):
        B, N, C = x.shape
        H, D = self.num_heads, self.head_dim
        xt = copy_to_tp(x, self.tp)
        q, k, v = (p(xt).reshape(B, N, H, D) for p in (self.q_proj, self.k_proj, self.v_proj))
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k).float() / math.sqrt(D)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(B, N, H * D)
        return row_linear(self.out_proj, o, self.tp)


class CLIPMLP(nn.Module):
    """Under `tp` this rank's columns of fc1 and rows of fc2."""

    def __init__(self, c: CLIPVisionConfig, tp=None, **kw):
        super().__init__()
        self.tp = tp_for(tp, c.intermediate_size)
        n = 1 if self.tp is None else self.tp.size
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size // n, **kw)
        self.fc2 = nn.Linear(c.intermediate_size // n, c.hidden_size, **kw)
        if self.tp is not None:
            split_columns(self.fc1)
            split_rows(self.fc2)

    def forward(self, x):
        # exact GELU, as jax.nn.gelu(approximate=False)
        return row_linear(self.fc2, F.gelu(self.fc1(copy_to_tp(x, self.tp))), self.tp)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, c: CLIPVisionConfig, tp=None, **kw):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, **kw)
        self.self_attn = CLIPAttention(c, tp, **kw)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, **kw)
        self.mlp = CLIPMLP(c, tp, **kw)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig, **kw):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(c.hidden_size, **kw))
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size,
                                         bias=False, **kw)
        self.position_embedding = nn.Embedding(c.seq_len, c.hidden_size, **kw)

    def forward(self, pixels):
        """pixels [B, H, W, 3] -> [B, 1 + patches, hidden]."""
        w = self.patch_embedding.weight
        patches = self.patch_embedding(pixels.permute(0, 3, 1, 2).to(w.dtype))
        patches = patches.flatten(2).transpose(1, 2)  # row-major patches, as flax's reshape
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight[None]


class CLIPEncoder(nn.Module):
    def __init__(self, c: CLIPVisionConfig, tp=None, **kw):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(c, tp, **kw) for _ in range(c.num_layers))


class CLIPVisionTransformer(nn.Module):
    def __init__(self, c: CLIPVisionConfig, tp=None, **kw):
        super().__init__()
        self.embeddings = CLIPEmbeddings(c, **kw)
        self.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps, **kw)
        self.encoder = CLIPEncoder(c, tp, **kw)

    def forward(self, pixels):
        x = self.pre_layrnorm(self.embeddings(pixels))
        for layer in self.encoder.layers:
            x = layer(x)
        return x


class CLIPVisionTower(nn.Module):
    """last_hidden_state [B, 257, hidden] for pixels [B, H, W, 3] already
    normalised with the CLIP mean and std (`preprocess_images`)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(), *, tp=None, device=None,
                 dtype=None):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg, tp, device=device, dtype=dtype)

    def forward(self, pixels):
        return self.vision_model(pixels)


@torch.no_grad()
def init_clip_tower(tower: CLIPVisionTower, gen: torch.Generator) -> CLIPVisionTower:
    """Random tower weights from `gen` at flax's default scales, as the JAX
    package initialises the tower: the projections and the patch conv
    N(0, 1/fan_in) (lecun_normal), the class and position embeddings
    N(0, 0.02), zero biases, unit LayerNorms."""
    for mod in tower.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            normal_(mod.weight, 0.0, mod.weight[0].numel() ** -0.5, gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 0.0, 0.02, gen)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    normal_(tower.vision_model.embeddings.class_embedding, 0.0, 0.02, gen)
    return tower


def preprocess_images(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[B, H, W, 3] in [0,1] -> resized and CLIP-normalised [B, size, size, 3].

    The resize is bilinear with antialiasing when it shrinks, as
    `jax.image.resize(..., "bilinear")` is."""
    B, H, W, _ = images.shape
    images = images.float()
    if (H, W) != (size, size):
        images = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size),
                               mode="bilinear", antialias=True,
                               align_corners=False).permute(0, 2, 3, 1)
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=images.device)
    std = torch.as_tensor(CLIP_IMAGE_STD, device=images.device)
    return (images - mean) / std


def clip_state_from_hf(state_dict: dict, prefix: str = "") -> dict:
    """A HuggingFace CLIPVisionModel state_dict -> the tower's (under
    `prefix`, e.g. 'image_encoder.'): the names are the same; the entries in
    HF_UNUSED are dropped. Any other name that the tower lacks fails the
    strict load that follows."""
    return {prefix + k: v for k, v in state_dict.items() if k not in HF_UNUSED}

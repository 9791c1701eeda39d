"""LMM, the ArAE top-level model of the port (edgerunner_tpu/models/lmm.py:36-196).

Point-cloud conditioner (point encoder -> proj_cond -> norm_cond), the
num-face bucket token, and the ShapeOPT decoder, with the `prefill` / `step`
pair that generate.py drives. Conditioning modes 'point' and 'none' are
ported; 'image' and 'point_latent' wait for later slices.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from edgerunner_tpu_torch.config import Options, vocab_size_for
from edgerunner_tpu_torch.models.layers import LN_EPS
from edgerunner_tpu_torch.models.point_encoder import PointEncoderEmbed, latent_kl
from edgerunner_tpu_torch.models.shape_opt import Caches, ShapeOPT, ShapeOPTConfig
from edgerunner_tpu_torch.utils import quantize_num_faces


class LMM(nn.Module):
    """`use_kernels=False` runs the plain attention versions on every device:
    the reference path that a kernel path is checked against."""

    def __init__(self, opt: Options, *, dtype=torch.float32, device=None,
                 use_kernels: bool = True):
        super().__init__()
        if opt.cond_mode not in ("point", "none"):
            raise ValueError(f"the port does not implement cond_mode {opt.cond_mode!r}")
        kw = dict(device=device, dtype=dtype)
        self.opt = opt
        self.vocab_size = vocab_size_for(opt)
        if opt.cond_mode == "point":
            self.point_encoder = PointEncoderEmbed(
                opt.point_hidden_dim, opt.point_num_heads, opt.point_latent_size,
                opt.point_latent_dim, use_kernels=use_kernels, **kw)
            self.proj_cond = nn.Linear(opt.point_latent_dim, opt.hidden_dim, **kw)
            self.norm_cond = nn.LayerNorm(opt.hidden_dim, eps=LN_EPS, **kw)
        if opt.use_num_face_cond:
            self.embed_num_face = nn.Embedding(10, opt.hidden_dim, **kw)
        self.cfg = ShapeOPTConfig(
            vocab_size=self.vocab_size,
            hidden_dim=opt.hidden_dim,
            intermediate_dim=(opt.hidden_dim * 4 if opt.intermediate_dim is None
                              else opt.intermediate_dim),
            num_hidden_layers=opt.num_layers,
            num_attention_heads=opt.num_heads,
            max_position_embeddings=opt.max_seq_length + opt.num_cond_tokens + 10,
            pad_token_id=opt.pad_token_id,
        )
        self.mesh_decoder = ShapeOPT(self.cfg, use_kernels=use_kernels, **kw)

    def encode_cond(self, conds, num_faces):
        """conds: points [B, N, 3] (point mode); num_faces: [B] int.
        Returns (cond_embeds [B, C, hidden] or None, kl scalar)."""
        kl = torch.zeros((), device=num_faces.device)
        cond_embeds = None
        if self.opt.cond_mode == "point":
            latent = self.point_encoder(conds)
            kl = latent_kl(latent)
            cond_embeds = self.norm_cond(self.proj_cond(latent))
        if self.opt.use_num_face_cond:
            nf = self.embed_num_face(quantize_num_faces(num_faces))[:, None]
            cond_embeds = nf if cond_embeds is None else torch.cat([cond_embeds, nf], 1)
        return cond_embeds, kl

    def prefill(self, conds, num_faces, prompt_ids, max_len: int):
        """Encode cond + prompt ids [B, P]; fill max_len caches. Returns
        (next-token logits [B, 1, V], caches, prompt length incl. cond)."""
        cond_embeds, _ = self.encode_cond(conds, num_faces)
        embeds = self.mesh_decoder.embed_tokens(prompt_ids)
        if cond_embeds is not None:
            embeds = torch.cat([cond_embeds, embeds], dim=1)
        logits, caches = self.mesh_decoder.prefill(embeds, max_len)
        return logits, caches, embeds.shape[1]

    def step(self, token_ids, caches: Caches, index: int):
        return self.mesh_decoder.step(token_ids, caches, index)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from `seed`, with the JAX package's init distributions:
    N(0, 0.02) for projections and embeddings (pad row zero), decoder
    out-projections scaled by 1/sqrt(2L), queries N(0, hidden^-0.5), zero
    biases, unit LayerNorms. Draws on the weights' own device."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    std = 0.02
    n_layers = getattr(getattr(model, "cfg", None), "num_hidden_layers", 1)
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            s = std / math.sqrt(2 * n_layers) if name.endswith("self_attn.out_proj") else std
            mod.weight.normal_(0.0, s, generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, std, generator=gen)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("query_embed"):
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=gen)
    decoder = getattr(model, "mesh_decoder", None)
    if decoder is not None:
        decoder.model.embd.weight[decoder.cfg.pad_token_id] = 0.0
    return model

"""LMM, the ArAE top-level model of the port (edgerunner_tpu/models/lmm.py:36-196).

The conditioner (point encoder or CLIP tower -> proj_cond -> norm_cond), the
num-face bucket token, and the ShapeOPT decoder: the teacher-forcing
`forward` with its loss, which training drives, the `prefill` / `step`
pair that generate.py drives, `verify_step`, through which the serving
engine decodes and speculative decoding verifies its proposals, and
`mtp_logits`, the draft heads' logits. Every conditioning mode of the JAX
package is ported: 'point', 'none', 'point_latent' (the DiT pipeline's
latents [B, 2048, 64] through proj_cond and norm_cond, no point encoder)
and 'image' (the default preset: images [B, H, W, 3] in [0, 1] through the
CLIP tower's last hidden state [B, 257, 1280], frozen under
`freeze_encoder`; lmm.py:44-47, :111-116). `checkpointing` turns on
gradient checkpointing of the point encoder's block and of each decoder
layer, as in the JAX package (lmm.py:50-58, :80-82).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from edgerunner_tpu_torch.config import Options, vocab_size_for
from edgerunner_tpu_torch.models.clip_vit import (
    CLIPVisionTower,
    clip_config_from_options,
    init_clip_tower,
    preprocess_images,
)
from edgerunner_tpu_torch.models.layers import LN_EPS
from edgerunner_tpu_torch.models.point_encoder import PointEncoderEmbed, latent_kl
from edgerunner_tpu_torch.models.shape_opt import Caches, ShapeOPT, ShapeOPTConfig
from edgerunner_tpu_torch.parallel.mesh import active_sequence_parallel
from edgerunner_tpu_torch.utils import quantize_num_faces


class LMM(nn.Module):
    """`use_kernels=False` runs the plain attention versions on every device:
    the reference path that a kernel path is checked against."""

    def __init__(self, opt: Options, *, dtype=torch.float32, device=None,
                 use_kernels: bool = True):
        super().__init__()
        if opt.cond_mode not in ("point", "point_latent", "image", "none"):
            raise ValueError(f"the port does not implement cond_mode {opt.cond_mode!r}")
        kw = dict(device=device, dtype=dtype)
        self.opt = opt
        self.vocab_size = vocab_size_for(opt)
        if opt.cond_mode == "image":
            # its attention stays plain, as in the JAX package: head dim 80
            # is no instance of the flash kernels
            self.image_encoder = CLIPVisionTower(clip_config_from_options(opt), **kw)
            self.proj_cond = nn.Linear(opt.clip_hidden_dim, opt.hidden_dim, **kw)
            self.norm_cond = nn.LayerNorm(opt.hidden_dim, eps=LN_EPS, **kw)
        if opt.cond_mode == "point":
            self.point_encoder = PointEncoderEmbed(
                opt.point_hidden_dim, opt.point_num_heads, opt.point_latent_size,
                opt.point_latent_dim, use_kernels=use_kernels,
                remat=opt.checkpointing, **kw)
        if opt.cond_mode in ("point", "point_latent"):
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
            remat=opt.checkpointing,
            kv_quant=opt.kv_quant,
            kv_bits=opt.kv_bits,
            kv_group=opt.kv_group,
            kv_rotate=opt.kv_rotate,
            mtp_heads=opt.mtp_heads,
        )
        self.mesh_decoder = ShapeOPT(self.cfg, use_kernels=use_kernels, **kw)

    def encode_cond(self, conds, num_faces):
        """conds: points [B, N, 3] (point mode), latents [B, L, D]
        (point_latent mode) or images [B, H, W, 3] in [0, 1] (image mode,
        resized inside); num_faces: [B] int.
        Returns (cond_embeds [B, C, hidden] or None, kl scalar)."""
        kl = torch.zeros((), device=num_faces.device)
        cond_embeds = None
        if self.opt.cond_mode == "image":
            pixels = preprocess_images(conds, size=self.opt.clip_image_size)
            # a frozen tower takes no gradient (the JAX package's stop_gradient)
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not self.opt.freeze_encoder):
                feats = self.image_encoder(pixels)
            cond_embeds = self.norm_cond(self.proj_cond(feats))
        elif self.opt.cond_mode == "point":
            latent = self.point_encoder(conds)
            kl = latent_kl(latent)
            cond_embeds = self.norm_cond(self.proj_cond(latent))
        elif self.opt.cond_mode == "point_latent":
            cond_embeds = self.norm_cond(self.proj_cond(conds.to(self.proj_cond.weight.dtype)))
        if self.opt.use_num_face_cond:
            nf = self.embed_num_face(quantize_num_faces(num_faces))[:, None]
            cond_embeds = nf if cond_embeds is None else torch.cat([cond_embeds, nf], 1)
        return cond_embeds, kl

    def forward(self, conds, tokens, labels, num_faces, lengths, *,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """Teacher-forcing forward and loss (edgerunner_tpu/models/lmm.py:134-170).

        tokens [B, 1+M+1] (BOS, coords, EOS, PAD); labels [B, C+1+M+1] with
        -100 on cond, BOS and pad; lengths [B] valid total lengths. In
        training, num-face dropout draws from `generator` and the decoder
        applies dropout. Returns dict(loss, loss_ce, loss_kl, logits), and
        loss_mtp with draft heads (added to loss times mtp_loss_weight).

        Under an sp context (parallel/mesh.py) the condition encoder runs
        whole on every rank, the decoder on the rank's shard of the
        sequence, and logits are the shard's; every loss returned is this
        rank's share, and the shares add up over the ranks to the unsharded
        loss: the cross-entropies are sharded sums over the global count of
        labels, and loss_kl, computed whole on every rank, enters as kl / R,
        so that the gradients summed over the ranks count it once. Under a
        dp context each dp group's rows are its own: the cross-entropies
        are divided by the count of every group's labels (shape_opt.py
        `shifted_cross_entropy`), and loss_kl, a sum over rows, is the
        group's, so that the shares of the whole world add up to the loss
        of the dp groups' whole batch (edgerunner_tpu/models/lmm.py:134-170,
        point_encoder.py:110-113).
        """
        opt = self.opt
        if train and opt.use_num_face_cond and opt.nof_dropout_ratio > 0:
            # num-face dropout: train the unconditional bucket some of the time
            device = num_faces.device if generator is None else generator.device
            drop = torch.rand(num_faces.shape[0], generator=generator, device=device)
            num_faces = torch.where(drop.to(num_faces.device) < opt.nof_dropout_ratio,
                                    -1, num_faces)
        cond_embeds, kl = self.encode_cond(conds, num_faces)
        embeds = self.mesh_decoder.embed_tokens(tokens)
        if cond_embeds is not None:
            embeds = torch.cat([cond_embeds.to(embeds.dtype), embeds], dim=1)
        logits, loss_ce, loss_mtp = self.mesh_decoder(embeds, lengths, labels=labels,
                                                      train=train)
        out = {"loss_ce": loss_ce, "logits": logits}
        loss = loss_ce
        sp = active_sequence_parallel()
        if sp is not None:
            kl = kl / sp.size
        if opt.cond_mode == "point":
            out["loss_kl"] = kl
            loss = loss + opt.kl_weight * kl
        if loss_mtp is not None:
            out["loss_mtp"] = loss_mtp
            loss = loss + opt.mtp_loss_weight * loss_mtp
        out["loss"] = loss
        return out

    def prefill(self, conds, num_faces, prompt_ids, max_len: int, with_hidden: bool = False):
        """Encode cond + prompt ids [B, P]; fill max_len caches. Returns
        (next-token logits [B, 1, V], caches, prompt length incl. cond), and
        with `with_hidden` the last hidden state [B, 1, C] after them."""
        cond_embeds, _ = self.encode_cond(conds, num_faces)
        embeds = self.mesh_decoder.embed_tokens(prompt_ids)
        if cond_embeds is not None:
            embeds = torch.cat([cond_embeds, embeds], dim=1)
        logits, caches, *h_last = self.mesh_decoder.prefill(embeds, max_len, with_hidden)
        return (logits, caches, embeds.shape[1], *h_last)

    def step(self, token_ids, caches: Caches, index: int):
        return self.mesh_decoder.step(token_ids, caches, index)

    def verify_step(self, token_ids, caches: Caches, index_vec, with_hidden: bool = False):
        """T tokens per row at per-row positions (edgerunner_tpu/models/lmm.py:190-192):
        logits [B, T, V], and with `with_hidden` the hidden states [B, T, C];
        the caches are updated in place."""
        return self.mesh_decoder.verify_step(token_ids, caches, index_vec, with_hidden)

    def mtp_logits(self, h) -> list:
        """The draft heads' logits of hidden states h (lmm.py:194-195)."""
        return self.mesh_decoder.mtp_logits(h)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from `seed`, with the JAX package's init distributions:
    N(0, 0.02) for projections and embeddings (pad row zero), decoder
    out-projections scaled by 1/sqrt(2L), queries N(0, hidden^-0.5), zero
    biases, unit LayerNorms; a CLIP tower at flax's defaults
    (`init_clip_tower`). Draws on the weights' own device."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    std = 0.02
    n_layers = getattr(getattr(model, "cfg", None), "num_hidden_layers", 1)
    for name, mod in model.named_modules():
        if name.startswith("image_encoder"):
            continue
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
    if hasattr(model, "image_encoder"):
        init_clip_tower(model.image_encoder, gen)
    decoder = getattr(model, "mesh_decoder", None)
    if decoder is not None:
        decoder.model.embd.weight[decoder.cfg.pad_token_id] = 0.0
        for head in decoder.mtp_proj:  # zero-initialised, as in the JAX package
            head.weight.zero_()
    return model

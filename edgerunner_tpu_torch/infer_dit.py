"""Image-to-mesh inference CLI of the port: image -> DiT DDIM -> point latent
-> ArAE -> mesh (the counterpart of infer_dit.py; reference: infer_dit.py:34-144).

    python -m edgerunner_tpu_torch.infer_dit ArAE --test_path img.png|dir \\
        --workspace out/ [--resume arae.safetensors] [--resume2 dit.safetensors] \\
        [--device cuda|cpu]

Each image is loaded, its background removed and recentred
(data/image_io.py; PIL reads the file). For each group of `test_batch_size`
repeats one DDIM run of 100 steps at guidance 7.5 yields that many latents,
and one batched decode turns them into meshes: {name}_{i}[_{nf}f].obj and
the tokens are written, and the time per mesh printed. Both models run in
f32, as the JAX CLI builds them. The ArAE weights come from `--resume` (a
checkpoint trained in 'point' mode: its point encoder is dropped), the MDiT's
from `--resume2`; either is drawn from `--seed` when not given, with a
warning. The models run on the card unless `--device cpu` is given; without
a card and without `--device cpu` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import time
from typing import List, Optional

import numpy as np
import torch

from edgerunner_tpu_torch.config import parse_cli, validate
from edgerunner_tpu_torch.data import save_mesh
from edgerunner_tpu_torch.generate import generate_tokens, trim_eos
from edgerunner_tpu_torch.infer import load_model, resolve_device
from edgerunner_tpu_torch.models.mdit import MDiT, run_mdit
from edgerunner_tpu_torch.utils import get_tokenizer
from edgerunner_tpu_torch.weights import load_mdit

DDIM_STEPS = 100
GUIDANCE_SCALE = 7.5


def load_models(opt, device: torch.device):
    """(the point_latent LMM, the MDiT), both f32, with their weights."""
    model = load_model(opt, device, dtype=torch.float32)
    if opt.resume:
        print(f"[INFO] Loaded ArAE checkpoint from {opt.resume}")
    else:
        print("[WARN] ArAE randomly initialized, are you sane?")
    model_dit = load_mdit(MDiT(opt, device=device), opt)
    if opt.resume2:
        print(f"[INFO] Loaded DiT checkpoint from {opt.resume2}")
    else:
        print("[WARN] DiT randomly initialized, are you sane?")
    return model, model_dit


def ddim_latents(model_dit: MDiT, image, num_repeat: int, generator) -> torch.Tensor:
    """The CLI's DDIM run: latents [num_repeat, 2048, 64] for one image
    [1, H, W, 3]."""
    return run_mdit(model_dit, image, num_inference_steps=DDIM_STEPS,
                    guidance_scale=GUIDANCE_SCALE, num_repeat=num_repeat, generator=generator)


def process(opt, model, model_dit, tokenizer, path: str, generator: torch.Generator):
    from edgerunner_tpu_torch.data.image_io import load_image_cond

    name = os.path.splitext(os.path.basename(path))[0]
    image = load_image_cond(path)[None]  # [1, H, W, 3]
    # batched repeats: one DDIM run gives test_batch_size latents and one
    # batched decode generates them together
    group = max(1, opt.test_batch_size)
    for i0 in range(0, opt.test_repeat, group):
        nrep = min(group, opt.test_repeat - i0)
        for num_faces in opt.test_num_face:
            t0 = time.time()
            latents = ddim_latents(model_dit, image, nrep, generator)
            all_tokens = generate_tokens(model, latents, num_faces=num_faces,
                                         max_new_tokens=opt.test_max_seq_length,
                                         generator=generator, use_grammar=opt.use_meto)
            t1 = time.time()
            for j in range(nrep):
                filename = f"{name}_{i0 + j}"
                if opt.use_num_face_cond:
                    filename += f"_{num_faces}f"
                _, faces = save_mesh(all_tokens[j], opt,
                                     os.path.join(opt.workspace, filename + ".obj"),
                                     tokenizer=tokenizer, clean=True, verbose=True)
                np.save(os.path.join(opt.workspace, filename + "_tokens.npy"),
                        trim_eos(all_tokens[j]) - 3)
                print(f"[INFO] {path} --> {filename}.obj ({faces.shape[0]} faces), "
                      f"time = {(t1 - t0) / nrep:.4f}s/mesh")


def main(argv: Optional[List[str]] = None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    device = resolve_device(args.device)
    opt = validate(parse_cli(rest, prog="python -m edgerunner_tpu_torch.infer_dit"))
    # the LMM takes the DiT's latents (reference: infer_dit.py:55)
    opt = validate(dataclasses.replace(opt, cond_mode="point_latent"))
    if opt.test_path is None:
        raise ValueError("--test_path is required")
    tokenizer, _ = get_tokenizer(opt)
    model, model_dit = load_models(opt, device)
    os.makedirs(opt.workspace, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    paths = (sorted(glob.glob(os.path.join(opt.test_path, "*")))
             if os.path.isdir(opt.test_path) else [opt.test_path])
    with torch.inference_mode():
        for path in paths:
            process(opt, model, model_dit, tokenizer, path, generator)


if __name__ == "__main__":
    main()

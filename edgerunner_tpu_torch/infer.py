"""ArAE inference CLI of the port (the counterpart of infer.py:36-140).

    python -m edgerunner_tpu_torch.infer ArAE --test_path mesh.obj \\
        --resume weights.safetensors --workspace out/ [--device cuda|cpu]

Loads the mesh, cleans and normalises it, samples `point_num` surface
points, generates `test_repeat` meshes per face count and writes
{name}_{i}[_{nf}f].ply plus the tokens. Weights come from a reference-format
.safetensors file (tools/export_reference_ckpt.py), or are drawn from
`--seed` without `--resume`. `--kv_quant true` decodes over the int8 KV
cache, with `--kv_bits 4` over the int4 cache (`--kv_group N` lanes per
scale, `--kv_rotate true` rotated rows); `--w_quant true` quantises the
decoder's projections after the weights load; `--mtp_heads N --spec_decode
true --generate_mode greedy` decodes speculatively with the draft heads of
the weights. The model runs on the card unless `--device cpu` is given;
without a card and without `--device cpu` it raises.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import List, Optional

import numpy as np
import torch

from edgerunner_tpu_torch.config import parse_cli, validate
from edgerunner_tpu_torch.data import clean_mesh, load_mesh, normalize_mesh, save_mesh, save_mesh_file
from edgerunner_tpu_torch.generate import generate_tokens, trim_eos
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.ops.pointops import sample_surface_points
from edgerunner_tpu_torch.utils import get_tokenizer
from edgerunner_tpu_torch.weights import load_for_inference


def resolve_device(name: str) -> torch.device:
    """The device to run on; 'cuda' without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to "
                           "run on the CPU")
    return device


def load_model(opt, device: torch.device, dtype=torch.bfloat16) -> LMM:
    """The LMM of `opt` with its weights (weights.load_for_inference): with
    `--kv_quant` it decodes over the int8 or int4 cache, with `--w_quant` its
    decoder projections are quantised after the exact weights are loaded."""
    return load_for_inference(LMM(opt, dtype=dtype, device=device), opt)


def process(opt, model: LMM, tokenizer, path: str, generator: torch.Generator):
    name = os.path.splitext(os.path.basename(path))[0]
    os.makedirs(opt.workspace, exist_ok=True)
    v, f = clean_mesh(*load_mesh(path))
    v = normalize_mesh(v, bound=0.95)
    points = sample_surface_points(v, f, opt.point_num, np.random.default_rng(opt.seed))
    save_mesh_file(os.path.join(opt.workspace, f"{name}_pc.obj"), points,
                   np.zeros((0, 3), np.int64))
    resume_ids = None
    if opt.test_resume_tokens:
        resume_ids = np.load(opt.test_resume_tokens)[None] + 3

    B = max(1, opt.test_batch_size)
    for i0 in range(0, opt.test_repeat, B):
        nrep = min(B, opt.test_repeat - i0)
        for num_faces in opt.test_num_face:
            t0 = time.time()
            all_tokens = generate_tokens(
                model, np.repeat(points[None], nrep, axis=0), num_faces=num_faces,
                max_new_tokens=opt.test_max_seq_length,
                resume_ids=None if resume_ids is None else np.repeat(resume_ids, nrep, 0),
                generator=generator, use_grammar=opt.use_meto)
            t1 = time.time()
            for j in range(nrep):
                filename = f"{name}_{i0 + j}"
                if opt.use_num_face_cond:
                    filename += f"_{num_faces}f"
                _, faces = save_mesh(all_tokens[j], opt,
                                     os.path.join(opt.workspace, filename + ".ply"),
                                     tokenizer=tokenizer, clean=True, verbose=True)
                np.save(os.path.join(opt.workspace, filename + "_tokens.npy"),
                        trim_eos(all_tokens[j]) - 3)
                print(f"[INFO] Processing {path} --> {filename}.ply "
                      f"({faces.shape[0]} faces), time = {(t1 - t0) / nrep:.4f}s/mesh")


def main(argv: Optional[List[str]] = None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    device = resolve_device(args.device)
    opt = validate(parse_cli(rest, prog="python -m edgerunner_tpu_torch.infer"))
    if opt.cond_mode != "point":
        raise ValueError("the port's infer entry conditions on a point cloud "
                         "(cond_mode 'point')")
    if opt.test_path is None:
        raise ValueError("--test_path is required")
    tokenizer, _ = get_tokenizer(opt)
    model = load_model(opt, device)
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    paths = (sorted(glob.glob(os.path.join(opt.test_path, "*")))
             if os.path.isdir(opt.test_path) else [opt.test_path])
    for path in paths:
        process(opt, model, tokenizer, path, generator)


if __name__ == "__main__":
    main()

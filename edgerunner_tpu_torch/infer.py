"""ArAE inference CLI of the port (the counterpart of infer.py:36-140).

    python -m edgerunner_tpu_torch.infer ArAE --test_path mesh.obj \\
        --resume weights.safetensors --workspace out/ [--device cuda|cpu]
    python -m edgerunner_tpu_torch.infer default --test_path image.png ...

The condition of each input (`prepare_cond`): in point mode (ArAE) the
mesh, cleaned and normalised, gives `point_num` surface points (written as
{name}_pc.obj); in image mode (the default preset) the image, its
background removed and recentred, at 512 x 512; in 'none' mode nothing.
Then `test_repeat` meshes per face count (`generate_meshes`), written as
{name}_{i}[_{nf}f].ply plus the tokens. Weights come from a reference-format
.safetensors file (tools/export_reference_ckpt.py), or are drawn from
`--seed` without `--resume`; `--resume2` merges a second, possibly partial
file over them (e.g. a pretrained CLIP tower, also in HuggingFace's
naming). `--kv_quant true` decodes over the int8 KV
cache, with `--kv_bits 4` over the int4 cache (`--kv_group N` lanes per
scale, `--kv_rotate true` rotated rows); `--w_quant true` quantises the
decoder's projections after the weights load; `--mtp_heads N --spec_decode
true --generate_mode greedy` decodes speculatively with the draft heads of
the weights. The model runs on the card unless `--device cpu` is given;
without a card and without `--device cpu` it raises.

`--dp_size N` (N > 1) decodes as a fleet (generate.py `generate_fleet`):
one replica of the model on each of cuda:0 .. N-1 (N replicas on the CPU
with `--device cpu`), `--test_batch_size` rows split over them; it raises
when fewer cards are present or when the batch does not divide by N. A
trailing repeat group that does not divide decodes on the first device
(infer.py:79-82).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import List, Optional

import numpy as np
import torch

from edgerunner_tpu_torch.config import parse_cli, refuse_stacked_layout, validate
from edgerunner_tpu_torch.data import clean_mesh, load_mesh, normalize_mesh, save_mesh, save_mesh_file
from edgerunner_tpu_torch.generate import generate_tokens, replicate_model, trim_eos
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


def load_model(opt, device: torch.device, dtype=torch.bfloat16,
               overlay: Optional[str] = None) -> LMM:
    """The LMM of `opt` with its weights (weights.load_for_inference), and
    the file `overlay` merged over them (infer's `--resume2`): with
    `--kv_quant` it decodes over the int8 or int4 cache, with `--w_quant` its
    decoder projections are quantised after the exact weights are loaded.
    The decode paths take the per-layer layout alone, as the JAX package's
    assert (shape_opt.py:594-597): `--scan_layers` (and `--pp_size` > 1,
    which sets it) is refused; `--tp_size` is ignored, as every mesh
    option is by the JAX decode paths."""
    refuse_stacked_layout(opt, "decoding (infer, infer_dit, serve)")
    return load_for_inference(LMM(opt, dtype=dtype, device=device), opt, overlay)


def prepare_cond(opt, path: str, rng: np.random.Generator) -> np.ndarray:
    """The condition that an input file gives (infer.py:37-49): surface
    points [1, N, 3] of the cleaned mesh, the image [1, 512, 512, 3] in
    [0, 1], or [1, 0] without a condition."""
    if opt.cond_mode == "point":
        v, f = clean_mesh(*load_mesh(path))
        v = normalize_mesh(v, bound=0.95)
        return sample_surface_points(v, f, opt.point_num, rng)[None].astype(np.float32)
    if opt.cond_mode == "image":
        from edgerunner_tpu_torch.data.image_io import load_image_cond

        return load_image_cond(path)[None]
    if opt.cond_mode == "none":
        return np.zeros((1, 0), np.float32)
    raise ValueError(f"cond_mode {opt.cond_mode} not supported by infer "
                     "(point_latent: python -m edgerunner_tpu_torch.infer_dit)")


def fleet_devices(n: int, device: torch.device) -> List[torch.device]:
    """The devices of a fleet of `n` (`--dp_size`): cuda:0 .. n-1, raising
    when fewer cards are present, or n times the CPU."""
    if device.type != "cuda":
        return [device] * n
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"--dp_size {n} needs as many cards, and "
                           f"{torch.cuda.device_count()} are present")
    return [torch.device("cuda", i) for i in range(n)]


def process(opt, model, tokenizer, path: str, generator: torch.Generator,
            devices: Optional[List[torch.device]] = None):
    name = os.path.splitext(os.path.basename(path))[0]
    os.makedirs(opt.workspace, exist_ok=True)
    cond = prepare_cond(opt, path, np.random.default_rng(opt.seed))
    if opt.cond_mode == "point":
        save_mesh_file(os.path.join(opt.workspace, f"{name}_pc.obj"), cond[0],
                       np.zeros((0, 3), np.int64))
    generate_meshes(opt, model, tokenizer, name, cond, generator, source=path,
                    devices=devices)


def generate_meshes(opt, model, tokenizer, name: str, cond: np.ndarray,
                    generator: torch.Generator, source: Optional[str] = None,
                    devices: Optional[List[torch.device]] = None) -> List[str]:
    """What follows the read of an input: `test_repeat` meshes of the
    condition `cond` [1, ...] per face count, `test_batch_size` rows at a
    time, each written as {name}_{i}[_{nf}f].ply with its tokens. Returns
    the .ply paths. With `devices` (a fleet), `model` is the list of its
    replicas; a repeat group that does not divide over them decodes on the
    first."""
    source = source or name
    os.makedirs(opt.workspace, exist_ok=True)
    written = []
    resume_ids = None
    if opt.test_resume_tokens:
        resume_ids = np.load(opt.test_resume_tokens)[None] + 3

    B = max(1, opt.test_batch_size)
    for i0 in range(0, opt.test_repeat, B):
        nrep = min(B, opt.test_repeat - i0)
        for num_faces in opt.test_num_face:
            t0 = time.time()
            fleet = devices if devices is not None and nrep % len(devices) == 0 else None
            all_tokens = generate_tokens(
                model, np.repeat(cond, nrep, axis=0), num_faces=num_faces,
                max_new_tokens=opt.test_max_seq_length,
                resume_ids=None if resume_ids is None else np.repeat(resume_ids, nrep, 0),
                generator=generator, use_grammar=opt.use_meto, devices=fleet)
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
                written.append(os.path.join(opt.workspace, filename + ".ply"))
                print(f"[INFO] Processing {source} --> {filename}.ply "
                      f"({faces.shape[0]} faces), time = {(t1 - t0) / nrep:.4f}s/mesh")
    return written


def main(argv: Optional[List[str]] = None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    args, rest = pre.parse_known_args(argv)
    device = resolve_device(args.device)
    opt = validate(parse_cli(rest, prog="python -m edgerunner_tpu_torch.infer"))
    if opt.cond_mode == "point_latent":
        raise ValueError("cond_mode 'point_latent' takes the DiT's latents: run "
                         "python -m edgerunner_tpu_torch.infer_dit")
    if opt.test_path is None:
        raise ValueError("--test_path is required")
    tokenizer, _ = get_tokenizer(opt)
    devices = None
    if opt.dp_size > 1:
        if opt.test_batch_size % opt.dp_size:
            raise ValueError(f"--test_batch_size {opt.test_batch_size} must divide by "
                             f"--dp_size {opt.dp_size} for the fleet decode")
        devices = fleet_devices(opt.dp_size, device)
    model = load_model(opt, device if devices is None else devices[0], overlay=opt.resume2)
    if devices is not None:
        model = replicate_model(model, devices)
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    paths = (sorted(glob.glob(os.path.join(opt.test_path, "*")))
             if os.path.isdir(opt.test_path) else [opt.test_path])
    for path in paths:
        process(opt, model, tokenizer, path, generator, devices=devices)


if __name__ == "__main__":
    main()

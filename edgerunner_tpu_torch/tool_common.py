"""What the port's checkpoint tools share (`spec_stats`, `bench_spec`,
`kv_quant_quality`, `make_manifest`, `visualize_traversal`): the device
flag every entry point of the port takes, the models' dtype (bf16 on the
card, as the JAX scripts cast their weights; f32 on the CPU, the port's
reference precision, in which greedy streams are exact), the JAX scripts'
shape flags and `--tiny` preset, the weights (weights.py: a `.safetensors`
file of the port or in the reference naming, or a workspace directory
holding `model.safetensors`) and the JSON they write."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from edgerunner_tpu_torch.config import config_defaults

# tools/spec_stats.py and tools/kv_quant_quality.py's --tiny: a few seconds
# on the CPU, 12 faces at most
TINY = dict(hidden_dim=64, num_layers=2, num_heads=4, point_hidden_dim=32,
            point_num_heads=4, point_latent_size=16, point_latent_dim=8,
            num_cond_tokens=17, max_seq_length=512, point_num=128, checkpointing=False,
            decode_bucket=128)
TINY_FACES = 12


def add_device_args(ap):
    """--device: the card unless `cpu` is asked for; without a card it
    raises."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")


def tool_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def add_shape_args(ap, override_help: str):
    """The JAX scripts' model-shape flags (0 keeps the ArAE preset)."""
    ap.add_argument("--hidden_dim", type=int, default=0, help=override_help)
    ap.add_argument("--num_layers", type=int, default=12)
    ap.add_argument("--num_heads", type=int, default=12)
    ap.add_argument("--max_seq_length", type=int, default=4096)


def tool_options(args, **changes):
    """The ArAE preset with `changes`, the shape flags when --hidden_dim is
    set and --tiny's preset when the tool has one and it is given (which
    also cuts --faces to 12), as the JAX scripts build theirs."""
    opt = dataclasses.replace(config_defaults["ArAE"], **changes)
    if args.hidden_dim:
        opt = dataclasses.replace(opt, hidden_dim=args.hidden_dim,
                                  num_layers=args.num_layers, num_heads=args.num_heads,
                                  max_seq_length=args.max_seq_length)
    if getattr(args, "tiny", False):
        opt = dataclasses.replace(opt, **TINY)
        args.faces = min(args.faces, TINY_FACES)
    return opt


def load_tool_model(opt, device: torch.device, resume: Optional[str]):
    """The LMM of `opt` on `device` in its `tool_dtype`: drawn from
    `opt.seed`, the weights `resume` merged over them as the JAX scripts'
    `tolerant_merge` does, then under `opt.w_quant` its decoder projections
    quantised (weights.py `load_for_inference`)."""
    from edgerunner_tpu_torch.infer import load_model
    from edgerunner_tpu_torch.merge_lora import weights_path

    path = weights_path(resume) if resume else None
    return load_model(dataclasses.replace(opt, resume=path), device, dtype=tool_dtype(device))


def write_result(result: dict, out: Optional[str]):
    """Print the result as the JAX scripts do and write it to `out`."""
    print(json.dumps(result, indent=1))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {out}")


def sync(device: torch.device):
    """Wait for the card's queued work (a timed call's end)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)

"""Quantised decoding against the exact bf16 configuration (the port of
tools/kv_quant_quality.py).

    python -m edgerunner_tpu_torch.kv_quant_quality --resume WEIGHTS \\
        [--mode kv|w|both] [--kv_bits 8|4] [--kv_group N] [--kv_rotate] \\
        [--batch 8] [--faces 500] [--out quality.json] \\
        [--device cuda|cpu]
    python -m edgerunner_tpu_torch.kv_quant_quality --random --tiny --device cpu

Greedy streams of the same random point conditions, decoded twice: exact
(bf16 on the card, f32 on the CPU, the KV cache in that dtype) and
quantised (`--mode kv`: the int8 cache, or int4 with `--kv_bits 4`,
per-row or `--kv_group` scales, `--kv_rotate` rows; `--mode w`: int8
decoder weights; `--mode both`). Per row up to the later of the two EOS: the position-wise match
rate, the length of the matching prefix, whether the streams are
identical, and both meshes' face counts. Greedy decoding leaves no
sampling noise in the comparison. `--resume` takes a `.safetensors` file
or a workspace directory holding `model.safetensors`, `--random` the
weights drawn from the seed; the JSON keys are the JAX script's
(`backend`: "gpu" on the card, "cpu" on the CPU, as JAX names them).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np

from edgerunner_tpu_torch.data.tokenize import detokenize_mesh
from edgerunner_tpu_torch.generate import generate_tokens
from edgerunner_tpu_torch.infer import resolve_device
from edgerunner_tpu_torch.tool_common import (
    add_device_args,
    add_shape_args,
    load_tool_model,
    tool_options,
    write_result,
)
from edgerunner_tpu_torch.utils import get_tokenizer


def parser(prog: str = "python -m edgerunner_tpu_torch.kv_quant_quality"
           ) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description=__doc__.splitlines()[0])
    ap.add_argument("--resume", type=str, default=None, help="weights file or directory")
    ap.add_argument("--random", action="store_true", help="random-init weights")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--faces", type=int, default=500)
    ap.add_argument("--mode", choices=("kv", "w", "both"), default="kv")
    ap.add_argument("--kv_bits", type=int, default=8, choices=(4, 8))
    ap.add_argument("--kv_group", type=int, default=0,
                    help="int4 scale group size in lanes (0 = per-row)")
    ap.add_argument("--kv_rotate", action="store_true",
                    help="QuaRot-style per-head rotation before quantization")
    add_shape_args(ap, "override model shape (0 = ArAE preset); set all four shape flags "
                       "together so the checkpoint's position table loads without "
                       "realignment")
    ap.add_argument("--out", type=str, default=None)
    add_device_args(ap)
    return ap


def compare_rows(a: np.ndarray, b: np.ndarray, eos_id: int, bins: int, tokenizer) -> list:
    """Per row of the exact streams `a` and the quantised `b` (cut to one
    length): agreement up to the later of the two EOS, and face counts."""
    L = min(a.shape[1], b.shape[1])
    a, b = a[:, :L], b[:, :L]
    rows = []
    for ra, rb in zip(a, b):
        ends = [np.nonzero(r == eos_id)[0] for r in (ra, rb)]
        end = max((e[0] + 1) if len(e) else L for e in ends)
        match = float((ra[:end] == rb[:end]).mean())
        div = np.nonzero(ra[:end] != rb[:end])[0]
        prefix = int(div[0]) if len(div) else int(end)
        fa = detokenize_mesh(ra[ra >= 3], bins, tokenizer=tokenizer)[1]
        fb = detokenize_mesh(rb[rb >= 3], bins, tokenizer=tokenizer)[1]
        rows.append({"len": int(end), "match_rate": round(match, 4),
                     "prefix_match": prefix, "identical": bool(match == 1.0),
                     "faces_exact": int(len(fa)), "faces_quant": int(len(fb))})
    return rows


def main(argv: Optional[List[str]] = None) -> dict:
    args = parser().parse_args(argv)
    if not (args.resume or args.random):
        raise SystemExit("--resume WEIGHTS or --random is required")
    device = resolve_device(args.device)
    opt = tool_options(args, generate_mode="greedy")
    tokenizer, _ = get_tokenizer(opt)
    conds = np.random.default_rng(0).normal(
        size=(args.batch, opt.point_num, 3)).astype(np.float32)

    streams = {}
    for quant in (False, True):
        kv = quant and args.mode in ("kv", "both")
        wq = quant and args.mode in ("w", "both")
        o = dataclasses.replace(opt, kv_quant=kv, w_quant=wq, kv_bits=args.kv_bits,
                                kv_group=args.kv_group, kv_rotate=args.kv_rotate and kv)
        model = load_tool_model(o, device, args.resume)
        streams[quant] = generate_tokens(model, conds, num_faces=args.faces)
        del model

    rows = compare_rows(streams[False], streams[True], opt.eos_token_id, opt.discrete_bins,
                        tokenizer)
    result = {
        "weights": args.resume or "random-init",
        "mode": args.mode,
        "kv_bits": args.kv_bits,
        "kv_rotate": bool(args.kv_rotate),
        "batch": args.batch,
        "faces_requested": args.faces,
        "backend": "gpu" if device.type == "cuda" else device.type,
        "mean_match_rate": round(float(np.mean([r["match_rate"] for r in rows])), 4),
        "identical_streams": sum(r["identical"] for r in rows),
        "rows": rows,
    }
    write_result(result, args.out)
    return result


if __name__ == "__main__":
    main()

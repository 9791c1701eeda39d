"""Draft-head acceptance of a checkpoint by teacher forcing (the port of
tools/spec_stats.py).

    python -m edgerunner_tpu_torch.spec_stats --resume WEIGHTS --mtp_heads 3 \\
        [--batch 4] [--faces 300] [--cond random|synthetic] [--out stats.json] \\
        [--device cuda|cpu]

Greedy streams come from vanilla decoding (generate.py `generate_tokens`),
then one teacher-forced pass over condition + BOS + stream gives each draft
head's argmax at every position: head k at the hidden state of stream
token j predicts token j + 2 + k. Its match rate m_k counts the positions
before each row's EOS; proposal k + 1 is accepted only when heads 1..k all
match, so a verify pass yields about 1 + m_1 + m_1 m_2 + ... tokens
(`expected_tokens_per_pass`), the speed-up's upper bound. `--resume` takes
a `.safetensors` file (the port's saves, or the reference naming) or a
workspace directory holding `model.safetensors`; the model runs in bf16
on the card, in f32 on the CPU; the JSON keys are the JAX script's.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from edgerunner_tpu_torch.generate import generate_tokens
from edgerunner_tpu_torch.infer import resolve_device
from edgerunner_tpu_torch.tool_common import (
    add_device_args,
    add_shape_args,
    load_tool_model,
    tool_options,
    write_result,
)

EOS_ID, BOS_ID = 2, 1


def parser(prog: str = "python -m edgerunner_tpu_torch.spec_stats") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description=__doc__.splitlines()[0])
    ap.add_argument("--resume", required=True)
    ap.add_argument("--mtp_heads", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--faces", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    add_shape_args(ap, "override model shape (0 = ArAE preset); set all four shape flags "
                       "together")
    ap.add_argument("--synthetic_subdiv", type=int, default=2,
                    help="icosphere subdiv cap for the held-out test split")
    ap.add_argument("--min_faces", type=int, default=0,
                    help="pick only test meshes with at least this many faces")
    ap.add_argument("--cond", choices=("random", "synthetic"), default="random",
                    help="conditioning point clouds: random normals (OOD) or surface "
                         "samples from the synthetic dataset (in-distribution for a "
                         "synthetic checkpoint)")
    ap.add_argument("--out", type=str, default=None)
    add_device_args(ap)
    return ap


@torch.no_grad()
def heads_on_stream(model, conds, tokens: np.ndarray, faces: int) -> List[np.ndarray]:
    """Each draft head's argmax [B, C + 1 + M] over condition + BOS +
    `tokens` [B, M], teacher-forced in one pass of the decoder."""
    dev = next(model.parameters()).device
    B = tokens.shape[0]
    nf = torch.full((B,), faces, dtype=torch.int64, device=dev)
    cond_embeds, _ = model.encode_cond(torch.as_tensor(conds, device=dev), nf)
    ids = torch.cat([torch.full((B, 1), BOS_ID, dtype=torch.int64, device=dev),
                     torch.as_tensor(tokens, dtype=torch.int64, device=dev)], 1)
    embeds = model.mesh_decoder.embed_tokens(ids)
    if cond_embeds is not None:
        embeds = torch.cat([cond_embeds.to(embeds.dtype), embeds], 1)
    h, _ = model.mesh_decoder.model(embeds)
    return [lg.argmax(-1).cpu().numpy() for lg in model.mesh_decoder.mtp_logits(h)]


def row_ends(streams: np.ndarray) -> List[int]:
    """Each row's length up to and with its EOS (the whole row without)."""
    ends = []
    for row in streams:
        eos = np.nonzero(row == EOS_ID)[0]
        ends.append(int(eos[0]) + 1 if len(eos) else len(row))
    return ends


def head_match_rates(preds: List[np.ndarray], streams: np.ndarray, C: int) -> tuple:
    """(match rate per head, rows of the JSON): head k at hidden position
    C + 1 + j against stream token j + 2 + k, over each row's positions
    before its EOS (the JAX script's loop)."""
    rows, rates = [], []
    for k, pk in enumerate(preds):
        hits, total = 0, 0
        for b, end in enumerate(row_ends(streams)):
            for j in range(0, end - 2 - k):
                total += 1
                hits += int(pk[b, C + 1 + j] == streams[b, j + 2 + k])
        rates.append(hits / max(total, 1))
        rows.append({"head": k, "match_rate": round(rates[-1], 4), "n": total})
    return rates, rows


def expected_tokens_per_pass(rates: List[float]) -> float:
    exp_tokens, acc = 1.0, 1.0
    for m in rates:
        acc *= m
        exp_tokens += acc
    return exp_tokens


def main(argv: Optional[List[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    opt = tool_options(args, generate_mode="greedy", mtp_heads=args.mtp_heads,
                       synthetic_subdiv=args.synthetic_subdiv)
    model = load_tool_model(opt, device, args.resume)
    if args.cond == "synthetic":
        from edgerunner_tpu_torch.bench_spec import pick_test_conds

        conds = pick_test_conds(opt, args.batch, args.min_faces)
    else:
        conds = np.random.default_rng(0).normal(
            size=(args.batch, opt.point_num, 3)).astype(np.float32)
    streams = generate_tokens(model, conds, num_faces=args.faces)
    B, M = streams.shape
    # the counts read no position past a row's EOS, and no earlier position
    # attends to one: the pass stops at the longest row's
    preds = heads_on_stream(model, conds, streams[:, :max(row_ends(streams))], args.faces)
    rates, rows = head_match_rates(preds, streams, opt.num_cond_tokens)
    result = {
        "weights": args.resume,
        "mtp_heads": args.mtp_heads,
        "cond": args.cond,
        "batch": B,
        "stream_len": int(M),
        "head_match_rates": [round(r, 4) for r in rates],
        "expected_tokens_per_pass": round(expected_tokens_per_pass(rates), 3),
        "rows": rows,
    }
    write_result(result, args.out)
    return result


if __name__ == "__main__":
    main()

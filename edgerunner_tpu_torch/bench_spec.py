"""Speculative decoding against vanilla greedy decoding on a checkpoint, in
wall-clock time (the port of tools/bench_spec.py).

    python -m edgerunner_tpu_torch.bench_spec --resume WEIGHTS --mtp_heads 3 \\
        [--batch 8] [--faces 300] [--repeats 2] [--hidden_dim 768 --num_layers 12 \\
        --num_heads 12 --max_seq_length 4096] [--out bench.json] \\
        [--device cuda|cpu]

The companion of `spec_stats` (acceptance by teacher forcing): the same
conditions decoded with `--spec_decode` off and on, one warm-up call and
`--repeats` timed calls each (every timed call ends with the card
synchronised), meshes/min of each, the speed-up, and whether the streams
agree (where they do not, the first divergence per row: bf16 verify
passes sum in another order than single steps, so near-ties may flip).
Conditions are surface points of the synthetic set's pinned held-out split
((0, 0, idx) seeds, which no training run with a seed other than 0 draws;
`pick_test_conds`) or random normals (`--cond random`). The model runs in
bf16 on the card, in f32 on the CPU. The JSON keys are the JAX script's,
and one more: `tokens_per_pass`, the tokens that the spec warm-up call's
verify passes accepted on average over the rows that took any (what the
wall-clock speed-up is made of).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from edgerunner_tpu_torch import generate as TG
from edgerunner_tpu_torch.generate import generate_tokens, round_up_bucket
from edgerunner_tpu_torch.infer import resolve_device
from edgerunner_tpu_torch.tool_common import (
    add_device_args,
    add_shape_args,
    load_tool_model,
    sync,
    tool_options,
    write_result,
)


def pick_test_conds(opt, batch: int, min_faces: int = 0) -> np.ndarray:
    """Point conditions of `batch` meshes from the pinned held-out test split
    ((0, 0, idx) seeds, disjoint from any training run with a seed other
    than 0), keeping only meshes with at least `min_faces` faces when asked
    (from a pool of 384)."""
    from edgerunner_tpu_torch.data.dataset import SyntheticMeshDataset

    pool = 384 if min_faces else batch
    ds = SyntheticMeshDataset(opt, size=pool, training=False)
    conds, faces = [], []
    for i in range(pool):
        s = ds[i]
        if s["num_faces"] >= min_faces:
            conds.append(s["cond"])
            faces.append(int(s["num_faces"]))
        if len(conds) == batch:
            break
    assert len(conds) == batch, (
        f"only {len(conds)}/{batch} test meshes with >= {min_faces} faces in a "
        f"{pool}-mesh pool: lower --min_faces or raise --synthetic_subdiv")
    print(f"[cond] {batch} held-out meshes, faces={faces}")
    return np.stack(conds).astype(np.float32)


def parser(prog: str = "python -m edgerunner_tpu_torch.bench_spec") -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description=__doc__.splitlines()[0])
    ap.add_argument("--resume", required=True)
    ap.add_argument("--mtp_heads", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--faces", type=int, default=300)
    ap.add_argument("--repeats", type=int, default=2)
    add_shape_args(ap, "override model shape (0 = ArAE preset); set all four shape flags "
                       "together")
    ap.add_argument("--cond", choices=("random", "synthetic"), default="synthetic")
    ap.add_argument("--synthetic_subdiv", type=int, default=2,
                    help="icosphere subdiv cap for the held-out test split (3 admits "
                         "~1280-face meshes: the long-cache operating point where the "
                         "verify pass amortizes)")
    ap.add_argument("--min_faces", type=int, default=0,
                    help="pick only test meshes with at least this many faces (scans a "
                         "384-mesh pool of the pinned split)")
    ap.add_argument("--out", type=str, default=None)
    add_device_args(ap)
    return ap


def accepted_per_pass(seen: list) -> Optional[float]:
    """Mean tokens a verify pass accepted, over the rows that took any."""
    if not seen:
        return None
    a = torch.cat([x[x > 0] for x in seen]).float()
    return float(a.mean()) if a.numel() else None


def run(argv: Optional[List[str]] = None) -> tuple:
    """(the JSON result, {mode: streams [B, T]})."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    base = tool_options(args, generate_mode="greedy", mtp_heads=args.mtp_heads,
                        synthetic_subdiv=args.synthetic_subdiv)
    if args.cond == "synthetic":
        conds = pick_test_conds(base, args.batch, args.min_faces)
    else:
        conds = np.random.default_rng(0).normal(
            size=(args.batch, base.point_num, 3)).astype(np.float32)
    token_budget = round_up_bucket(min(args.faces * 4 + 32, base.max_seq_length),
                                   base.decode_bucket)

    results, streams, passes = {}, {}, []
    for mode in ("vanilla", "spec"):
        opt = dataclasses.replace(base, spec_decode=(mode == "spec"))
        model = load_tool_model(opt, device, args.resume)

        def call():
            out = generate_tokens(model, conds, num_faces=args.faces,
                                  max_new_tokens=token_budget)
            sync(device)
            return out

        # warm-up; the spec run's verify passes recorded (not timed)
        spec_pass = TG.spec_pass

        def recording(*a, **kw):
            out = spec_pass(*a, **kw)
            passes.append(out[1])
            return out

        TG.spec_pass = recording
        try:
            out = call()
        finally:
            TG.spec_pass = spec_pass
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            out = call()
        dt = time.perf_counter() - t0
        meshes = args.batch * args.repeats
        streams[mode] = np.asarray(out)
        results[mode] = {"meshes_per_min": round(meshes / dt * 60.0, 3),
                         "s_per_mesh": round(dt / meshes, 4)}
        del model

    # where the streams differ, the first divergence per row and the
    # pre-divergence match rate tell near-tie flips from verify faults
    a, b = streams["vanilla"], streams["spec"]
    n = min(a.shape[1], b.shape[1])
    identical = bool((a[:, :n] == b[:, :n]).all())
    first_div = []
    for r in range(a.shape[0]):
        d = np.nonzero(a[r, :n] != b[r, :n])[0]
        first_div.append(int(d[0]) if len(d) else -1)
    prefix_match = round(float(np.mean([fd / n if fd >= 0 else 1.0 for fd in first_div])), 4)
    tpp = accepted_per_pass(passes)
    result = {
        "weights": args.resume,
        "mtp_heads": args.mtp_heads,
        "cond": args.cond,
        "batch": args.batch,
        "faces": args.faces,
        "token_budget": token_budget,
        "streams_identical": identical,
        "first_divergence_per_row": first_div,
        "mean_prefix_match": prefix_match,
        "vanilla": results["vanilla"],
        "spec": results["spec"],
        "speedup": round(results["spec"]["meshes_per_min"]
                         / max(results["vanilla"]["meshes_per_min"], 1e-9), 3),
        "tokens_per_pass": None if tpp is None else round(tpp, 4),
    }
    write_result(result, args.out)
    return result, streams


def main(argv: Optional[List[str]] = None) -> dict:
    return run(argv)[0]


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Data parallelism of the PyTorch port over several cards, through its CLIs,
one card per rank or replica (needs 2 or more NVIDIA GPUs; imports nothing of
JAX):

- training: `torchrun --nproc_per_node K -m edgerunner_tpu_torch.main ArAE
  --dp_size K` for K = 1, 2 and 4 (those the cards allow), full width,
  random weights from seed 0, the synthetic set (which is not sharded, so
  every rank and every K takes the same rows in the same order), 2 rows per
  rank (bench.py's train batch), 21 steps; the s/it that main logs over
  steps 11-20 (rank 0, over NCCL when each rank has a card);
- the decode fleet: `python -m edgerunner_tpu_torch.infer ArAE --dp_size 2`
  (a replica on cuda:0 and on cuda:1, 4 rows each) against `--dp_size 1`
  (8 rows on cuda:0), greedy, on the same procedural mesh: the s/mesh that
  infer prints for the second of two face counts (the first warms up), and
  tokens/s from the tokens written; then, as random weights may end a row
  early, `generate_tokens` itself with EOS forbidden, the fleet on cuda:0
  and cuda:1 against one card, the same rows and FLEET_BUDGET tokens each
  (after one warm-up call of each).

    python3 tools/torch_dp_cards.py [--out DIR] [--parts train,infer]

Prints one JSON line with every run's numbers, the card's name and power
limit; each run's log goes to DIR (default workspace_dp_cards/).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = "0"
TRAIN_ROWS = 2          # bench.py's train batch, per rank
TRAIN_STEPS = 21        # main logs the mean s/it of steps 1-10 and 11-20
FLEET_ROWS = 8
FLEET_FACES = ("800", "1000")   # two groups: the first warms up
FLEET_BUDGET = "1024"   # tokens per row: one of the preset's decode buckets


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except OSError:
        return "not measured"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def run(cmd: list, log: str, timeout: int) -> str:
    """Runs `cmd` from the repository's root; its output goes to `log` and
    comes back; raises when it fails."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    with open(log, "w") as f:
        f.write(f"$ {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:6])} ... exited {proc.returncode}; see {log}")
    return proc.stdout + proc.stderr


def train(k: int, tmp: str, out: str) -> dict:
    """main ArAE --dp_size k over k ranks: the s/it lines of rank 0's log."""
    ws = os.path.join(tmp, f"train_dp{k}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(k), "-m", "edgerunner_tpu_torch.main", "ArAE", "--dp_size", str(k),
           "--data_root", os.path.join(tmp, "absent"), "--workspace", ws,
           "--synthetic_size", str(TRAIN_ROWS * TRAIN_STEPS), "--batch_size", str(TRAIN_ROWS),
           "--num_epochs", "1", "--eval_mode", "none", "--save_optimizer_state", "false",
           "--num_workers", "4", "--seed", SEED]
    run(cmd, os.path.join(out, f"train_dp{k}.log"), timeout=900)
    with open(os.path.join(ws, "log.txt")) as f:
        text = f.read()
    steps = {int(i): float(s) for i, s in re.findall(r":(\d+)/\d+ .*?\(([\d.]+)s/it\)", text)}
    backend = re.findall(r"backend (\w+)", text)
    return {"ranks": k, "global_rows": TRAIN_ROWS * k, "backend": backend[0] if backend else None,
            "s_per_it_logged": steps, "s_per_it_steps_11_20": steps.get(20)}


def fleet(k: int, mesh: str, tmp: str, out: str) -> dict:
    """infer --dp_size k on FLEET_ROWS rows: s/mesh of the second face count
    and the tokens it wrote."""
    ws = os.path.join(tmp, f"infer_dp{k}")
    cmd = [sys.executable, "-m", "edgerunner_tpu_torch.infer", "ArAE", "--test_path", mesh,
           "--workspace", ws, "--test_batch_size", str(FLEET_ROWS), "--test_repeat",
           str(FLEET_ROWS), "--test_num_face", *FLEET_FACES, "--test_max_seq_length",
           FLEET_BUDGET, "--generate_mode", "greedy", "--seed", SEED, "--dp_size", str(k)]
    text = run(cmd, os.path.join(out, f"infer_dp{k}.log"), timeout=900)
    last = FLEET_FACES[-1]
    per_mesh = [float(t) for nf, t in re.findall(r"_(\d+)f\.ply .*?time = ([\d.]+)s/mesh", text)
                if nf == last]
    tokens = sum(len(np.load(p)) for p in glob.glob(os.path.join(ws, f"*_{last}f_tokens.npy")))
    group_s = per_mesh[0] * FLEET_ROWS if per_mesh else None
    return {"replicas": k, "rows": FLEET_ROWS, "num_faces": int(last),
            "budget": int(FLEET_BUDGET), "s_per_mesh": per_mesh[0] if per_mesh else None,
            "group_s": group_s, "tokens_written": tokens,
            "tokens_per_s": tokens / group_s if group_s else None}


def fleet_no_eos() -> dict:
    """generate_tokens on FLEET_ROWS rows, EOS forbidden: a fleet of a
    replica on cuda:0 and one on cuda:1 against cuda:0 alone."""
    import torch

    from edgerunner_tpu_torch.config import config_defaults, validate
    from edgerunner_tpu_torch.generate import generate_tokens, replicate_model
    from edgerunner_tpu_torch.infer import load_model

    opt = validate(dataclasses.replace(config_defaults["ArAE"], generate_mode="greedy",
                                       seed=int(SEED)))
    devices = [torch.device("cuda", i) for i in range(2)]
    model = load_model(opt, devices[0])
    reps = replicate_model(model, devices)
    points = np.random.default_rng(int(SEED)).normal(
        size=(FLEET_ROWS, opt.point_num, 3)).astype(np.float32)

    def timed(m, **kw):
        for d in devices:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        out = generate_tokens(m, points, num_faces=int(FLEET_FACES[-1]),
                              max_new_tokens=int(FLEET_BUDGET), bench_no_eos=True, **kw)
        for d in devices:
            torch.cuda.synchronize(d)
        return out, time.perf_counter() - t0

    timed(model)
    timed(reps, devices=devices)
    one, one_s = timed(model)
    fleet_out, fleet_s = timed(reps, devices=devices)
    return {"rows": FLEET_ROWS, "budget": int(FLEET_BUDGET), "tokens": int(one.size),
            "one_card_s": one_s, "one_card_tokens_per_s": one.size / one_s,
            "fleet_2_cards_s": fleet_s, "fleet_2_cards_tokens_per_s": fleet_out.size / fleet_s,
            "fleet_over_one_card": one_s / fleet_s}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "workspace_dp_cards"))
    ap.add_argument("--parts", default="train,infer",
                    help="comma-separated: train (main over NCCL), infer (the fleets)")
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"torch_dp_cards: needs 2 or more cards, and {cards} are present",
              file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, ROOT)
    from edgerunner_tpu_torch.data import save_mesh_file
    from edgerunner_tpu_torch.data._procgen import icosphere

    parts = args.parts.split(",")
    res = {"card": card_line(), "cards": cards, "train": [], "infer": []}
    with tempfile.TemporaryDirectory() as tmp:
        v, f = icosphere(3)
        mesh = os.path.join(tmp, "ellipsoid.obj")
        save_mesh_file(mesh, v * np.array([1.0, 0.6, 0.8]), f)
        for k in (1, 2, 4):
            if "train" in parts and k <= cards:
                res["train"].append(train(k, tmp, args.out))
        for k in (1, 2):
            if "infer" in parts:
                res["infer"].append(fleet(k, mesh, tmp, args.out))
    if "infer" in parts:
        res["fleet_no_eos"] = fleet_no_eos()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

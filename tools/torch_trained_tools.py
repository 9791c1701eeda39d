#!/usr/bin/env python3
"""The PyTorch port's checkpoint tools on weights that the port trains
itself, on one NVIDIA GPU (imports nothing of JAX):

1. trains the JAX record's 111M draft-head checkpoint with the port's
   `main` (`python -m edgerunner_tpu_torch.main ArAE`): 768 x 12 x 12, 3
   draft heads at `--mtp_loss_weight 0.3`, seed 7, on the regenerating
   synthetic set (2048 procedural meshes drawn anew each epoch from (seed,
   epoch, index); no download), 8 rows a step, lr 3e-4 with 10% linear
   warm-up (evidence/warmup_study.md: the post-LN decoder stalls in the
   unigram basin without it), 21 epochs, or as many as `--train_minutes`
   allows (each epoch is saved; the last one saved is measured);
2. runs the port's three quality tools on it, at the record's settings, on
   the synthetic set's pinned held-out split (seeds (0, 0, idx), which a
   seed-7 run never draws) or, for kv_quant_quality, on its random point
   clouds: `spec_stats` and `bench_spec` at 8 rows and 300 faces (draft
   heads' acceptance by teacher forcing; spec against vanilla decoding in
   wall-clock time, EOS allowed), `kv_quant_quality` at 8 rows and 500
   faces with the int8 cache (`--mode kv`) and with the int4 cache and
   int8 weights (`--mode both --kv_bits 4`).

    python3 tools/torch_trained_tools.py [--out DIR] [--workspace WS] \\
        [--epochs 21] [--samples 2048] [--train_minutes 40]

Prints one JSON line: the training's epochs, steps, s/it and final
loss_ce, the tools' figures, tokens/s of each bench_spec mode (the tokens
its rows emitted up to EOS over its time), and the card's name and power
limit. Each tool's JSON and the training log go to DIR (default
workspace_trained/out); the checkpoint stays in WS (default
workspace_trained/ws), which git and the chip copy leave out.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_dp_cards import card_line  # noqa: E402

# the JAX record's 111M model (evidence/spec_decision.md)
SHAPE = ["--hidden_dim", "768", "--num_layers", "12", "--num_heads", "12",
         "--max_seq_length", "4096"]
HEADS = "3"
TRAIN = ["--mtp_heads", HEADS, "--mtp_loss_weight", "0.3", "--seed", "7",
         "--batch_size", "8", "--lr", "3e-4",
         "--warmup_ratio", "0.1", "--checkpointing", "false", "--eval_mode", "none",
         "--save_optimizer_state", "false", "--num_workers", "6"]
ROWS, SPEC_FACES, KV_FACES = "8", "300", "500"
LOG_LINE = re.compile(r"\[INFO\] (\d+):(\d+)/(\d+) .*?\(([\d.]+)s/it\).*? loss_ce: ([\d.]+)")


def train(ws: str, out: str, epochs: int, minutes: float, samples: int) -> dict:
    """`main ArAE` on the card for `epochs` epochs of `samples` meshes,
    stopped after `minutes` (the last epoch saved is kept); what its log.txt
    shows."""
    argv = [sys.executable, "-m", "edgerunner_tpu_torch.main", "ArAE", *SHAPE, *TRAIN,
            "--synthetic_size", str(samples), "--num_epochs", str(epochs),
            "--data_root", os.path.join(ws, "none"),
            "--workspace", ws]
    t0 = time.perf_counter()
    stopped = False
    with open(os.path.join(out, "train_stdout.txt"), "w") as f:
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=minutes * 60)
        except subprocess.TimeoutExpired:
            proc.terminate()
            rc = proc.wait(timeout=120)
            stopped = True
    seconds = time.perf_counter() - t0
    return {"argv": argv[2:], "rc": rc, "stopped_at_time_limit": stopped,
            "seconds": seconds, **read_log(ws)}


def read_log(ws: str) -> dict:
    """Epochs finished, the last epoch saved (main keeps the last two),
    steps logged, the logged s/it and loss_ce of main's log.txt: the last
    logged loss_ce and the mean of each epoch's."""
    saved = sorted(d for d in os.listdir(ws) if re.fullmatch(r"ep\d{4}", d))
    rows, epochs = [], 0
    with open(os.path.join(ws, "log.txt")) as f:
        for line in f:
            m = LOG_LINE.search(line)
            if m:
                rows.append((int(m[1]), int(m[2]), int(m[3]), float(m[4]), float(m[5])))
            epochs += "] Train epoch: " in line
    last = [r for r in rows if r[0] == rows[-1][0]] if rows else []
    return {"epochs_reached": epochs, "last_saved": saved[-1] if saved else None,
            "steps_per_epoch": rows[-1][2] if rows else None,
            "s_per_it_logged": [r[3] for r in rows[1:]][-20:],
            "loss_ce_logged_first": rows[0][4] if rows else None,
            "loss_ce_final": rows[-1][4] if rows else None,
            "loss_ce_last_epoch_mean": float(np.mean([r[4] for r in last])) if last else None,
            "loss_ce_by_epoch": [float(np.mean([r[4] for r in rows if r[0] == e]))
                                 for e in sorted({r[0] for r in rows})]}


def emitted(streams: np.ndarray) -> int:
    """Tokens the rows emitted, EOS included."""
    total = 0
    for row in streams:
        end = np.nonzero(row == 2)[0]
        total += int(end[0]) + 1 if len(end) else len(row)
    return total


def measure(ws: str, out: str) -> dict:
    """The three quality tools on the checkpoint in `ws`, in this process."""
    import torch

    from edgerunner_tpu_torch import bench_spec, kv_quant_quality, spec_stats

    res = {}

    def tool(name, fn, argv):
        t0 = time.perf_counter()
        got = fn([*argv, "--out", os.path.join(out, f"{name}.json")])
        gc.collect()
        torch.cuda.empty_cache()
        res[name + "_s"] = time.perf_counter() - t0
        return got

    spec = ["--resume", ws, "--mtp_heads", HEADS, "--batch", ROWS, "--faces", SPEC_FACES,
            *SHAPE]
    res["spec_stats"] = tool("spec_stats", spec_stats.main, [*spec, "--cond", "synthetic"])
    bench, streams = tool("bench_spec", bench_spec.run, spec)
    res["bench_spec"] = bench
    rows = int(ROWS)
    res["tokens_per_s"] = {mode: emitted(streams[mode]) / (bench[mode]["s_per_mesh"] * rows)
                           for mode in ("vanilla", "spec")}
    res["tokens_per_row"] = {mode: emitted(streams[mode]) / rows for mode in streams}
    kv = ["--resume", ws, "--batch", ROWS, "--faces", KV_FACES, *SHAPE]
    for name, more in (("kv8", ["--mode", "kv"]),
                       ("kv4_w", ["--mode", "both", "--kv_bits", "4"])):
        res[name] = tool(name, kv_quant_quality.main, [*kv, *more])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "workspace_trained", "out"))
    ap.add_argument("--workspace", default=os.path.join(ROOT, "workspace_trained", "ws"))
    ap.add_argument("--epochs", type=int, default=21)
    ap.add_argument("--samples", type=int, default=2048,
                    help="synthetic meshes per epoch (the record's 2048)")
    ap.add_argument("--train_minutes", type=float, default=40.0,
                    help="stop training after this long; the last epoch saved is measured")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.workspace, exist_ok=True)
    card = card_line()
    result = {"card": card}
    result["train"] = train(args.workspace, args.out, args.epochs, args.train_minutes,
                            args.samples)
    if result["train"]["last_saved"] is None:
        print(json.dumps(result), flush=True)
        print("torch_trained_tools: no epoch was saved", file=sys.stderr)
        return 1
    result.update(measure(args.workspace, args.out))
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

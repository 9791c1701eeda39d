#!/usr/bin/env python3
"""Data and model parallelism of the PyTorch port over several cards, through
its CLIs, one card per rank or replica (needs 2 or more NVIDIA GPUs; imports
nothing of JAX):

- train: `torchrun --nproc_per_node K -m edgerunner_tpu_torch.main ArAE
  --dp_size K` for K = 1, 2 and 4 (those the cards allow), full width,
  random weights from seed 0, the synthetic set (which is not sharded, so
  every rank and every K takes the same rows in the same order), 2 rows per
  rank (bench.py's train batch), 21 steps; the s/it that main logs over
  steps 11-20 (rank 0, over NCCL when each rank has a card);
- infer: the decode fleet, `python -m edgerunner_tpu_torch.infer ArAE
  --dp_size 2` (a replica on cuda:0 and on cuda:1, 4 rows each) against
  `--dp_size 1` (8 rows on cuda:0), greedy, on the same procedural mesh:
  the s/mesh that infer prints for the second of two face counts (the first
  warms up), and tokens/s from the tokens written; then, as random weights
  may end a row early, `generate_tokens` itself with EOS forbidden, the
  fleet on cuda:0 and cuda:1 against one card, the same rows and
  FLEET_BUDGET tokens each (after one warm-up call of each);
- layouts: `torchrun --standalone --nproc_per_node K -m
  edgerunner_tpu_torch.main ArAE <layout>` (and `main_dit DiT --tp_size 2`)
  for every model-parallel layout of LAYOUTS whose ranks the cards hold, a
  card per rank: full width and depth, bf16 autocast, checkpointing, the
  synthetic set, ROWS rows per dp group collated to bench.py's 6147
  positions (`--collate_bucket 4096`), 21 steps, no eval, the weights saved
  at the end. Each rank runs `main.main` as `-m` runs it, through this
  script's `rank` mode, which joins the world first and reads every
  training step with chip_smoke.py's `counted_train_steps` (its seconds,
  kernel A's, C's and row 5's launches, the bytes each kind of collective
  moved, under the keys the gloo phases report), and after the run the
  rank's peak memory and a checksum of the weights that no axis splits.
  Per layout: the backend, rank 0's logged s/it over steps 11-20 and each
  rank's own (over 11-20, and over 15-20, which main does not trace), the
  bytes per step and rank, the launches per step and rank against
  chip_smoke.py's `step_launches`, the checksums equal on every rank, and
  the saved file loaded with strict=True into `infer`'s model on one card,
  which decodes DECODE_TOKENS tokens from it with EOS forbidden (the DiT's
  file strictly into a fresh MDiT, then a 2-step DDIM run);
- nodes: `main ArAE --dp_size 2 --tp_size 2` from two torchrun agents on
  one machine of 4 cards acting as two nodes (`--nnodes 2 --node_rank
  {0,1} --nproc_per_node 2 --rdzv_backend c10d --rdzv_endpoint
  localhost:<port>`, CUDA_VISIBLE_DEVICES 0,1 and 2,3), read as a layout;
  beside each rank's backend, the one that the rule before the per-machine
  count would take (the world against one node's cards).

    python3 tools/torch_dp_cards.py [--out DIR] [--parts train,infer,layouts,nodes]
        [--layouts sp2,tp2,...]

Prints one JSON line: the card's name and power limit, the link between
the cards (`nvidia-smi topo -m`, else `nvidia-smi nvlink --status`; and a
timed copy from card 0 to card 1), every run's numbers; each run's log and
its ranks' files go to DIR (default workspace_dp_cards/). Exits non-zero
when a run fails or a check does not hold.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = "0"
TRAIN_ROWS = 2          # bench.py's train batch, per rank
TRAIN_STEPS = 21        # main logs the mean s/it of steps 1-10 and 11-20
FLEET_ROWS = 8
FLEET_FACES = ("800", "1000")   # two groups: the first warms up
FLEET_BUDGET = "1024"   # tokens per row: one of the preset's decode buckets
COLLATE_BUCKET = "4096"  # each row BOS + 4096 mesh tokens + EOS after 2049 condition tokens
DECODE_TOKENS = 64      # the saved file's decode check, EOS forbidden
DDIM_CHECK_STEPS = 2    # the DiT's saved file: a short DDIM run
RUN_TIMEOUT = 420       # seconds for one torchrun of a layout
MOE = ["--moe_experts", "4", "--moe_top_k", "2"]

# name: (entry, ranks, flags, rows per dp group). pp 4 takes 4 microbatches
# of one row, as pp 2 takes 2.
LAYOUTS = {
    "sp2": ("main", 2, ["--sp_size", "2"], TRAIN_ROWS),
    "sp4": ("main", 4, ["--sp_size", "4"], TRAIN_ROWS),
    "tp2": ("main", 2, ["--tp_size", "2"], TRAIN_ROWS),
    "tp4": ("main", 4, ["--tp_size", "4"], TRAIN_ROWS),
    "pp2": ("main", 2, ["--pp_size", "2", "--pp_microbatches", "2"], TRAIN_ROWS),
    "pp4": ("main", 4, ["--pp_size", "4", "--pp_microbatches", "4"], 4),
    "ep2": ("main", 2, [*MOE, "--ep_size", "2"], TRAIN_ROWS),
    "moe_sp2": ("main", 2, [*MOE, "--sp_size", "2"], TRAIN_ROWS),
    "moe_dp2_pp2": ("main", 4, [*MOE, "--dp_size", "2", "--pp_size", "2",
                                "--pp_microbatches", "2"], TRAIN_ROWS),
    "dp2_sp2": ("main", 4, ["--dp_size", "2", "--sp_size", "2"], TRAIN_ROWS),
    "dp2_tp2": ("main", 4, ["--dp_size", "2", "--tp_size", "2"], TRAIN_ROWS),
    "pp2_tp2": ("main", 4, ["--pp_size", "2", "--tp_size", "2"], TRAIN_ROWS),
    "dit_tp2": ("main_dit", 2, ["--tp_size", "2"], 8),
    "dp2_pp2_tp2": ("main", 8, ["--dp_size", "2", "--pp_size", "2", "--tp_size", "2"],
                    TRAIN_ROWS),
}
NODES = ("main", 4, ["--dp_size", "2", "--tp_size", "2"], TRAIN_ROWS)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not measured"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def link_between_cards(out_dir: str) -> dict:
    """The link between the cards: from `nvidia-smi topo -m` (NVn: NVLink,
    any of PIX/PXB/PHB/NODE/SYS: PCIe), else from `nvidia-smi nvlink
    --status` (every card with active links: NVLink); beside it the copy
    rate from card 0 to card 1 (`copy_rate`). Both outputs kept in
    out_dir."""
    texts = {}
    for name, cmd in (("topo", ["topo", "-m"]), ("nvlink", ["nvlink", "--status"])):
        try:
            proc = subprocess.run(["nvidia-smi", *cmd], capture_output=True, text=True,
                                  timeout=60)
            texts[name] = re.sub(r"\x1b\[[0-9;]*m", "", proc.stdout + proc.stderr)
        except (OSError, subprocess.TimeoutExpired) as exc:
            texts[name] = repr(exc)
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write(texts[name])
    cells = sorted(set(topo_cells(texts["topo"])))
    link, source = link_kind(texts["topo"]), "nvidia-smi topo -m"
    if link == "not measured":
        link, source = nvlink_kind(texts["nvlink"]), "nvidia-smi nvlink --status"
    return {"link": link, "link_source": source, "cells": cells, **copy_rate()}


def nvlink_kind(text: str) -> str:
    """'NVLink' when every card that `nvidia-smi nvlink --status` lists has
    an active link (a rate in GB/s), else 'not measured'."""
    cards = re.split(r"^GPU \d+:", text, flags=re.M)[1:]
    if cards and all(re.search(r"Link \d+: [\d.]+ GB/s", c) for c in cards):
        return "NVLink"
    return "not measured"


def copy_rate(nbytes: int = 1 << 30, reps: int = 5) -> dict:
    """GB/s of a copy of `nbytes` from cuda:0 to cuda:1 (the median of
    `reps` timed with CUDA events, after one warm-up), and whether the
    cards reach each other's memory directly (peer access)."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda:0")
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda:1")
    times = []
    for i in range(reps + 1):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(1)
        start.record(torch.cuda.current_stream(0))
        dst.copy_(src)
        stop.record(torch.cuda.current_stream(0))
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
        if i:
            times.append(start.elapsed_time(stop) / 1e3)
    del src, dst
    torch.cuda.empty_cache()
    return {"peer_access": torch.cuda.can_device_access_peer(0, 1),
            "copy_0_to_1_gb_per_s": nbytes / float(np.median(times)) / 1e9}


def topo_cells(text: str) -> list:
    """The GPU-to-GPU cells of `nvidia-smi topo -m`'s matrix."""
    rows = [ln.split() for ln in text.splitlines() if ln.strip()]
    head = next((r for r in rows if r[0] == "GPU0"), [])
    n = sum(1 for h in head if re.fullmatch(r"GPU\d+", h))
    cells = []
    for r in rows[rows.index(head) + 1:] if head else []:
        if re.fullmatch(r"GPU\d+", r[0]) and len(r) > n:
            i = int(r[0][3:])
            cells += [r[1 + j] for j in range(n) if j != i]
    return cells


def link_kind(text: str) -> str:
    cells = topo_cells(text)
    if not cells:
        return "not measured"
    if all(c.startswith("NV") for c in cells):
        return "NVLink"
    if all(c in ("PIX", "PXB", "PHB", "NODE", "SYS") for c in cells):
        return "PCIe"
    return "mixed: " + ",".join(sorted(set(cells)))


def run(cmd: list, log: str, timeout: int, env: dict = None) -> str:
    """Runs `cmd` from the repository's root in a session of its own; its
    output goes to `log` and comes back; raises when it fails or outlasts
    `timeout`, when every process it started is killed."""
    proc = start(cmd, log, env)
    return finish(proc, cmd, log, timeout)


def start(cmd: list, log: str, env: dict = None) -> subprocess.Popen:
    env = dict(os.environ if env is None else env, PYTHONPATH=ROOT)
    f = open(log, "w")
    f.write(f"$ {' '.join(cmd)}\n")
    f.flush()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    proc.log_file = f
    return proc


def finish(proc: subprocess.Popen, cmd: list, log: str, timeout: float) -> str:
    try:
        proc.wait(timeout=max(timeout, 1))
    except subprocess.TimeoutExpired:
        kill(proc)
        raise RuntimeError(f"{' '.join(cmd[:8])} ... outlasted {timeout:.0f} s; see {log}")
    finally:
        proc.log_file.close()
    with open(log) as f:
        text = f.read()
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:8])} ... exited {proc.returncode}; see {log}")
    return text


def kill(proc: subprocess.Popen) -> None:
    """Every process of `proc`'s session."""
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def s_per_it_logged(log_txt: str) -> dict:
    """{step: s/it} of main's log lines (the mean of the 10 steps before)."""
    return {int(i): float(s) for i, s in re.findall(r":(\d+)/\d+ .*?\(([\d.]+)s/it\)", log_txt)}


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
    steps = s_per_it_logged(text)
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


# ---------------------------------------------------------------- layouts --

def main_argv(entry: str, flags: list, rows: int, ws: str, data_root: str) -> list:
    """The CLI's arguments for a layout run: the preset's width and depth."""
    argv = ["DiT"] if entry == "main_dit" else ["ArAE", "--collate_bucket", COLLATE_BUCKET]
    return [*argv, *flags, "--data_root", data_root, "--workspace", ws,
            "--synthetic_size", str(rows * TRAIN_STEPS), "--batch_size", str(rows),
            "--num_epochs", "1", "--eval_mode", "none", "--save_optimizer_state", "false",
            "--num_workers", "4", "--seed", SEED]


def safetensors_header(path: str) -> dict:
    """{name: shape} from a .safetensors file's header alone."""
    import struct

    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return {k: v["shape"] for k, v in header.items() if k != "__metadata__"}


def decode_check(entry: str, flags: list, path: str) -> dict:
    """The saved file on one card: loaded with strict=True into `infer`'s
    model (the seed's LMM, in bf16 on the card), which decodes
    DECODE_TOKENS greedy tokens for one point cloud with EOS forbidden; the
    DiT's into a fresh MDiT, then a DDIM_CHECK_STEPS-step DDIM run from a
    random image."""
    import gc

    import torch

    from edgerunner_tpu_torch.config import parse_cli, validate
    from edgerunner_tpu_torch.weights import load_state, read_safetensors

    dev = torch.device("cuda", 0)
    moe = MOE if "--moe_experts" in flags else []
    t0 = time.perf_counter()
    rng = np.random.default_rng(int(SEED))
    if entry == "main_dit":
        from edgerunner_tpu_torch.models.mdit import MDiT, run_mdit
        from edgerunner_tpu_torch.weights import load_mdit

        opt = validate(parse_cli(["DiT", "--seed", SEED]))
        model = load_mdit(MDiT(opt, device=dev), dataclasses.replace(opt, resume2=path))
        image = rng.uniform(size=(1, opt.clip_image_size, opt.clip_image_size, 3))
        with torch.inference_mode():
            lat = run_mdit(model, image.astype(np.float32), num_inference_steps=DDIM_CHECK_STEPS,
                           generator=torch.Generator(device=dev).manual_seed(int(SEED))).float()
        res = {"strict_load": True, "ddim_steps": DDIM_CHECK_STEPS,
               "latents_shape": list(lat.shape), "latents_finite": bool(torch.isfinite(lat).all())}
        res["ok"] = res["latents_finite"] and res["latents_shape"] == [
            1, opt.point_latent_size, opt.point_latent_dim]
    else:
        from edgerunner_tpu_torch.generate import generate_tokens
        from edgerunner_tpu_torch.infer import load_model

        # a decode bucket of DECODE_TOKENS, so that the budget is that many
        opt = validate(parse_cli(["ArAE", *moe, "--decode_bucket", str(DECODE_TOKENS),
                                  "--generate_mode", "greedy", "--seed", SEED]))
        model = load_model(opt, dev, dtype=torch.bfloat16)
        load_state(model, read_safetensors(path))  # strict=True
        points = rng.normal(size=(1, opt.point_num, 3)).astype(np.float32)
        tokens = generate_tokens(model, points, num_faces=1000, max_new_tokens=DECODE_TOKENS,
                                 bench_no_eos=True)
        res = {"strict_load": True, "tokens_shape": list(tokens.shape),
               "tokens_head": tokens[0, :8].tolist()}
        res["ok"] = res["tokens_shape"] == [1, DECODE_TOKENS] and bool((tokens >= 0).all())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    return res


def rank_files(rank_dir: str, k: int) -> list:
    ranks = []
    for r in range(k):
        with open(os.path.join(rank_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def read_layout(name: str, spec: tuple, ws: str, rank_dir: str, log: str) -> dict:
    """One layout run's numbers and checks from rank 0's log, the ranks'
    files and the saved weights."""
    entry, k, flags, rows = spec
    with open(os.path.join(ws, "log.txt")) as f:
        text = f.read()
    logged = s_per_it_logged(text)
    ranks = rank_files(rank_dir, k)
    L = ranks[0]["layers"]

    def mean_s(first: int, last: int) -> list:
        """Each rank's mean step seconds over steps first..last."""
        return [float(np.mean([st["s"] for st in rk["steps"][first:last + 1]]))
                if len(rk["steps"]) > last else None for rk in ranks]

    res = {"name": name, "entry": entry, "ranks": k, "flags": flags, "rows_per_dp_group": rows,
           "log": os.path.basename(log), "layers": L, "hidden": ranks[0]["hidden"],
           "backend": sorted({rk["backend"] for rk in ranks}),
           "describe": ranks[0]["describe"], "steps": len(ranks[0]["steps"]),
           "rows_positions_per_step": ranks[0]["steps"][-1]["rows_positions"],
           "s_per_it_logged": logged, "s_per_it_steps_11_20": logged.get(20),
           "s_per_it_steps_11_20_per_rank": mean_s(11, 20),
           # main traces steps 10-14 (trainer.PROFILE_STEPS): 15-20 run untraced
           "s_per_it_steps_15_20_per_rank": mean_s(15, 20),
           "peak_mem_gib_per_rank": [rk["peak_mem_gib"] for rk in ranks],
           "param_gib_per_rank": [rk["param_gib"] for rk in ranks],
           "bytes_per_step_per_rank": [rk["steps"][-1]["bytes"] for rk in ranks],
           "bytes_same_every_step": all(
               st["bytes"] == rk["steps"][-1]["bytes"] for rk in ranks for st in rk["steps"]),
           "launches_per_step_per_rank": [rk["steps"][-1]["launches"] for rk in ranks],
           "launches_expected_per_rank": [rk["launches_expected"] for rk in ranks],
           "launches_held": all(st["launches"] == rk["launches_expected"]
                                for rk in ranks for st in rk["steps"]),
           "losses_rank0": [st["loss"] for st in ranks[0]["steps"]],
           "finite": all(np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])
                         for rk in ranks for st in rk["steps"]),
           "whole_bit_equal": len({rk["whole_checksum"] for rk in ranks}) == 1,
           "whole_tensors": ranks[0]["whole_tensors"]}
    saved = os.path.join(ws, "ep0000", "model.safetensors")
    shapes = safetensors_header(saved)
    res["saved_gib"] = os.path.getsize(saved) / 2 ** 30
    if entry == "main":
        res["saved_layers"] = len({n.split(".")[3] for n in shapes
                                   if n.startswith("mesh_decoder.model.layers.")})
        res["saved_q_proj_shape"] = shapes["mesh_decoder.model.layers.0.self_attn.q_proj.weight"]
        whole = (res["saved_layers"] == L
                 and res["saved_q_proj_shape"] == [res["hidden"], res["hidden"]])
    else:
        whole = True  # the strict load into a fresh MDiT checks every tensor whole
    res["decode"] = decode_check(entry, flags, saved)
    res["ok"] = bool(res["steps"] == TRAIN_STEPS and res["finite"] and res["launches_held"]
                     and res["whole_bit_equal"] and whole and res["decode"]["ok"]
                     and res["backend"] == ["nccl"])
    return res


def torchrun(k: int, rank_dir: str, entry: str, argv: list, *extra) -> list:
    return [sys.executable, "-m", "torch.distributed.run", *extra, "--nproc_per_node", str(k),
            os.path.abspath(__file__), "rank", rank_dir, entry, *argv]


def layout(name: str, spec: tuple, tmp: str, out: str) -> dict:
    """One layout of LAYOUTS under `torchrun --standalone`, read."""
    entry, k, flags, rows = spec
    ws, rank_dir = os.path.join(tmp, name), os.path.join(out, f"{name}_ranks")
    os.makedirs(rank_dir, exist_ok=True)
    log = os.path.join(out, f"{name}.log")
    argv = main_argv(entry, flags, rows, ws, os.path.join(tmp, "absent"))
    t0 = time.perf_counter()
    try:
        run(torchrun(k, rank_dir, entry, argv, "--standalone"), log, RUN_TIMEOUT)
        res = read_layout(name, spec, ws, rank_dir, log)
    except Exception as exc:  # noqa: BLE001 - recorded; the next layout still runs
        res = {"name": name, "ranks": k, "flags": flags, "ok": False, "error": repr(exc)[:2000],
               "log": os.path.basename(log)}
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    return res


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nodes(tmp: str, out: str) -> dict:
    """NODES from two torchrun agents acting as two nodes of 2 cards each."""
    entry, k, flags, rows = NODES
    name = "nodes_dp2_tp2"
    ws, rank_dir = os.path.join(tmp, name), os.path.join(out, f"{name}_ranks")
    os.makedirs(rank_dir, exist_ok=True)
    argv = main_argv(entry, flags, rows, ws, os.path.join(tmp, "absent"))
    port = free_port()
    procs, t0 = [], time.perf_counter()
    try:
        for node, cards in enumerate(("0,1", "2,3")):
            cmd = torchrun(2, rank_dir, entry, argv, "--nnodes", "2", "--node_rank", str(node),
                           "--rdzv_backend", "c10d", "--rdzv_endpoint", f"localhost:{port}",
                           "--rdzv_id", name)
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards)
            log = os.path.join(out, f"{name}_node{node}.log")
            procs.append((start(cmd, log, env), cmd, log))
        for proc, cmd, log in procs:
            finish(proc, cmd, log, RUN_TIMEOUT - (time.perf_counter() - t0))
        res = read_layout(name, NODES, ws, rank_dir, procs[0][2])
        ranks = rank_files(rank_dir, k)
        res["nodes"] = 2
        res["visible_cards_per_rank"] = [rk["cards"] for rk in ranks]
        res["local_world_size_per_rank"] = [rk["local_world_size"] for rk in ranks]
        res["backend_by_the_world_rule"] = sorted({rk["backend_by_the_world_rule"]
                                                   for rk in ranks})
        res["ok"] = bool(res["ok"] and res["visible_cards_per_rank"] == [2] * k)
    except Exception as exc:  # noqa: BLE001 - recorded
        for proc, _, _ in procs:
            if proc.poll() is None:
                kill(proc)
        res = {"name": name, "ok": False, "error": repr(exc)[:2000]}
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    return res


# ------------------------------------------------------------- rank mode --

def rank_main(out_dir: str, entry: str, argv: list) -> int:
    """This process is one torchrun rank: it joins the world on its card
    (`init_distributed`, whose backend `choose_backend` picks), runs
    `edgerunner_tpu_torch.<entry>.main(argv)` in it as `python -m` runs it,
    every training step read by chip_smoke.py's `counted_train_steps`, and
    writes to out_dir/rank{RANK}.json those steps, the launches that
    chip_smoke.py's `step_launches` gives this rank, its peak memory and the
    checksum of the weights that no axis splits."""
    import importlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from chip_smoke import counted_train_steps, param_checksum, step_launches
    from edgerunner_tpu_torch.parallel.mesh import init_distributed, local_world_size, rank_device

    module = importlib.import_module(f"edgerunner_tpu_torch.{entry}")
    dev = rank_device("cuda")
    init_distributed(dev)
    steps = []
    try:
        # main leaves a world it did not join as it found it
        with counted_train_steps(steps, {}, lse="--sp_size" in argv):
            trainer = module.main(argv)
        opt, layout = trainer.opt, trainer.layout
        dit = entry == "main_dit"
        want = step_launches(opt.dit_num_layers if dit else opt.num_layers, opt.pp_size,
                             opt.pp_microbatches, opt.sp_size, layout.coords["sp"], dit=dit)
        whole = [p for n, p in trainer.params.items() if not trainer.split_axes(n)]
        world, cards = dist.get_world_size(), torch.cuda.device_count()
        out = {"rank": dist.get_rank(), "backend": dist.get_backend(), "device": str(dev),
               "describe": layout.describe(), "steps": steps, "launches_expected": want,
               "layers": opt.num_layers, "dit_layers": opt.dit_num_layers,
               "hidden": opt.hidden_dim,
               "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               "param_gib": sum(p.numel() for p in trainer.model.parameters()) * 4 / 2 ** 30,
               "whole_tensors": len(whole), "whole_checksum": param_checksum(whole),
               "cards": cards, "local_world_size": local_world_size(world),
               # what the rule before the per-machine count took: the whole
               # world against this machine's cards
               "backend_by_the_world_rule": "nccl" if world <= cards else "gloo"}
    except BaseException:
        # shown now: leaving an NCCL world whose other ranks still wait in a
        # collective can block until its timeout
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["rank"]:
        return rank_main(argv[1], argv[2], argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "workspace_dp_cards"))
    ap.add_argument("--parts", default="train,infer",
                    help="comma-separated: train (main --dp_size over NCCL), infer (the "
                         "fleets), layouts (LAYOUTS), nodes (two torchrun agents)")
    ap.add_argument("--layouts", default=",".join(LAYOUTS),
                    help="comma-separated names of LAYOUTS (those whose ranks the cards hold)")
    args = ap.parse_args(argv)
    import torch

    parts = args.parts.split(",")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"torch_dp_cards: needs 2 or more cards, and {cards} are present",
              file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, ROOT)
    from edgerunner_tpu_torch.data import save_mesh_file
    from edgerunner_tpu_torch.data._procgen import icosphere

    res = {"card": card_line(), "cards": cards, "train": [], "infer": [], "layouts": [],
           **link_between_cards(args.out)}
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
        if "nodes" in parts:
            res["nodes"] = (nodes(tmp, args.out) if cards >= 4 else
                            {"ok": False, "not_run": f"needs 4 cards, {cards} present"})
        if "layouts" in parts:
            for name in args.layouts.split(","):
                spec = LAYOUTS[name]
                if spec[1] > cards:
                    res["layouts"].append({"name": name, "ranks": spec[1], "not_run":
                                           f"needs {spec[1]} cards, {cards} present"})
                    continue
                res["layouts"].append(layout(name, spec, tmp, args.out))
                with open(os.path.join(args.out, "layouts.json"), "w") as fh:
                    json.dump(res, fh)
    if "infer" in parts:
        res["fleet_no_eos"] = fleet_no_eos()
    runs = [r for r in res["layouts"] if "not_run" not in r]
    if "nodes" in parts:
        runs.append(res["nodes"])
    res["ok"] = all(r.get("ok") for r in runs)
    with open(os.path.join(args.out, "result.json"), "w") as fh:
        json.dump(res, fh)
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

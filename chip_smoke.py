#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the quickest proof that
the port still builds, agrees with its plain versions, generates meshes
and trains.

    python3 chip_smoke.py [--phases build,kernels,...]

Phases, one JSON line each:

1. build     nvcc builds every kernel from edgerunner_tpu_torch/csrc.
2. kernels   each CUDA kernel against its plain PyTorch version on the card,
             at the main paths' shapes (generation and training) and at
             ragged ones, bf16 and f32, with its tolerance; at the main-path
             shapes also its time, the plain version's, one PyTorch library
             call's (a yardstick the port never calls) and the least time
             the card could take.
3. generate  the main path: `generate_tokens` at full ArAE width (24 layers,
             hidden 1536, 8192 points, 2049 condition tokens), bf16, random
             weights from a seed, 12 rows, 1000 faces, bench.py's 4096-token
             budget with EOS forbidden; the kernels' launch counts are zeroed
             just before and read just after; row 0 is detokenised into a
             mesh with the port's metok copy.
4. parity    2 layers at full width in f32 (TF32 off for matmuls and cuDNN):
             the kernel path and the plain path decode greedily in lockstep
             on the same tokens, and must choose the same token at every
             step where the plain logits' top-2 gap is at least NEAR_TIE.
5. train     the training path: `Trainer.train_step` at full ArAE width,
             bf16 autocast, gradient checkpointing and dropout on, on
             bench.py's train batch (2 rows of 6147 positions): one warm-up
             and TRAIN_STEPS timed steps (s/it, tokens/s, peak memory), each
             step's kernel launches counted from 0 and held to their exact
             counts, the last loss below the first; then one profiled step.
6. train_parity  2 layers at full width in f32: the training loss and every
             parameter's gradient of the kernel path against the plain path.

Then one JSON line with every kernel's numbers, the card's name and power
limit from nvidia-smi, and last the result line. Exits non-zero, printing
no result line, without a CUDA device, without the repository beside this
file, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
ROWS = 12                # bench.py's headline batch
FACES = 1000
PARITY_STEPS = 512
TRAIN_ROWS = 2           # bench.py's train probe: batch 2 ...
TRAIN_MESH_TOKENS = 4096  # ... of BOS + 4096 mesh tokens + EOS after the condition
TRAIN_RAGGED_LEN = 5000  # a shorter second row for the kernels' ragged train cases
TRAIN_STEPS = 3          # timed training steps after one warm-up step
GRAD_TOL = 2e-2          # train parity: gradient error over the tensor's largest value
PHASES = ("build", "kernels", "generate", "parity", "train", "train_parity")
NEAR_TIE = 1e-3          # plain top-2 logit gap under which a flip is allowed
# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `iters` runs, from CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tolerance(dtype, ref: torch.Tensor):
    """(atol, rtol) for a kernel against its plain version. bf16: the output
    is rounded to bf16 (step 2^-8 relative) and p is rounded to bf16 before
    PV, so 2^-6 relative plus 2^-9 of the largest value; f32: the same sums
    in another order, 1e-4 relative plus 1e-5 of the largest value."""
    scale = ref.abs().max().item()
    if dtype == torch.bfloat16:
        return 2.0 ** -9 * scale, 2.0 ** -6
    return 1e-5 * scale, 1e-4


def compare(out: torch.Tensor, ref: torch.Tensor, dtype) -> dict:
    out, ref = out.float(), ref.float()
    atol, rtol = tolerance(dtype, ref)
    err = (out - ref).abs()
    ok = bool(torch.isfinite(out).all()) and bool((err <= atol + rtol * ref.abs()).all())
    return {"max_abs_err": err.max().item(), "ref_max_abs": ref.abs().max().item(),
            "tolerance": f"|err| <= {atol:.3g} + {rtol:.3g} * |plain|", "ok": ok}


# ------------------------------------------------------------------ phases --

def phase_build():
    from edgerunner_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load_library()
    return {"seconds": time.perf_counter() - t0, "library": os.path.relpath(lib._name, HERE),
            "nvcc_seconds": _build.build_info.get("seconds"),
            "ptxas": _build.build_info.get("ptxas", [])}


def attention_pairs(B, N, M, causal, q_len=None, kv_len=None) -> int:
    """(query, key) pairs that these inputs need: for each row, the queries
    before q_len times their unmasked keys (causal: the lower triangle)."""
    total = 0
    for b in range(B):
        n = N if q_len is None else min(q_len[b], N)
        m = M if kv_len is None else min(kv_len[b], M)
        total += sum(min(i + 1, m) for i in range(n)) if causal else n * m
    return total


def bound(flops, nbytes, dtype) -> dict:
    bounds = {"operations": flops / PEAK_FLOPS[dtype], "bytes": nbytes / PEAK_BYTES_PER_S}
    by = max(bounds, key=bounds.get)
    return {"bound_by": by, "bound_ms": bounds[by] * 1e3, "flops": flops, "bytes": nbytes}


def attention_inputs(dev, B, N, M, H, D, causal, dtype, kv_len, q_len):
    g = torch.Generator(device=dev).manual_seed(N * 7 + M)
    q, k, v = (torch.randn(s, device=dev, generator=g, dtype=torch.float32).to(dtype)
               for s in ((B, N, H, D), (B, M, H, D), (B, M, H, D)))
    kw = dict(causal=causal,
              kv_len=None if kv_len is None else torch.tensor(kv_len, device=dev),
              q_len=None if q_len is None else torch.tensor(q_len, device=dev))
    return g, q, k, v, kw


def flash_case(dev, B, N, M, H, D, causal, dtype, kv_len=None, q_len=None, timed=False):
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    _, q, k, v, kw = attention_inputs(dev, B, N, M, H, D, causal, dtype, kv_len, q_len)
    out, lse = flash_attention(q, k, v, **kw)
    ref, ref_lse = flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    res = {"shape": [B, N, M, H, D], "causal": causal, "dtype": str(dtype).split(".")[-1],
           "kv_len": kv_len, "q_len": q_len, **compare(out, ref, dtype)}
    lse_err = (lse - ref_lse).abs().max().item()
    res.update(lse_max_abs_err=lse_err, lse_tolerance=1e-3)
    res["ok"] = res["ok"] and lse_err <= 1e-3
    del ref, ref_lse
    if timed:
        import torch.nn.functional as F

        res["ms"] = time_ms(lambda: flash_attention(q, k, v, **kw), 5)
        res["plain_ms"] = time_ms(lambda: flash_attention_reference(q, k, v, **kw), 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        res["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 5)
        # two products of the pairs these inputs need (QK^T and PV)
        flops = 4.0 * H * D * attention_pairs(B, N, M, causal, q_len, kv_len)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + lse.numel() * 4
        res.update(bound(flops, nbytes, dtype))
    return res


def flash_bwd_case(dev, B, N, M, H, D, causal, dtype, kv_len=None, q_len=None,
                   timed=False):
    """The backward kernel against its plain version on the same inputs: q,
    k, v, dO from a seed, o and lse from the forward kernel."""
    from edgerunner_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_reference,
    )

    g, q, k, v, kw = attention_inputs(dev, B, N, M, H, D, causal, dtype, kv_len, q_len)
    do = torch.randn((B, N, H, D), device=dev, generator=g).to(dtype)
    o, lse = flash_attention(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    refs = flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    res = {"shape": [B, N, M, H, D], "causal": causal, "dtype": str(dtype).split(".")[-1],
           "kv_len": kv_len, "q_len": q_len}
    checks = {name: compare(a, b, dtype) for name, a, b in zip(("dq", "dk", "dv"), grads, refs)}
    res.update(checks)
    res["max_abs_err"] = max(c["max_abs_err"] for c in checks.values())
    res["ok"] = all(c["ok"] for c in checks.values())
    del grads, refs
    if timed:
        import torch.nn.functional as F

        res["ms"] = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), 3)
        res["plain_ms"] = time_ms(
            lambda: flash_attention_bwd_reference(q, k, v, o, lse, do, **kw), 1)
        # the yardstick: SDPA's backward at the same shape, full lengths
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2)
        res["library_ms"] = time_ms(
            lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 3)
        del out
        # five products of the pairs these inputs need (QK^T, dO V^T, P^T dO,
        # dS K, dS^T Q): the least work of a backward that recomputes P; bytes:
        # q, k, v, o, dO and lse read once, dq, dk, dv written once
        flops = 10.0 * H * D * attention_pairs(B, N, M, causal, q_len, kv_len)
        nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + lse.numel() * 4
        res.update(bound(flops, nbytes, dtype))
    return res


def decode_case(dev, B, L, hidden, H, index, dtype, timed=False):
    from edgerunner_tpu_torch.ops.decode_attention import (
        fused_decode_attention,
        fused_decode_attention_reference,
    )

    g = torch.Generator(device=dev).manual_seed(index + L)
    kc, vc = (torch.randn(B, L, hidden, device=dev, generator=g).to(dtype) for _ in range(2))
    q = torch.randn(B, hidden, device=dev, generator=g).to(dtype)
    out = fused_decode_attention(q, kc, vc, index, num_heads=H)
    ref = fused_decode_attention_reference(q, kc, vc, index, num_heads=H)
    torch.cuda.synchronize()
    res = {"shape": [B, L, hidden], "heads": H, "index": index,
           "dtype": str(dtype).split(".")[-1], **compare(out, ref, dtype)}
    if timed:
        import torch.nn.functional as F

        D, n = hidden // H, index + 1
        res["ms"] = time_ms(lambda: fused_decode_attention(q, kc, vc, index, num_heads=H), 50, 3)
        res["plain_ms"] = time_ms(
            lambda: fused_decode_attention_reference(q, kc, vc, index, num_heads=H), 20, 2)
        qh = q.reshape(B, 1, H, D).transpose(1, 2)
        kh = kc[:, :n].reshape(B, n, H, D).transpose(1, 2)
        vh = vc[:, :n].reshape(B, n, H, D).transpose(1, 2)
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 50, 3)
        # rows [0, index] of both caches, q and out, once each
        nbytes = (2 * B * n * hidden + 2 * B * hidden) * q.element_size()
        res.update(bound(4.0 * B * n * hidden, nbytes, dtype))
    return res


def main_path_shapes():
    """Prompt length, new tokens and cache length of the generate phase."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.generate import decode_shape, round_up_bucket

    opt = config_defaults["ArAE"]
    budget = round_up_bucket(min(FACES * 4 + 32, opt.max_seq_length), opt.decode_bucket)
    num_new, max_len = decode_shape(opt, 1, FACES, budget)
    return opt, budget, 1 + opt.num_cond_tokens, num_new, max_len


def train_positions(opt) -> int:
    """Positions of a training row: condition tokens, BOS, mesh tokens, EOS."""
    return opt.num_cond_tokens + 1 + TRAIN_MESH_TOKENS + 1


def phase_kernels(dev):
    opt, _, plen, num_new, L = main_path_shapes()
    bf, f32 = torch.bfloat16, torch.float32
    hd, H = opt.hidden_dim, opt.num_heads
    ph, pH = opt.point_hidden_dim, opt.point_num_heads
    flash = [
        dict(case="encoder (main path)", **flash_case(
            dev, ROWS, opt.point_latent_size, opt.point_num, pH, ph // pH, False, bf, timed=True)),
        dict(case="prefill (main path)", **flash_case(
            dev, ROWS, plen, plen, H, hd // H, True, bf, timed=True)),
        dict(case="ragged", **flash_case(dev, 3, 77, 133, 3, 96, False, bf,
                                         kv_len=[133, 50, 0], q_len=[77, 30, 77])),
        dict(case="ragged causal", **flash_case(dev, 3, 130, 130, 16, 96, True, bf,
                                                kv_len=[130, 100, 65], q_len=[130, 100, 65])),
        dict(case="ragged f32", **flash_case(dev, 2, 300, 1000, 4, 64, False, f32,
                                             kv_len=[1000, 513])),
        dict(case="ragged causal f32", **flash_case(dev, 2, 77, 77, 2, 64, True, f32,
                                                    kv_len=[77, 40], q_len=[77, 40])),
        dict(case="ragged causal f32 d96", **flash_case(dev, 2, 200, 200, 2, 96, True, f32,
                                                        kv_len=[200, 3])),
    ]
    # the training step's shapes: the decoder's causal self-attention over
    # the train batch's positions (row 1 ragged) and the encoder's cross-attention
    T = train_positions(opt)
    lens = [T, TRAIN_RAGGED_LEN]
    flash += [
        dict(case="decoder train (main path)", **flash_case(
            dev, TRAIN_ROWS, T, T, H, hd // H, True, bf, kv_len=lens, q_len=lens, timed=True)),
        dict(case="encoder train (main path)", **flash_case(
            dev, TRAIN_ROWS, opt.point_latent_size, opt.point_num, pH, ph // pH, False, bf,
            timed=True)),
    ]
    flash_bwd = [
        dict(case="decoder train (main path)", **flash_bwd_case(
            dev, TRAIN_ROWS, T, T, H, hd // H, True, bf, kv_len=lens, q_len=lens, timed=True)),
        dict(case="encoder train (main path)", **flash_bwd_case(
            dev, TRAIN_ROWS, opt.point_latent_size, opt.point_num, pH, ph // pH, False, bf,
            timed=True)),
        dict(case="ragged", **flash_bwd_case(dev, 3, 77, 133, 3, 96, False, bf,
                                             kv_len=[133, 50, 0], q_len=[77, 30, 77])),
        dict(case="ragged causal", **flash_bwd_case(dev, 3, 130, 130, 16, 96, True, bf,
                                                    kv_len=[130, 0, 65], q_len=[130, 0, 65])),
        dict(case="ragged f32", **flash_bwd_case(dev, 3, 300, 1000, 4, 64, False, f32,
                                                 kv_len=[1000, 513, 0], q_len=[300, 250, 300])),
        dict(case="ragged causal f32", **flash_bwd_case(dev, 2, 77, 77, 2, 64, True, f32,
                                                        kv_len=[77, 40], q_len=[77, 40])),
        dict(case="ragged causal f32 d96", **flash_bwd_case(
            dev, 3, 200, 200, 2, 96, True, f32, kv_len=[200, 3, 0], q_len=[150, 3, 0])),
        dict(case="ragged d64", **flash_bwd_case(dev, 2, 100, 45, 4, 64, False, bf,
                                                 kv_len=[45, 0])),
    ]
    mid = plen + num_new // 2  # the mean position of the decode loop
    decode = [dict(case=f"index {i}", **decode_case(dev, ROWS, L, hd, H, i, bf))
              for i in sorted({0, 511, 512, L - 1}) if i < L]
    decode.append(dict(case=f"index {mid} (main path, mean position)",
                       **decode_case(dev, ROWS, L, hd, H, mid, bf, timed=True)))
    decode.append(dict(case="f32", **decode_case(dev, 2, 1024, hd, H, 700, f32)))
    decode.append(dict(case="d64", **decode_case(dev, 3, 1024, 1024, 16, 300, bf)))
    decode.append(dict(case="d64 f32", **decode_case(dev, 3, 1024, 1024, 16, 1023, f32)))
    ok = all(c["ok"] for c in flash + flash_bwd + decode)
    return {"ok": ok, "flash": flash, "flash_bwd": flash_bwd, "decode": decode}


def build_model(opt, dev, dtype, seed, use_kernels=True):
    from edgerunner_tpu_torch.models.lmm import LMM, init_weights

    model = LMM(opt, dtype=dtype, device=dev, use_kernels=use_kernels)
    return init_weights(model, seed).eval()


def phase_generate(dev):
    from edgerunner_tpu_torch.data import save_mesh
    from edgerunner_tpu_torch.generate import generate_tokens
    from edgerunner_tpu_torch.ops.decode_attention import fused_decode_attention
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention
    from edgerunner_tpu_torch.utils import get_tokenizer

    opt, budget, plen, num_new, max_len = main_path_shapes()
    opt = dataclasses.replace(opt, generate_mode="greedy")
    t0 = time.perf_counter()
    model = build_model(opt, dev, torch.bfloat16, SEED)
    points = np.random.default_rng(SEED).normal(size=(ROWS, opt.point_num, 3)).astype(np.float32)
    nf = torch.full((ROWS,), FACES, device=dev)
    prompt = torch.full((ROWS, 1), opt.bos_token_id, device=dev)
    with torch.no_grad():  # warm-up of every library call on the path, and the prefill's time
        model.prefill(torch.tensor(points, device=dev), nf, prompt, max_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.prefill(torch.tensor(points, device=dev), nf, prompt, max_len)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
    setup_s = t1 - t0 - prefill_s

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    fused_decode_attention.launches = 0
    t2 = time.perf_counter()
    tokens = generate_tokens(model, points, num_faces=FACES, max_new_tokens=budget,
                             bench_no_eos=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t2
    launches = {"flash_attention_fwd": flash_attention.launches,
                "fused_decode_attention": fused_decode_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    tokenizer, _ = get_tokenizer(opt)
    verts, faces = save_mesh(tokens[0], opt, None, tokenizer=tokenizer, clean=True)
    ok = (tokens.shape == (ROWS, num_new) and all(v > 0 for v in launches.values())
          and bool(np.isfinite(verts).all())
          and (len(faces) == 0 or int(faces.max()) < len(verts)))
    res = {"ok": ok, "rows": ROWS, "num_faces": FACES, "num_new": num_new,
           "prompt_len": plen, "max_len": max_len, "layers": opt.num_layers,
           "hidden": opt.hidden_dim, "point_num": opt.point_num, "dtype": "bfloat16",
           "setup_s": setup_s, "prefill_s": prefill_s, "generate_s": gen_s,
           "ms_per_step": (gen_s - prefill_s) / (num_new - 1) * 1e3,
           "tokens_per_s": ROWS * num_new / gen_s, "peak_mem_gib": peak,
           "launches": launches, "mesh0_vertices": int(len(verts)),
           "mesh0_faces": int(len(faces)), "card": card_line()}
    # PERF.md quotes the profile's device times: a profile without them fails the phase
    res.update(profile_decode(model, opt, dev, points, max_len, plen + num_new // 2))
    res["ok"] = ok and res["device_ms_per_step"] > 0
    return res


def profile_decode(model, opt, dev, points, max_len, index, steps=32):
    """Device busy share and device time by kernel over `steps` decode steps
    of the main path from position `index` on (torch.profiler's CUDA
    activity)."""
    from torch.profiler import ProfilerActivity, profile

    nf = torch.full((ROWS,), FACES, device=dev)
    prompt = torch.full((ROWS, 1), opt.bos_token_id, device=dev)
    with torch.no_grad():
        _, caches, _ = model.prefill(torch.tensor(points, device=dev), nf, prompt, max_len)
        ids = torch.full((ROWS, 1), 5, device=dev)
        model.step(ids, caches, index)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                model.step(ids, caches, index + 1 + i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0]
    kernels = sorted(((e.key[:60], e.device_time_total / 1e3 / steps) for e in events
                      if e.device_type.name == "CUDA"), key=lambda x: -x[1])
    device_ms = sum(ms for _, ms in kernels)
    return {"profiled_steps": steps, "profiled_index": index,
            "profiled_wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / (wall_ms / steps) if wall_ms else None,
            "top_kernels_ms_per_step": kernels[:8]}


def phase_parity(dev):
    """Kernel path against plain path, 2 layers at full width in f32: both
    models generate their own greedy streams through `generate_tokens`; a
    lockstep replay on the plain stream's tokens reads the plain logits'
    top-2 gap and both paths' choices at every step. The streams must agree
    up to the first step whose gap is under NEAR_TIE, the paths may choose
    differently only at such steps, and the logits may differ by less than
    1e-2 (f32 sums in another order differ by ~1e-5)."""
    from edgerunner_tpu_torch.config import config_defaults, vocab_size_for
    from edgerunner_tpu_torch.generate import decode_shape, generate_tokens
    from edgerunner_tpu_torch.ops import sampling as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = dataclasses.replace(config_defaults["ArAE"], num_layers=2, generate_mode="greedy")
    kernel = build_model(opt, dev, torch.float32, SEED + 1)
    plain = build_model(opt, dev, torch.float32, SEED + 1, use_kernels=False)
    rows = 2
    points = np.random.default_rng(SEED + 1).normal(
        size=(rows, opt.point_num, 3)).astype(np.float32)
    kw = dict(num_faces=FACES, max_new_tokens=PARITY_STEPS, bench_no_eos=True)
    stream_k = generate_tokens(kernel, points, **kw)
    stream_p = generate_tokens(plain, points, **kw)
    steps, max_len = decode_shape(opt, 1, FACES, PARITY_STEPS)

    vocab = vocab_size_for(opt)
    G = S.get_grammar(opt.meto_backend)
    no_eos = torch.arange(vocab, device=dev)[None] != S.EOS_ID
    nf = torch.full((rows,), FACES, device=dev)
    prompt = torch.full((rows, 1), opt.bos_token_id, device=dev)
    gaps = np.zeros((rows, steps))
    chose_k = np.zeros((rows, steps), np.int64)
    replay = np.zeros((rows, steps), np.int64)
    max_diff = 0.0
    with torch.no_grad():
        pts = torch.tensor(points, device=dev)
        lk, ck, plen = kernel.prefill(pts, nf, prompt, max_len)
        lp, cp, _ = plain.prefill(pts, nf, prompt, max_len)
        state = G.init(rows, dev)
        for i in range(steps):
            mask = G.mask(state, vocab) & no_eos
            a = S.apply_mask(lk[:, 0].float(), mask)
            b = S.apply_mask(lp[:, 0].float(), mask)
            max_diff = max(max_diff, (lk - lp).abs().max().item())
            top2 = torch.topk(b, 2, dim=-1).values
            tb = S.greedy_token(b)
            gaps[:, i] = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            chose_k[:, i] = S.greedy_token(a).cpu().numpy()
            replay[:, i] = tb.cpu().numpy()
            state = G.advance(state, tb)
            if i + 1 < steps:
                lk = kernel.step(tb[:, None], ck, plen + i)
                lp = plain.step(tb[:, None], cp, plen + i)
    flips = (chose_k != replay)
    first = [int(np.argmax(stream_k[r] != stream_p[r])) if (stream_k[r] != stream_p[r]).any()
             else None for r in range(rows)]
    streams_ok = all(t is None or gaps[r, t] < NEAR_TIE for r, t in enumerate(first))
    ok = (streams_ok and bool(np.array_equal(replay, stream_p))
          and not (flips & (gaps >= NEAR_TIE)).any() and max_diff < 1e-2)
    return {"ok": ok, "layers": 2, "rows": rows, "steps": steps, "dtype": "float32",
            "tf32": False, "near_tie": NEAR_TIE,
            "streams_identical": bool(np.array_equal(stream_k, stream_p)),
            "first_mismatch": first,
            "plain_stream_replayed_exactly": bool(np.array_equal(replay, stream_p)),
            "steps_under_near_tie": int((gaps < NEAR_TIE).sum()),
            "flips": int(flips.sum()),
            "flips_above_near_tie": int((flips & (gaps >= NEAR_TIE)).sum()),
            "min_gap": float(gaps.min()), "logits_max_abs_diff": max_diff}


def train_batch(opt, rows: int, lengths=None) -> dict:
    """The batch of bench.py's train probe (bench.py:166-177): points and
    tokens from np.random.default_rng(0), 1000 faces. With `lengths`, rows
    are cut to those total lengths (PAD tokens, labels -100 past them)."""
    C, M = opt.num_cond_tokens, TRAIN_MESH_TOKENS
    rng = np.random.default_rng(0)
    batch = {
        "conds": rng.normal(size=(rows, opt.point_num, 3)).astype(np.float32),
        "tokens": np.concatenate([np.full((rows, 1), 1), rng.integers(6, 100, (rows, M)),
                                  np.full((rows, 1), 2)], axis=1).astype(np.int32),
        "labels": np.concatenate([np.full((rows, C + 1), -100),
                                  rng.integers(6, 100, (rows, M)),
                                  np.full((rows, 1), 2)], axis=1).astype(np.int32),
        "lengths": np.full((rows,), C + 1 + M + 1, np.int32),
        "num_faces": np.full((rows,), FACES, np.int32),
    }
    if lengths is not None:
        for r, n in enumerate(lengths):
            batch["tokens"][r, n - C:] = opt.pad_token_id
            batch["labels"][r, n:] = -100
        batch["lengths"] = np.asarray(lengths, np.int32)
    return batch


def phase_train(dev):
    """The training path: `Trainer.train_step` at full ArAE width, bf16
    autocast over f32 weights from seed 0, gradient checkpointing and
    dropout on, bench.py's train batch and its optimizer horizon
    (`make_optimizer(opt, 1000)`). One warm-up step, then TRAIN_STEPS timed
    steps; each step's launches are counted from 0 and must be exactly 2 per
    attention call for the forward kernel (forward and checkpointed
    recompute) and 1 for the backward. Then one profiled step gives the
    device time by kernel."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.models.lmm import LMM, init_weights
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from edgerunner_tpu_torch.train.trainer import Trainer

    opt = dataclasses.replace(config_defaults["ArAE"], batch_size=TRAIN_ROWS)
    t0 = time.perf_counter()
    trainer = Trainer(init_weights(LMM(opt, device=dev), SEED), opt, total_steps=1000)
    batch = train_batch(opt, TRAIN_ROWS)
    setup_s = time.perf_counter() - t0
    calls = opt.num_layers + 1  # attention calls per forward: decoder layers + encoder
    want = {"flash_attention_fwd": 2 * calls, "flash_attention_bwd": calls}
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(1 + TRAIN_STEPS):
        flash_attention.launches = flash_attention_bwd.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t1, **m, "launches": {
            "flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches}})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s_per_it = sum(st["s"] for st in steps[1:]) / TRAIN_STEPS
    T = train_positions(opt)
    losses = [st["loss"] for st in steps]
    counts_ok = all(st["launches"] == want for st in steps)
    ok = (counts_ok and all(np.isfinite(losses)) and losses[-1] < losses[0])
    res = {"ok": ok, "rows": TRAIN_ROWS, "positions": T, "layers": opt.num_layers,
           "hidden": opt.hidden_dim, "point_num": opt.point_num, "autocast": "bfloat16",
           "checkpointing": opt.checkpointing, "setup_s": setup_s,
           "warmup_s": steps[0]["s"], "timed_steps": TRAIN_STEPS, "s_per_it": s_per_it,
           "tokens_per_s": TRAIN_ROWS * T / s_per_it, "peak_mem_gib": peak,
           "losses": losses, "grad_norms": [st["grad_norm"] for st in steps],
           "launches_per_step": [st["launches"] for st in steps],
           "launches_expected_per_step": want,
           "launches": {k: sum(st["launches"][k] for st in steps) for k in want},
           "card": card_line()}
    res.update(profile_train(trainer, batch))
    return res


def profile_train(trainer, batch):
    """Device time by kernel over one more training step (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key[:60], e.device_time_total / 1e3) for e in prof.key_averages()
                      if e.device_type.name == "CUDA" and e.device_time_total > 0),
                     key=lambda x: -x[1])
    device_ms = sum(ms for _, ms in kernels)
    return {"profiled_wall_ms": wall_ms, "profiled_device_ms": device_ms,
            "profiled_device_busy_share": device_ms / wall_ms,
            "top_kernels_ms": kernels[:10]}


def phase_train_parity(dev):
    """Kernel path against plain path of the training loss and every
    parameter's gradient: 2 layers at full width in f32 (TF32 off), the same
    weights, the train batch with its second row cut to TRAIN_RAGGED_LEN,
    gradient checkpointing on, dropout and num-face dropout off (train=False).
    Tolerance: the loss within 1e-5 relative; each gradient tensor within
    GRAD_TOL of its largest plain value plus 1e-6 of the largest plain
    gradient of the model. Both paths are f32, and f32 rounding reaches some
    of these gradients amplified (LayerNorm backward cancels most of what
    flows into it; the kernels sum up to 6147 terms in one accumulator), so
    that the two paths differ by about a percent of some tensors' largest
    values; the phase reports how far each path is from an f64 run of the
    plain path. A fault in a kernel moves gradients by their own size.
    The floor covers tensors whose true gradient is zero, such as the key
    projections' biases, where both paths hold only rounding noise."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.models.lmm import LMM, init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = dataclasses.replace(config_defaults["ArAE"], num_layers=2, mixed_precision="no")
    kernel = init_weights(LMM(opt, device=dev), SEED + 2)
    plain = LMM(opt, device=dev, use_kernels=False)
    plain.load_state_dict(kernel.state_dict())
    batch = train_batch(opt, TRAIN_ROWS, lengths=[train_positions(opt), TRAIN_RAGGED_LEN])
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def loss_and_grads(model, dtype):
        o = model(b["conds"].to(dtype), b["tokens"], b["labels"], b["num_faces"],
                  b["lengths"], train=False)
        params = dict(model.named_parameters())
        return o["loss"].item(), dict(zip(params, torch.autograd.grad(
            o["loss"], list(params.values()))))

    (lk, gk), (lp, gp) = (loss_and_grads(m, torch.float32) for m in (kernel, plain))
    del plain
    # the f64 yardstick of both f32 paths' rounding (reported, not gated),
    # over the tensors whose gradient is not rounding noise
    wide = LMM(opt, device=dev, use_kernels=False, dtype=torch.float64)
    wide.load_state_dict(kernel.state_dict())
    del kernel
    _, g64 = loss_and_grads(wide, torch.float64)
    del wide
    vs64 = {name: max((g[n].double() - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                      for n, w in g64.items() if w.abs().max().item() > 1e-6)
            for name, g in (("kernel", gk), ("plain", gp))}
    top = max(g.abs().max().item() for g in gp.values())
    worst, worst_name = 0.0, None
    for n, g in gp.items():
        # this tensor's error over its tolerance: ok while <= 1
        err = (gk[n] - g).abs().max().item() / (GRAD_TOL * g.abs().max().item() + 1e-6 * top)
        if err > worst:
            worst, worst_name = err, n
    loss_err = abs(lk - lp) / abs(lp)
    ok = loss_err <= 1e-5 and worst <= 1.0 and all(
        torch.isfinite(g).all().item() for g in gk.values())
    return {"ok": ok, "layers": 2, "rows": TRAIN_ROWS, "dtype": "float32", "tf32": False,
            "lengths": batch["lengths"].tolist(), "loss_kernel": lk, "loss_plain": lp,
            "loss_rel_err": loss_err, "grad_tensors": len(gp),
            "grad_max_abs": top, "grad_worst_err_over_tol": worst,
            "grad_worst_rel_err_vs_f64": vs64,
            "grad_worst_tensor": worst_name,
            "tolerance": f"loss rel <= 1e-5; per tensor max|dg| <= {GRAD_TOL} * max|g_plain| "
                         "+ 1e-6 * max over tensors of max|g_plain|"}


def kernels_line(kern, gen, train):
    """One entry per kernel: main-path numbers from this run; launches from
    the generate path (forward and decode kernels) and the train path
    (backward kernel), each counted from 0 over its run."""
    def case(cases, prefix):
        return next(c for c in cases if c["case"].startswith(prefix))

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def sub(c):
        return {"shape": c["shape"], "max_abs_err": c["max_abs_err"], **{k: c[k] for k in keys}}

    prefill, bwd = case(kern["flash"], "prefill"), case(kern["flash_bwd"], "decoder train")
    dec = next(c for c in kern["decode"] if "main path" in c["case"])
    return {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "edgerunner_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "edgerunner_tpu/ops/flash_attention.py:258",
         "launches": gen["launches"]["flash_attention_fwd"],
         "max_abs_err": prefill["max_abs_err"], **{k: prefill[k] for k in keys},
         "shape": prefill["shape"],
         "launches_by_path": {"generate": gen["launches"]["flash_attention_fwd"],
                              "train": train["launches"]["flash_attention_fwd"]},
         "encoder_shape": sub(case(kern["flash"], "encoder (main")),
         "train_decoder_shape": sub(case(kern["flash"], "decoder train")),
         "train_encoder_shape": sub(case(kern["flash"], "encoder train"))},
        {"name": "fused_decode_attention", "route": "cuda",
         "source": "edgerunner_tpu_torch/csrc/decode_attention.cu",
         "replaces": "edgerunner_tpu/ops/decode_attention_pallas.py:139",
         "launches": gen["launches"]["fused_decode_attention"],
         "max_abs_err": dec["max_abs_err"], **{k: dec[k] for k in keys},
         "shape": dec["shape"], "index": dec["index"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "edgerunner_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "edgerunner_tpu/ops/flash_attention.py:520",
         "launches": train["launches"]["flash_attention_bwd"],
         "max_abs_err": bwd["max_abs_err"], **{k: bwd[k] for k in keys},
         "shape": bwd["shape"], "lengths": bwd["kv_len"],
         "encoder_shape": sub(case(kern["flash_bwd"], "encoder train"))},
    ]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run; the kernels "
                         "and result lines are printed only when all run")
    wanted = ap.parse_args(argv).phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    runs = {"build": phase_build, "kernels": lambda: phase_kernels(dev),
            "generate": lambda: phase_generate(dev), "parity": lambda: phase_parity(dev),
            "train": lambda: phase_train(dev), "train_parity": lambda: phase_train_parity(dev)}
    results, ok = {}, True
    for name in PHASES:
        if name not in wanted:
            continue
        t0 = time.perf_counter()
        try:
            res = runs[name]()
            res.setdefault("ok", True)
        except Exception as exc:  # noqa: BLE001 - a failed phase is reported, the run goes on
            res = {"ok": False, "error": f"{type(exc).__name__}: {exc}",
                   "traceback": traceback.format_exc()[-3000:]}
        torch.cuda.empty_cache()
        res = {"phase": name, "seconds": time.perf_counter() - t0, **res}
        emit(res)
        results[name] = res
        ok = ok and res["ok"]
        if name == "build" and not res["ok"]:
            break
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    if set(PHASES) - set(wanted):
        return 0
    emit(kernels_line(results["kernels"], results["generate"], results["train"]))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

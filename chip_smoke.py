#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: the quickest proof that
the port still builds, agrees with its plain versions, generates meshes
from point clouds and from images (through the DiT's latents, and through
the image-conditioned ArAE), serves them over HTTP and trains.

    python3 chip_smoke.py [--phases build,kernels,...]

Phases, one JSON line each:

1. build     nvcc builds every kernel from edgerunner_tpu_torch/csrc; ptxas's
             registers and spills per kernel; fails if a tensor-core flash
             kernel (the forward's bf16 and 3xTF32 instances, the backward's
             bf16 and 3xTF32 dq and dk/dv, each at D 64 and 96) or a
             persistent decode kernel (B and every kind of D) spills.
2. kernels   each CUDA kernel against its plain PyTorch version on the card,
             at the main paths' shapes (generation, serving, training and
             the sp ring's blocks, where row 5 takes a non-zero lse
             cotangent) and at ragged ones (the flash kernels also at
             shapes that straddle their 64-row tiles, and with a causal row
             without keys whose output is kept), bf16, f32, int8 and int4 caches
             (per-row and grouped scales, a head straddling the nibble
             halves), with its tolerance; at the main-path shapes also its
             time (a loop of launches; for the decode kernels also the
             launches queued back to back behind a device-side wait, which
             leaves out the host's time per call, and with L2 flushed
             before each launch), the plain version's, one
             PyTorch library call's (a yardstick the port never calls; none
             attends over a quantised cache) and the least time the card
             could take. Decode positions come as host ints, per-row
             vectors and vectors built on the device. Kernel A also at the
             DiT's shapes, f32 (what the image pipeline runs) and bf16:
             self-attention [2, 2048, 2048, 16, 64] and cross-attention
             [2, 2048 x 257, 16, 64] (257 keys straddle the 64-key tiles),
             neither causal, and a ragged cross case with kv_len [257, 100];
             the f32 cases' bound is the tensor cores' f32-exact rate (3xTF32,
             495 / 3 TFLOP/s), the CUDA cores' 67 TFLOP/s beside it. Kernels
             A and C at the DiT training step's shapes, bf16 at the DiT
             preset's batch: self [8, 2048, 2048, 16, 64] and cross
             [8, 2048 x 257, 16, 64], timed; the tile-edge cases include
             257 keys (4 x 64 + 1), forward and backward. The
             image-conditioned ArAE's shapes (16 heads of 64): kernel A's
             causal prefill [12, 258, 258, 16, 64] (258 = 4 x 64 + 2), A
             and C at its causal training step [4, 4355, 4355, 16, 64] with
             every other row cut to 3000, kernel B over its 1000-face cache
             [12, 5632, 1024] at the decode's mean position, all timed; and
             kernel C's 3xTF32 f32 instance, timed at the DiT's self shape
             [2, 2048, 2048, 16, 64], where the f32 parity phases run it, and
             at the f32 ArAE training step's decoder [2, 6147, 6147, 16, 96]
             (causal, rows [6147, 5000]) and encoder [2, 2048 x 8192, 16,
             64]. Kernel D's bf16/f32 kind also at every T from 1 to 8, both
             dtypes and D 64 and 96, at positions 0, 255, 256 and the
             cache's last. Last, a
             diagnostic at the DiT's self-attention shape with q and k scaled
             so that the logits span tens: the plain version with TF32
             matmuls fails the f32 tolerance rule where the kernel passes it
             (both errors printed on a line of their own).
3. generate  the main path: `generate_tokens` at full ArAE width (24 layers,
             hidden 1536, 8192 points, 2049 condition tokens), bf16, random
             weights from a seed, 12 rows, 1000 faces, bench.py's 4096-token
             budget with EOS forbidden; the kernels' launch counts are zeroed
             just before and read just after; row 0 is detokenised into a
             mesh with the port's metok copy.
4. generate_q8  the same path over the int8 KV cache (--kv_quant true) with
             a 512-token budget (--decode_bucket 512); its decode kernel's
             launches held exactly; a profiled segment.
5. generate_q4  bench.py's quant_fast configuration (--kv_quant true
             --kv_bits 4 --w_quant true, 40 rows) with a 512-token budget;
             row 7's launches held exactly; a profiled segment.
6. parity    2 layers at full width in f32 (TF32 off for matmuls and cuDNN):
             the kernel path and the plain path decode greedily in lockstep
             on the same tokens, and must choose the same token at every
             step where the plain logits' top-2 gap is at least NEAR_TIE.
7. parity_q4 the same over the int4 cache, 512 steps: per-row, kv_group 96,
             kv_rotate.
8. serve     the server as the README starts it (--test_batch_size 8), full
             width, bf16, random weights from seed 0: HTTP requests through
             `build_server` (JAX's JSON, a malformed body answered 400), then
             the continuous-batching engine alone (8 requests of 512
             tokens) with the bf16 cache, with --kv_quant true --w_quant
             true and with --kv_quant true --kv_bits 4: tokens/s, ms per
             engine step, peak memory, a profiled segment, and exactly one
             launch of the multi-query kernel per layer and step.
9. serve_parity  2 layers at full width in f32: every stream the engine
             delivers equals its request's solo `generate_tokens` stream up
             to near-ties, kernel and plain paths, exact and int8 caches.
10. spec     --mtp_heads 2 --spec_decode true with random draft heads, on
             `generate_tokens` and on the engine, over the bf16 and the int4
             cache: tokens accepted per verify pass, ms per pass, rows 9 and
             10 launched exactly once per layer and pass at T = 3; then f32
             spec streams against vanilla streams up to near-ties (512 steps).
11. train    the training path: `Trainer.train_step` at full ArAE width,
             bf16 autocast, gradient checkpointing and dropout on, on
             bench.py's train batch (2 rows of 6147 positions): one warm-up
             and TRAIN_STEPS timed steps (s/it, tokens/s, peak memory), each
             step's kernel launches counted from 0 and held to their exact
             counts, the last loss below the first; then one profiled step.
             Then the same path in f32 (--mixed_precision no): two steps
             with every flash launch f32 and held to A 50 and C 25 per step
             (s/it, peak memory), then one profiled step (device ms by
             kernel).
12. train_parity  2 layers at full width in f32: the training loss and every
             parameter's gradient of the kernel path against the plain path.
13. sp       sequence parallelism with ranks that share the card (gloo,
             staged through pinned host memory), spawned from this process:
             the causal ring at full width ([2, 6148, 16, 96], bf16 and f32)
             over 2 and 4 ranks against single-process attention; with 2
             ranks the full-width training step (bf16 autocast,
             checkpointing, bench.py's train batch padded to 6148): its
             held-out loss against the single-process one, then SP_TRAIN_STEPS
             timed steps with row 5's launches held exactly per rank, s/it
             and peak memory per rank, the bytes the ring shifts, the
             parameters' checksum equal on every rank; and the f32 parity of
             its loss and gradients against one process at 2 layers. With 4
             ranks also the f32 parity of a dp 2 x sp 2 step at 2 layers
             (each dp group 2 rows of its own, each sp rank half of their
             positions) against one process on the 4 rows.
14. dp       data parallelism with 2 ranks that share the card (gloo, staged
             through pinned host memory), spawned from this process: the
             full-width ArAE training step as main builds its Trainer (bf16
             autocast, checkpointing and dropout on, bench.py's 2 rows of
             6147 positions per rank, other rows on each rank): the 4-row
             batch's loss as the ranks' summed shares against rank 0's
             single-process loss, then timed steps with launches held to A
             50 and C 25 per step and rank, s/it per rank, the bytes
             all-reduced per step, peak memory, the parameters' checksum
             equal on both ranks; the f32 parity (TF32 off) of a dp 2 step at
             2 layers against one process on the same 4 rows, the last cut
             to TRAIN_RAGGED_LEN so that the ranks' label counts differ, and
             the same for the MDiT (2 DiT and 2 CLIP layers); then `main
             ArAE --dp_size 2` itself in the ranks (full width, 2 decoder
             layers, a folder of 10 procedural meshes, one epoch, then
             --resume_train_state for a second): each rank's items disjoint
             and equal in count, each checkpoint written once, launches held
             per step, equal parameters, the resumed run at the saved step.
             Then the decode fleet: two replicas of the generate phase's
             model on the card, two threads and two streams, 12 rows, 256
             tokens, each replica's rows bit-identical to their one-device
             decode, A and B launched exactly, tokens/s beside one device's;
             infer's fleet path (`generate_meshes` over [dev, dev], 3
             repeats in groups of 2, the last alone) bit-identical to one
             device row by row; and the engine fleet: `build_server` with
             --dp_size 2 on the card twice, 4 concurrent HTTP requests
             answered by both engines.
15. dit      image to mesh at full width (CLIP ViT-H/14, 32 x 1280; the DiT,
             24 x 1024, 16 heads; latents 2048 x 64; the ArAE LMM in
             point_latent mode), random weights from seed 0, one 512 x 512
             image rendered from a procedural mesh's points: infer_dit's
             DDIM run as the CLI runs it (f32, 100 steps, guidance 7.5, 2
             repeat): CLIP ms, DDIM s and ms per step, kernel
             A's launches held to exactly 2 x 24 x 100 = 4,800, latents
             finite; then the f32 decode (1000 faces, a DIT_BUDGET-token
             budget cut for time, EOS forbidden), tokens/s,
             row 0 written as an .obj; peak memory; one profiled DDIM step.
             Then the server in pipeline mode (`build_server(pipeline=True)`,
             bf16 LMM, f32 MDiT): /healthz, two /generate_image requests of
             [224][224][3] floats at 10 and 20 faces (each answered with
             ddim_s), one latent /generate, one malformed image answered 400.
16. dit_parity  2 DiT and 2 CLIP layers at full width in f32 (TF32 off):
             the kernel path's image condition and latents after a 10-step
             DDIM run against the plain path's from the same noise; then a
             2-layer full-width point_latent LMM decodes greedily from those
             latents, both paths choosing the same token at every step whose
             plain top-2 gap is at least NEAR_TIE.
17. dit_train  DiT training as `python -m edgerunner_tpu_torch.main_dit DiT`
             runs it, full width (CLIP ViT-H/14 and the point encoder over
             8192 points frozen; the DiT 24 x 1024, 16 heads), random weights
             from seed 0, batch 8 (the preset's), bf16 autocast,
             checkpointing, --synthetic_size 40 for one epoch in a temporary
             workspace that is deleted afterwards: s/it and samples/s over
             four timed steps after one warm-up, peak memory, each step's
             launches held to kernel A 97 and kernel C 48, frozen parameters
             bit-unchanged and every trainable one moved; the saved checkpoint
             loads strictly through load_mdit and samples finite latents in a
             2-step DDIM run; one profiled step (device time by kernel and by
             kind: A, C, GEMMs, the rest, and the optimizer's from CUDA
             events); then two timed steps at batch 32, bench.py's
             dit_train_probe batch.
18. dit_train_parity  2 DiT and 2 CLIP layers at full width in f32 (TF32
             off): the training loss and every trainable gradient of the
             kernel path against the plain path, from the same draws.
19. image    the image-conditioned ArAE (the default preset: CLIP ViT-H/14,
             257 condition tokens, the decoder 24 x 1024 with 16 heads of
             64) as `infer default` runs it, bf16, random weights from seed
             0, 12 rows of a 512 x 512 render, 1000 faces, EOS forbidden, a
             1024-token budget (cut for time from the CLI's 5120): CLIP ms
             per image, prefill s, tokens/s, ms per step, device ms per step
             (a profiled segment), peak memory; launches held exactly (A 24
             in the prefill, B 24 per decode step); then infer's own path
             after the image's read writes a .ply.
20. image_parity  2 decoder and 2 CLIP layers at full width in f32 (TF32
             off): the kernel path's greedy streams of two images against
             the plain path's up to near-ties (512 steps), and one training
             step's loss and gradients; no gradient reaches the frozen tower.
21. image_train  `main default` as the CLI runs it, full width, batch 4,
             bf16 autocast, checkpointing, synthetic meshes with point-splat
             renders for one epoch in a temporary workspace: launches per
             step held to A 48 and C 24, the tower bit-unchanged, every
             trainable tensor moved, the checkpoint reloaded strictly and
             equal; then timed steps at 4 x 4355 positions (s/it, tokens/s,
             peak memory, busy share).

Then one JSON line with every kernel's numbers, the card's name and power
limit from nvidia-smi, and last the result line. Exits non-zero, printing
no result line, without a CUDA device, without the repository beside this
file, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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
SERVE_ROWS = 8           # the README's serve command: --test_batch_size 8
FACES = 1000
PARITY_STEPS = 512       # asked of the parity phases; ArAE's decode bucket makes it 1024
TRAIN_ROWS = 2           # bench.py's train probe: batch 2 ...
TRAIN_MESH_TOKENS = 4096  # ... of BOS + 4096 mesh tokens + EOS after the condition
TRAIN_RAGGED_LEN = 5000  # a shorter second row for the kernels' ragged train cases
TRAIN_STEPS = 3          # timed training steps after one warm-up step
TRAIN_F32_STEPS = 2      # train phase: steps at --mixed_precision no, launches held per step
SP_TRAIN_STEPS = 2       # sp phase: timed steps after one warm-up step (three in all)
GRAD_TOL = 2e-2          # train parity: gradient error over the tensor's largest value
PHASES = ("build", "kernels", "generate", "generate_q8", "generate_q4", "parity", "parity_q4",
          "serve", "serve_parity", "spec", "train", "train_parity", "sp", "dp", "dit",
          "dit_parity", "dit_train", "dit_train_parity", "image", "image_parity", "image_train")
CUT_BUCKET = 512         # the decode bucket of the paths whose budget is cut below the
                         # ArAE's 1024-token bucket, for the run's time on the card
Q8_BUDGET = 512          # generate_q8: a shorter budget than the bf16 generate phase, for
                         # time (the int8 path's decode is checked, not its length)
Q4_ROWS = 40             # bench.py's quant_fast probe: int4 KV + int8 weights at batch 40 ...
Q4_FULL_BUDGET = 4096    # ... and the headline's 4096-token budget (bench.py:464-469)
Q4_BUDGET = 512          # generate_q4: that budget cut for time
PARITY_CUT_STEPS = 512   # parity_q4 and spec's parity: steps, in CUT_BUCKET for time
SERVE_FACES = (100, 200)  # the HTTP requests' face counts (budgets 1024 and 2048 tokens)
SERVE_HTTP_REQUESTS = 10  # 8 at once, 2 more while they decode
SERVE_BENCH_REQUESTS = 8  # into SERVE_ROWS slots (one wave, cut from two for the sp
                          # phase's time), EOS forbidden ...
SERVE_BENCH_FACES = 80     # ... 512 tokens each in the serve phase's CUT_BUCKET (cut
                           # from 1024 for the run's time; the cache stays 7680 rows)
SERVE_BENCH_Q8_REQUESTS = 8  # one wave: the int8 + w_quant engine is slower
SERVE_BENCH_Q4_REQUESTS = 8  # one wave over the int4 cache (--kv_quant true --kv_bits 4)
SPEC_HEADS = 2           # --mtp_heads 2 --spec_decode true: verify passes at T = 3
MTP_STD = 0.02           # the random draft heads' weights (the init's std)
SPEC_ROWS = ROWS         # spec generate: the headline batch ...
SPEC_BUDGET = 1024       # ... and a budget cut for time (one decode bucket)
PROFILE_STEPS = 8        # decode steps in a profiled segment (engine: cut from 16 for the sp
                         # phase's time: the profiler's processing grows with them)
SERVE_PARITY_FACES = (10, 20, 10, 20, 10, 20)  # 6 staggered requests into 4 slots
SERVE_PARITY_BUCKET = 128
NEAR_TIE = 1e-3          # plain top-2 logit gap under which a flip is allowed
SP_RING_RANKS = (2, 4)   # sp phase: groups of ranks sharing the card, the ring at full width
SP_TRAIN_RANKS = 2       # ... and the one that also takes the full-width training step
SP_DP_SP = (2, 2)        # ... and with 4 ranks the dp x sp f32 parity (dp 2 of sp 2)
DP_RANKS = 2             # dp phase: dp ranks sharing the card, TRAIN_ROWS rows each ...
DP_TRAIN_STEPS = 2       # ... timed steps after one warm-up step (three in all)
DP_MAIN_MESHES = 10      # ... then main under dp on procedural meshes, 2 held out, shards of 4 ...
DP_MAIN_LAYERS = 2       # ... at full width, the decoder cut to 2 layers for time
FLEET_BUDGET = 256       # dp phase: the fleets' budget and decode bucket (the generate
                         # phase's rows), cut from 512 for the phase's time
FLEET_REQUESTS = 4       # dp phase: concurrent HTTP requests to the engine fleet ...
FLEET_FACES = 10         # ... of 10 faces (a 256-token budget), EOS allowed
FLEET_INFER_REPEATS = 3  # dp phase: infer's fleet, 3 repeats in groups of 2 (the last alone)
DIT_REPEATS = 1          # dit: one DDIM run of infer_dit's, test_batch_size 1 (the
                         # device-bound DDIM loop takes ~10 s a repeat) ...
DIT_BUDGET = 512         # ... and its decode at 1000 faces, the budget cut for time
                         # (the CLI's is 6144 tokens)
DIT_SERVE_FACES = (10, 20)  # dit: the pipeline server's two image requests
DIT_PARITY_STEPS = 10    # dit_parity: a 10-step DDIM schedule ...
DIT_PARITY_REPEATS = 2   # ... of 2 repeats
LATENT_TOL = 1e-3        # dit_parity: latents' error over their largest value
DIT_TRAIN_ROWS = 8       # dit_train: the DiT preset's batch ...
DIT_TRAIN_SAMPLES = 40   # ... over --synthetic_size 40: one warm-up and four timed steps
DIT_PROBE_ROWS = 32      # ... then bench.py's dit_train_probe batch ...
DIT_PROBE_STEPS = 2      # ... for two timed steps
DIT_DDIM_CHECK_STEPS = 2  # the saved checkpoint's DDIM check
DIT_PARITY_ROWS = 2      # dit_train_parity: rows of its batch
IMAGE_BUDGET = 1024      # image: the decode budget at 1000 faces, cut for time from the
                         # CLI's 5120 tokens (the kernels phase times B at the full cache)
IMAGE_CLI_BUDGET = 256   # image: infer's own path on one image, EOS allowed
IMAGE_TRAIN_ROWS = 4     # image_train: the default preset's batch ...
IMAGE_TRAIN_SAMPLES = 16  # ... over --synthetic_size 16: one warm-up and three timed steps
IMAGE_PROBE_STEPS = 3    # ... then timed steps at 4 rows of bench.py's train probe rows
IMAGE_RAGGED_LEN = 3000  # the kernels' image training case: every other row cut to this
# shapes that straddle the flash kernels' 64-row tiles (B, N, M, H, D, causal,
# kv_len, q_len), as tests/test_torch_attention.py and
# tests/test_torch_flash_backward.py hold the plain versions at them
TILE_EDGE_CASES = (
    (1, 63, 63, 2, 64, True, None, None),
    (2, 65, 65, 2, 96, True, [65, 30], [65, 30]),      # kv_len in the middle of a tile
    (1, 127, 129, 2, 64, False, None, [100]),          # not square, not causal
    (1, 63, 129, 2, 64, False, None, [50]),
    (2, 127, 127, 1, 96, True, [127, 100], None),
    (2, 129, 129, 1, 96, True, [129, 100], None),
    (1, 191, 65, 2, 96, False, [33], [191]),
    (2, 191, 191, 2, 64, True, [191, 128], [191, 128]),
    (1, 63, 257, 2, 64, False, None, None),            # the DiT's 257 keys: 4 x 64 + 1
)
# instances of the persistent decode kernel: B (bf16, f32 x D 64, 96) and the
# quantised kinds (int8 D 64, 96; int4 pairs D 64, 96; int4 single heads D 32,
# 64, 96; each at 1, 2 and 3 queries per pass) and the bf16/f32 kind (bf16,
# f32 x D 64, 96 x 1, 2 and 3 queries per pass)
DECODE_INSTANCES = 4 + 7 * 3 + 4 * 3
# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# an f32-exact product on the tensor cores: three TF32 products (495 TFLOP/s)
# of split operands for each (3xTF32), as kernel A's f32 instance runs
PEAK_F32_TF32X3 = 495e12 / 3
# tensor-core flash kernels that ptxas must report: the forward's bf16 and
# 3xTF32 instances and the backward's bf16 and 3xTF32 dq and dk/dv kernels,
# each at D 64, 96
MMA_KERNELS = 12


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


def time_ms_device(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` launches queued behind a
    device-side wait (torch.cuda._sleep), so that they run back to back
    whatever the host takes per call: the kernel's own time, where
    `time_ms` of a fast kernel also holds the host's time per launch."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # ~20 ms at the card's clock: the host queues every launch
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_FLUSH = []


def time_ms_l2_flushed(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` runs, each after a write of
    64 MiB (more than the card's 50 MB L2), from CUDA events around fn
    alone: the time a launch takes when the other layers' caches have
    evicted its inputs, as in a decode step."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda"))
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        _FLUSH[0].fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


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
    # the tensor-core flash kernels and the persistent decode kernels hold
    # their accumulators in registers: a spill to local memory is a fault of
    # the build, not a slow path
    fns = _build.build_info.get("functions", [])
    mma = [f for f in fns if "_mma_kernel" in f["name"]]
    decode = [f for f in fns if "decode_kernel" in f["name"]]
    return {"seconds": time.perf_counter() - t0, "library": os.path.relpath(lib._name, HERE),
            "nvcc_seconds": _build.build_info.get("seconds"),
            "ptxas": _build.build_info.get("ptxas", []), "mma_kernels": mma,
            "decode_kernels": decode,
            "ok": (len(mma) == MMA_KERNELS and len(decode) == DECODE_INSTANCES
                   and all(f.get("spill_stores") == 0 for f in mma + decode))}


def attention_pairs(B, N, M, causal, q_len=None, kv_len=None) -> int:
    """(query, key) pairs that these inputs need: for each row, the queries
    before q_len times their unmasked keys (causal: the lower triangle)."""
    total = 0
    for b in range(B):
        n = N if q_len is None else min(q_len[b], N)
        m = M if kv_len is None else min(kv_len[b], M)
        total += sum(min(i + 1, m) for i in range(n)) if causal else n * m
    return total


def bound(flops, nbytes, dtype, peak_flops=None) -> dict:
    bounds = {"operations": flops / (peak_flops or PEAK_FLOPS[dtype]),
              "bytes": nbytes / PEAK_BYTES_PER_S}
    by = max(bounds, key=bounds.get)
    return {"bound_by": by, "bound_ms": bounds[by] * 1e3, "flops": flops, "bytes": nbytes}


def flash_bound(flops, nbytes, dtype) -> dict:
    """`bound` of a flash kernel: f32 at the card's f32-exact rate on the
    tensor cores (3xTF32), whatever unit the kernel runs on, with the CUDA
    cores' bound beside it."""
    if dtype == torch.float32:
        return {**bound(flops, nbytes, dtype, PEAK_F32_TF32X3),
                "bound_ms_cuda_cores": bound(flops, nbytes, dtype)["bound_ms"]}
    return bound(flops, nbytes, dtype)


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
        res.update(flash_bound(flops, nbytes, dtype))
    return res


def tf32_diagnostic(dev, B, N, M, H, D, scale=3.0) -> dict:
    """Why kernel A's f32 instance splits its operands: on inputs scaled so
    that the logits span tens, the plain version run with TF32 matmuls
    fails the f32 tolerance rule against itself with TF32 off, where the
    3xTF32 kernel passes it."""
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    _, q, k, v, kw = attention_inputs(dev, B, N, M, H, D, False, torch.float32, None, None)
    q, k = q * scale, k * scale
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        ref, _ = flash_attention_reference(q, k, v, **kw)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32, _ = flash_attention_reference(q, k, v, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    out, _ = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    logits = torch.einsum("bnhd,bmhd->bhnm", q[:, :256], k) / D ** 0.5
    kernel, plain_tf32 = compare(out, ref, torch.float32), compare(tf32, ref, torch.float32)
    return {"shape": [B, N, M, H, D], "qk_scale": scale,
            "logits_range_first_256_rows": [logits.min().item(), logits.max().item()],
            "kernel": kernel, "plain_tf32": plain_tf32,
            "ok": kernel["ok"] and not plain_tf32["ok"]}


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
        res.update(flash_bound(flops, nbytes, dtype))
    return res


def lse_library_call(q, k, v, causal):
    """One PyTorch call that returns the output and its logsumexp, on
    [B, H, N, D] views: the flash kernel of scaled_dot_product_attention for
    bf16, the memory-efficient one for f32 (the flash kernel takes half
    types only). A yardstick: the port never calls it."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.dtype == torch.bfloat16:
        name = "aten._scaled_dot_product_flash_attention"
        return name, lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal)
    name = "aten._scaled_dot_product_efficient_attention"
    return name, lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        qt, kt, vt, None, True, 0.0, causal)


def flash_lse_case(dev, B, S, H, D, causal, dtype, timed=False):
    """Row 5 at a ring block's shape [B, S, H, D]: `flash_attention_lse` and
    its backward with a non-zero lse cotangent against their plain versions
    on the same inputs (o and lse from the forward kernel feed both
    backwards)."""
    from edgerunner_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference,
        flash_attention_lse,
        flash_attention_lse_bwd,
        flash_attention_reference,
    )

    g, q, k, v, _ = attention_inputs(dev, B, S, S, H, D, causal, dtype, None, None)
    do = torch.randn((B, S, H, D), device=dev, generator=g).to(dtype)
    dlse = torch.randn((B, S, H), device=dev, generator=g)
    o, lse = flash_attention_lse(q, k, v, causal=causal)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    res = {"shape": [B, S, S, H, D], "causal": causal, "dtype": str(dtype).split(".")[-1],
           "out": compare(o, ref, dtype)}
    del ref
    lse_err = (lse - ref_lse).abs().max().item()
    res.update(lse_max_abs_err=lse_err, lse_tolerance=1e-3)
    grads = flash_attention_lse_bwd(q, k, v, o, lse, do, dlse, causal=causal)
    refs = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal, dlse=dlse)
    torch.cuda.synchronize()
    checks = {name: compare(a, b, dtype) for name, a, b in zip(("dq", "dk", "dv"), grads, refs)}
    res.update(checks)
    del grads, refs
    res["max_abs_err"] = max(c["max_abs_err"] for c in (res["out"], *checks.values()))
    res["ok"] = res["out"]["ok"] and lse_err <= 1e-3 and all(c["ok"] for c in checks.values())
    if timed:
        res["ms"] = time_ms(lambda: flash_attention_lse(q, k, v, causal=causal), 5)
        res["plain_ms"] = time_ms(lambda: flash_attention_reference(q, k, v, causal=causal), 2)
        res["library"], call = lse_library_call(q, k, v, causal)
        try:
            res["library_ms"] = time_ms(call, 5)
        except RuntimeError as exc:  # a library kernel that refuses the shape: no yardstick
            res["library_ms"], res["library_refused"] = None, str(exc)[:300]
        pairs = attention_pairs(B, S, S, causal)
        res.update(flash_bound(4.0 * H * D * pairs,
                               4 * q.numel() * q.element_size() + lse.numel() * 4, dtype))
        bwd = {"ms": time_ms(lambda: flash_attention_lse_bwd(
            q, k, v, o, lse, do, dlse, causal=causal), 3)}
        bwd["plain_ms"] = time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=causal, dlse=dlse), 1)
        if dtype == torch.bfloat16:
            import torch.nn.functional as F

            # the yardstick of the backward: SDPA's, at the same shape (no lse cotangent)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            dot = do.transpose(1, 2)
            bwd["library"] = "scaled_dot_product_attention backward"
            bwd["library_ms"] = time_ms(
                lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 3)
            del out
        else:
            bwd["library_ms"] = None
        bwd.update(flash_bound(10.0 * H * D * pairs, (4 * q.numel() + 4 * k.numel())
                               * q.element_size() + 2 * lse.numel() * 4, dtype))
        res["bwd"] = bwd
    return res


def decode_case(dev, B, L, hidden, H, index, dtype, timed=False):
    """Kernel B against its plain version: `index` a host int, a list of
    per-row positions (a tensor made from it), or a tensor on the device."""
    from edgerunner_tpu_torch.ops.decode_attention import (
        fused_decode_attention,
        fused_decode_attention_reference,
    )

    pos = torch.tensor(index, dtype=torch.int32, device=dev) if isinstance(index, list) else index
    starts = pos.tolist() if isinstance(pos, torch.Tensor) else [pos] * B
    g = torch.Generator(device=dev).manual_seed(max(starts) + L)
    kc, vc = (torch.randn(B, L, hidden, device=dev, generator=g).to(dtype) for _ in range(2))
    q = torch.randn(B, hidden, device=dev, generator=g).to(dtype)
    out = fused_decode_attention(q, kc, vc, pos, num_heads=H)
    ref = fused_decode_attention_reference(q, kc, vc, pos, num_heads=H)
    torch.cuda.synchronize()
    res = {"shape": [B, L, hidden], "heads": H,
           "index": starts if isinstance(pos, torch.Tensor) else pos,
           "index_kind": "device tensor" if isinstance(pos, torch.Tensor) else "host int",
           "dtype": str(dtype).split(".")[-1], **compare(out, ref, dtype)}
    if timed:
        import torch.nn.functional as F

        D, n = hidden // H, max(starts) + 1
        res["ms"] = time_ms(lambda: fused_decode_attention(q, kc, vc, pos, num_heads=H), 50, 3)
        res["ms_device"] = time_ms_device(
            lambda: fused_decode_attention(q, kc, vc, pos, num_heads=H), 50)
        res["ms_l2_flushed"] = time_ms_l2_flushed(
            lambda: fused_decode_attention(q, kc, vc, pos, num_heads=H), 20)
        res["plain_ms"] = time_ms(
            lambda: fused_decode_attention_reference(q, kc, vc, pos, num_heads=H), 20, 2)
        # the yardstick at one position for every row (SDPA over the prefix)
        qh = q.reshape(B, 1, H, D).transpose(1, 2)
        kh = kc[:, :n].reshape(B, n, H, D).transpose(1, 2)
        vh = vc[:, :n].reshape(B, n, H, D).transpose(1, 2)
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 50, 3)
        # rows [0, index[b]] of both caches, q and out, once each, and the positions
        rows = sum(i + 1 for i in starts)
        nbytes = (2 * rows * hidden + 2 * B * hidden) * q.element_size() + 4 * B
        res.update(bound(4.0 * rows * hidden, nbytes, dtype))
    return res


ENGINE_ADMITTED = 2050    # a freshly admitted engine row's position (prompt 2050 rows)


def engine_indices(L: int, T: int) -> list:
    """Per-row positions of the engine-shape cases: 7 spread over [2050,
    7000] (a freshly admitted row sits at 2050) and one at L - T, the last
    position a verify pass may start at."""
    return [int(i) for i in np.linspace(ENGINE_ADMITTED, 7000, 7)] + [L - T]


def multi_inputs(dev, kind, B, L, hidden, T, seed, group=0):
    """q [B, T, hidden] and the caches of one kind: bf16 or f32 K and V, or
    the int8 or int4 values and their bf16 scale plane quantised from rows of
    q's dtype (bf16, or f32 for the kinds "... f32 q"); int4 with per-row
    scales, or `group` lanes per scale."""
    from edgerunner_tpu_torch.ops import kv_quant as KQ

    g = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch.float32 if kind in ("f32", "int8 f32 q", "int4 f32 q") else torch.bfloat16
    q = torch.randn(B, T, hidden, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(B, L, hidden, device=dev, generator=g).to(dtype) for _ in range(2))
    if kind.startswith("int8"):
        (kq, ks), (vq, vs) = KQ.quantize_rows(k), KQ.quantize_rows(v)
        pack = KQ.pack_scales
    elif kind.startswith("int4") and group:
        (kq, ks), (vq, vs) = (KQ.quantize_rows_int4_grouped(x, group) for x in (k, v))
        pack = KQ.pack_scales_grouped
    elif kind.startswith("int4"):
        (kq, ks), (vq, vs) = KQ.quantize_rows_int4(k), KQ.quantize_rows_int4(v)
        pack = KQ.pack_scales
    else:
        return q, (k, v)
    del k, v
    return q, (torch.cat([kq, vq], -1), pack(ks, vs))


def multi_case(dev, kind, B, L, hidden, H, T, indices, timed=False, single=False, group=0):
    """Rows 9 (kind bf16 / f32), 11 (int8), 10 (int4, per-row scales or
    `group` lanes per scale) and, with `single`, 8 (int8) or 7 (int4), one
    query per row and one position for all rows, against their plain
    versions on the same inputs."""
    from edgerunner_tpu_torch.ops import decode_attention as DA

    q, caches = multi_inputs(dev, kind, B, L, hidden, T, seed=L + T + len(indices), group=group)
    q4 = kind.startswith("int4")
    name = {"int8": "q8", "int4": "q4"}.get(kind[:4])
    kw = {"num_heads": H, **({"group": group} if q4 else {})}
    if single:  # the decode step's position vector, built once per step
        q = q[:, 0].contiguous()
        index = torch.full((B,), indices[0], dtype=torch.int32, device=dev)
        kernel = getattr(DA, f"fused_decode_attention_{name}")
    else:
        index = torch.tensor(indices, dtype=torch.int32, device=dev)
        kernel = getattr(DA, "fused_decode_attention_" + (f"{name}_multi" if name else "multi"))
    plain = getattr(DA, kernel.__name__ + "_reference")
    out = kernel(q, *caches, index, **kw)
    ref = plain(q, *caches, index, **kw)
    torch.cuda.synchronize()
    res = {"shape": [B, L, hidden], "heads": H, "T": T, "kind": kind, "group": group,
           "index": indices if not single else indices[0], **compare(out, ref, q.dtype)}
    del ref
    if timed:
        import torch.nn.functional as F

        res["ms"] = time_ms(lambda: kernel(q, *caches, index, **kw), 50, 3)
        res["ms_device"] = time_ms_device(lambda: kernel(q, *caches, index, **kw), 50)
        res["ms_l2_flushed"] = time_ms_l2_flushed(lambda: kernel(q, *caches, index, **kw), 20)
        res["plain_ms"] = time_ms(lambda: plain(q, *caches, index, **kw), 5, 1)
        starts = [indices[0]] * B if single else indices
        rows = sum(i + T for i in starts)  # cache rows [0, index[b] + T) of each row
        pairs = sum(i + t + 1 for i in starts for t in range(T))  # (query, key) pairs
        if name:
            # no one PyTorch call attends over a quantised cache with its scales
            res["library_ms"] = None
            # K and V values (int4: hidden bytes of nibbles), and the plane
            # lanes read: 0 and 1 per row, or G each for K and V when grouped
            row_bytes = (2 * hidden if name == "q8" else hidden) + (
                4 * (hidden // group) if group else 4)
        else:
            D = hidden // H
            last = index[:, None] + torch.arange(T, device=dev)
            mask = torch.arange(L, device=dev)[None, None, None] <= last[:, None, :, None]
            qh = q.reshape(B, T, H, D).transpose(1, 2)
            kh, vh = (c.reshape(B, L, H, D).transpose(1, 2) for c in caches)
            res["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask), 20, 2)
            row_bytes = 2 * hidden * q.element_size()
        # those cache rows once, q and out once, the positions once
        nbytes = rows * row_bytes + 2 * q.numel() * q.element_size() + 4 * B
        res.update(bound(4.0 * hidden * pairs, nbytes, q.dtype))
    return res


def main_path_shapes():
    """Prompt length, new tokens and cache length of the generate phase."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.generate import decode_shape, round_up_bucket

    opt = config_defaults["ArAE"]
    budget = round_up_bucket(min(FACES * 4 + 32, opt.max_seq_length), opt.decode_bucket)
    num_new, max_len = decode_shape(opt, 1, FACES, budget)
    return opt, budget, 1 + opt.num_cond_tokens, num_new, max_len


def image_path_shapes():
    """The default preset (cond_mode 'image') and its decode's shapes at the
    CLI's 1000-face budget: (opt, prompt length: CLIP's 257 tokens and BOS,
    new tokens, cache length, the decode loop's mean position)."""
    from edgerunner_tpu_torch.generate import decode_shape

    opt = image_options()
    num_new, max_len = decode_shape(opt, 1, FACES, None)
    plen = 1 + opt.num_cond_tokens
    return opt, plen, num_new, max_len, plen + num_new // 2


def dit_cond_tokens(opt) -> int:
    """CLIP's tokens, onto which the DiT cross-attends: patches + class."""
    return (opt.clip_image_size // opt.clip_patch_size) ** 2 + 1


def train_positions(opt) -> int:
    """Positions of a training row: condition tokens, BOS, mesh tokens, EOS."""
    return opt.num_cond_tokens + 1 + TRAIN_MESH_TOKENS + 1


def sp_positions(opt) -> int:
    """The train batch's positions padded to a multiple of 2 and of 4 ranks."""
    return -(-train_positions(opt) // 4) * 4


def phase_kernels(dev):
    from edgerunner_tpu_torch.generate import decode_shape

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
    # a causal row without any valid key whose output is kept: it averages
    # V over all M keys, as the plain version does
    flash += [dict(case=f"keyless causal {str(dt).split('.')[-1]}", **flash_case(
        dev, 3, 130, 130, 4, D, True, dt, kv_len=[130, 0, 70], q_len=[130, 130, 70]))
        for dt, D in ((bf, 96), (f32, 64))]
    flash += [dict(case=f"tile edges {n}x{m}", **flash_case(dev, b, n, m, h, d, c, bf, kv_len=kv,
                                                             q_len=ql))
              for b, n, m, h, d, c, kv, ql in TILE_EDGE_CASES]
    # the DiT's attentions in the image pipeline (2R = 2: one image, its
    # unconditioned and conditioned rows): self over the 2048 latents and
    # cross onto CLIP's 257 tokens, f32 as the pipeline runs them, and bf16
    dit_n, dit_m = opt.point_latent_size, dit_cond_tokens(opt)
    dit_h = opt.dit_num_heads
    dit_d = opt.dit_hidden_dim // dit_h
    for dt in (f32, bf):
        name = str(dt).split(".")[-1]
        main = " (main path)" if dt == f32 else ""
        flash += [
            dict(case=f"dit self {name}{main}", **flash_case(
                dev, 2, dit_n, dit_n, dit_h, dit_d, False, dt, timed=True)),
            dict(case=f"dit cross {name}{main}", **flash_case(
                dev, 2, dit_n, dit_m, dit_h, dit_d, False, dt, timed=True)),
            dict(case=f"dit cross ragged {name}", **flash_case(
                dev, 2, dit_n, dit_m, dit_h, dit_d, False, dt, kv_len=[dit_m, 100])),
        ]
    # the DiT training step's attentions at the preset's batch, bf16 under
    # autocast: self over the 2048 latents and cross onto CLIP's 257 tokens
    flash += [dict(case=f"dit train {kind} (main path)", **flash_case(
        dev, DIT_TRAIN_ROWS, dit_n, m, dit_h, dit_d, False, bf, timed=True))
        for kind, m in (("self", dit_n), ("cross", dit_m))]
    # the image-conditioned ArAE (the default preset, 16 heads of 64): the
    # prefill over CLIP's 257 tokens and BOS (258 = 4 x 64 + 2), causal, and
    # the training step's causal self-attention, every other row ragged
    img_opt, img_plen, _, img_L, img_mid = image_path_shapes()
    iH = img_opt.num_heads
    iD = img_opt.hidden_dim // iH
    iT = train_positions(img_opt)
    ilens = [iT, IMAGE_RAGGED_LEN] * (IMAGE_TRAIN_ROWS // 2)
    flash += [
        dict(case="image prefill (main path)", **flash_case(
            dev, ROWS, img_plen, img_plen, iH, iD, True, bf, timed=True)),
        dict(case="image decoder train (main path)", **flash_case(
            dev, IMAGE_TRAIN_ROWS, iT, iT, iH, iD, True, bf, kv_len=ilens, q_len=ilens,
            timed=True)),
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
        # the 3xTF32 f32 instance at the f32 training step's shapes (the train
        # phase's --mixed_precision no steps): 6147 and 8192 keys a row
        dict(case="decoder train float32 (f32 training)", **flash_case(
            dev, TRAIN_ROWS, T, T, H, hd // H, True, f32, kv_len=lens, q_len=lens, timed=True)),
        dict(case="encoder train float32 (f32 training)", **flash_case(
            dev, TRAIN_ROWS, opt.point_latent_size, opt.point_num, pH, ph // pH, False, f32,
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
    flash_bwd += [dict(case=f"dit train {kind} (main path)", **flash_bwd_case(
        dev, DIT_TRAIN_ROWS, dit_n, m, dit_h, dit_d, False, bf, timed=True))
        for kind, m in (("self", dit_n), ("cross", dit_m))]
    flash_bwd += [
        dict(case="image decoder train (main path)", **flash_bwd_case(
            dev, IMAGE_TRAIN_ROWS, iT, iT, iH, iD, True, bf, kv_len=ilens, q_len=ilens,
            timed=True)),
        # the 3xTF32 f32 instance, which the f32 parity phases run (dit_train_parity
        # at the DiT's self-attention shape) and the f32 training step (the
        # train phase's --mixed_precision no steps) at the ArAE's shapes
        dict(case="dit self float32 (parity phases)", **flash_bwd_case(
            dev, 2, dit_n, dit_n, dit_h, dit_d, False, f32, timed=True)),
        dict(case="decoder train float32 (f32 training)", **flash_bwd_case(
            dev, TRAIN_ROWS, T, T, H, hd // H, True, f32, kv_len=lens, q_len=lens, timed=True)),
        dict(case="encoder train float32 (f32 training)", **flash_bwd_case(
            dev, TRAIN_ROWS, opt.point_latent_size, opt.point_num, pH, ph // pH, False, f32,
            timed=True)),
    ]
    flash_bwd += [dict(case=f"keyless causal {str(dt).split('.')[-1]}", **flash_bwd_case(
        dev, 3, 130, 130, 4, D, True, dt, kv_len=[130, 0, 70], q_len=[130, 130, 70]))
        for dt, D in ((bf, 96), (f32, 64))]
    # the tile edges in both dtypes: bf16's 64-row tiles and f32's 32-row
    # streamed tiles
    flash_bwd += [dict(case=f"tile edges {n}x{m} {str(dt).split('.')[-1]}", **flash_bwd_case(
        dev, b, n, m, h, d, c, dt, kv_len=kv, q_len=ql))
        for dt in (bf, f32) for b, n, m, h, d, c, kv, ql in TILE_EDGE_CASES]
    mid = plen + num_new // 2  # the mean position of the decode loop
    decode = [dict(case=f"index {i}", **decode_case(dev, ROWS, L, hd, H, i, bf))
              for i in sorted({0, 255, 256, 257, 511, 512, L - 1}) if i < L]
    # the decode step's position vector, built on the device as the step builds it
    decode.append(dict(case=f"index {mid} (main path, mean position)", **decode_case(
        dev, ROWS, L, hd, H, torch.full((ROWS,), mid, dtype=torch.int32, device=dev), bf,
        timed=True)))
    # per-row positions: the tile and split edges, the last row, the first
    edges = [0, 15, 16, 17, 255, 256, 257, 511, 2050, mid, L - 2, L - 1]
    decode.append(dict(case="per-row positions", **decode_case(
        dev, ROWS, L, hd, H, edges[:ROWS], bf)))
    decode.append(dict(case="per-row positions, vector built on the device", **decode_case(
        dev, ROWS, L, hd, H,
        (torch.arange(ROWS, device=dev, dtype=torch.int32) * 557 + 31) % L, bf)))
    # the image path's decode: 16 heads of 64 over the 1000-face cache
    decode.append(dict(case=f"image index {img_mid} (main path, mean position)", **decode_case(
        dev, ROWS, img_L, img_opt.hidden_dim, iH,
        torch.full((ROWS,), img_mid, dtype=torch.int32, device=dev), bf, timed=True)))
    decode.append(dict(case="f32", **decode_case(dev, 2, 1024, hd, H, 700, f32)))
    decode.append(dict(case="f32 per-row", **decode_case(dev, 3, 1024, hd, H, [5, 700, 1023],
                                                         f32)))
    decode.append(dict(case="d64", **decode_case(dev, 3, 1024, 1024, 16, 300, bf)))
    decode.append(dict(case="d64 f32", **decode_case(dev, 3, 1024, 1024, 16, 1023, f32)))
    decode.append(dict(case="d64 per-row", **decode_case(dev, 3, 1024, 1024, 16, [0, 256, 900],
                                                         bf)))
    # the multi-query kernel: rows 9 and 11 at the serving engine's shape
    # (SERVE_ROWS slots of its cache length), row 8 at the generate path's
    from edgerunner_tpu_torch.serve_engine import engine_shape

    eng_L = engine_shape(opt)[2]
    multi = [dict(case=f"engine {kind} T={T}" + (" (main path)" if T == 1 else ""),
                  **multi_case(dev, kind, SERVE_ROWS, eng_L, hd, H, T,
                               engine_indices(eng_L, T), timed=True))
             for kind in ("bf16", "f32", "int8") for T in (1, 3)]
    # the bf16 kind where the serve phase profiles the engine: every slot
    # just admitted (the 2049-token prompt and BOS, position 2050)
    multi += [dict(case=f"engine bf16 T={T} at admission", **multi_case(
        dev, "bf16", SERVE_ROWS, eng_L, hd, H, T, [ENGINE_ADMITTED] * SERVE_ROWS, timed=True))
        for T in (1, 3)]
    multi += [
        dict(case="ragged d64", **multi_case(dev, "bf16", 3, 300, 1024, 16, 5, [0, 255, 295])),
        dict(case="ragged f32 T=8", **multi_case(dev, "f32", 3, 1000, 192, 2, 8, [0, 500, 992])),
        dict(case="ragged int8 d64", **multi_case(dev, "int8", 3, 700, 1024, 16, 2,
                                                  [0, 256, 698])),
        dict(case="ragged int8 f32 q", **multi_case(dev, "int8 f32 q", 2, 520, 192, 2, 4,
                                                    [3, 516])),
        dict(case=f"generate q8 index {mid} (main path, mean position)", **multi_case(
            dev, "int8", ROWS, L, hd, H, 1, [mid], timed=True, single=True)),
        dict(case="generate q8 index 0", **multi_case(dev, "int8", ROWS, L, hd, H, 1, [0],
                                                      single=True)),
    ]
    # the int4 kind: rows 10 and 7 at the engine's shape, per-row and one
    # scale per head (group 96); row 7 at the quant_fast generate shape (40
    # rows of bench.py's 4096-token cache at its mean position); f32 queries;
    # a head straddling the nibble halves (3 heads of 32: hidden/2 = 48);
    # groups that are not the head dim, one of which splits an 8-lane load
    q4_mid = plen + Q4_FULL_BUDGET // 2
    q4_L = decode_shape(opt, 1, FACES, Q4_FULL_BUDGET)[1]
    multi += [dict(case=f"engine int4{' g96' if grp else ''} T={T}"
                   + (" (main path)" if T == 1 else ""),
                   **multi_case(dev, "int4", SERVE_ROWS, eng_L, hd, H, T,
                                engine_indices(eng_L, T), timed=True, group=grp))
              for grp in (0, hd // H) for T in (1, 3)]
    multi += [
        dict(case=f"generate q4 index {q4_mid} (main path, mean position)", **multi_case(
            dev, "int4", Q4_ROWS, q4_L, hd, H, 1, [q4_mid], timed=True, single=True)),
        dict(case=f"generate q4 g96 index {q4_mid}", **multi_case(
            dev, "int4", Q4_ROWS, q4_L, hd, H, 1, [q4_mid], single=True, group=hd // H)),
        dict(case="generate q4 index 0", **multi_case(dev, "int4", Q4_ROWS, q4_L, hd, H, 1,
                                                      [0], single=True)),
        dict(case="int4 f32 q T=3", **multi_case(dev, "int4 f32 q", 3, 1000, hd, H, 3,
                                                 [0, 500, 997])),
        dict(case="int4 f32 q g96 T=1", **multi_case(dev, "int4 f32 q", 2, 520, hd, H, 1,
                                                     [7, 519], group=hd // H)),
        dict(case="int4 straddling 3x32 T=2", **multi_case(dev, "int4", 3, 300, 96, 3, 2,
                                                           [0, 150, 298])),
        dict(case="int4 straddling 3x32 g12 f32 q T=1", **multi_case(
            dev, "int4 f32 q", 3, 300, 96, 3, 1, [1, 255, 299], group=12)),
        dict(case="int4 ragged d64 g32 T=5", **multi_case(dev, "int4", 3, 700, 1024, 16, 5,
                                                          [0, 256, 695], group=32)),
        # the paired int4 items and int8 at the most queries (three passes)
        dict(case="int4 paired T=8", **multi_case(dev, "int4", 3, 1000, hd, H, 8,
                                                  [0, 15, 992])),
        dict(case="int4 paired g96 f32 q T=8", **multi_case(dev, "int4 f32 q", 2, 700, hd, H, 8,
                                                            [300, 692], group=hd // H)),
        dict(case="int8 T=8", **multi_case(dev, "int8", 3, 1000, hd, H, 8, [0, 17, 992])),
        dict(case="int8 f32 q T=4", **multi_case(dev, "int8 f32 q", 2, 520, hd, H, 4,
                                                 [255, 516])),
        dict(case="int4 straddling 3x32 T=8", **multi_case(dev, "int4", 2, 300, 96, 3, 8,
                                                           [16, 292])),
    ]
    # the bf16/f32 kind at every T (one, two and three passes of up to three
    # queries), both dtypes and head dims (3 heads of 64: a gang of four
    # heads with one missing), at index 0, the 16-row (bf16) and 8-row (f32)
    # tiles' and the old 256-row chunks' edges, and the cache's last rows
    multi += [dict(case=f"{kind} d{D} T={T}", **multi_case(
        dev, kind, 4, 520, 3 * D if D == 64 else 2 * D, 3 if D == 64 else 2, T,
        [0, 255, 256, 520 - T]))
        for kind in ("bf16", "f32") for D in (64, 96) for T in range(1, 9)]
    # row 5 at the ring's blocks of the train batch padded for R ranks: the
    # causal diagonal and the full off-diagonal blocks
    flash_lse = []
    for dtype in (bf, f32):
        for R, causal in ((2, False), (2, True), (4, False)):
            S = sp_positions(opt) // R
            flash_lse.append(dict(
                case=f"ring R={R} {'diagonal' if causal else 'off-diagonal'} "
                     f"{str(dtype).split('.')[-1]}" + (" (main path)" if R == 2 and not causal
                                                       and dtype == bf else ""),
                **flash_lse_case(dev, TRAIN_ROWS, S, H, hd // H, causal, dtype,
                                 timed=dtype == bf)))
    flash_lse.append(dict(case="ragged 77 d64 causal f32",
                          **flash_lse_case(dev, 3, 77, 2, 64, True, f32)))
    # the 3xTF32 split at the DiT's self-attention shape, against TF32 alone
    diag = tf32_diagnostic(dev, 2, dit_n, dit_n, dit_h, dit_d)
    print(f"tf32 diagnostic {diag['shape']}, q and k x {diag['qk_scale']}: kernel "
          f"max_abs_err {diag['kernel']['max_abs_err']:.3g} "
          f"({'passes' if diag['kernel']['ok'] else 'FAILS'}), plain with TF32 matmuls "
          f"max_abs_err {diag['plain_tf32']['max_abs_err']:.3g} "
          f"({'passes' if diag['plain_tf32']['ok'] else 'fails'}), "
          f"{diag['kernel']['tolerance']}", flush=True)
    ok = all(c["ok"] for c in flash + flash_bwd + decode + multi + flash_lse) and diag["ok"]
    return {"ok": ok, "flash": flash, "flash_bwd": flash_bwd, "decode": decode,
            "decode_multi": multi, "flash_lse": flash_lse, "tf32_diagnostic": diag}


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


def profile_decode(model, opt, dev, points, max_len, index, steps=PROFILE_STEPS):
    """Device busy share and device time by kernel over `steps` decode steps
    of a generate path (one row per point cloud) from position `index` on
    (torch.profiler's CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    rows = len(points)
    nf = torch.full((rows,), FACES, device=dev)
    prompt = torch.full((rows, 1), opt.bos_token_id, device=dev)
    with torch.no_grad():
        _, caches, _ = model.prefill(torch.tensor(points, device=dev), nf, prompt, max_len)
        ids = torch.full((rows, 1), 5, device=dev)
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
    return parity_run(dev, PARITY_STEPS)


def phase_parity_q4(dev):
    """`parity_run` over the int4 KV cache in three variants: per-row scales,
    one scale per head (kv_group 96 at hidden 1536) and rotated rows."""
    runs = {name: parity_run(dev, PARITY_CUT_STEPS, kv_quant=True, kv_bits=4,
                             decode_bucket=CUT_BUCKET, **changes)
            for name, changes in (("per-row", {}), ("kv_group 96", {"kv_group": 96}),
                                  ("kv_rotate", {"kv_rotate": True}))}
    return {"ok": all(r["ok"] for r in runs.values()), **runs}


def parity_run(dev, steps, conds=None, preset="ArAE", **changes):
    """Kernel path against plain path, 2 layers at full width in f32: both
    models generate their own greedy streams through `generate_tokens`; a
    lockstep replay on the plain stream's tokens reads the plain logits'
    top-2 gap and both paths' choices at every step. The streams must agree
    up to the first step whose gap is under NEAR_TIE, the paths may choose
    differently only at such steps, and the logits may differ by less than
    1e-2 (f32 sums in another order differ by ~1e-5). `changes` set options
    (the KV cache's kind, the condition mode) of `preset`; `conds` are the
    rows' conditions (2 point clouds from a seed when None)."""
    from edgerunner_tpu_torch.config import config_defaults, vocab_size_for
    from edgerunner_tpu_torch.generate import decode_shape, generate_tokens
    from edgerunner_tpu_torch.ops import sampling as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = dataclasses.replace(config_defaults[preset], num_layers=2, generate_mode="greedy",
                              **changes)
    kernel = build_model(opt, dev, torch.float32, SEED + 1)
    plain = build_model(opt, dev, torch.float32, SEED + 1, use_kernels=False)
    rows = 2 if conds is None else len(conds)
    points = (np.random.default_rng(SEED + 1).normal(size=(rows, opt.point_num, 3)).astype(
        np.float32) if conds is None else conds)
    kw = dict(num_faces=FACES, max_new_tokens=steps, bench_no_eos=True)
    stream_k = generate_tokens(kernel, points, **kw)
    stream_p = generate_tokens(plain, points, **kw)
    steps, max_len = decode_shape(opt, 1, FACES, steps)

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
    return {"ok": ok, "preset": preset, "options": changes, "layers": 2, "rows": rows,
            "steps": steps,
            "dtype": "float32",
            "tf32": False, "near_tie": NEAR_TIE,
            "streams_identical": bool(np.array_equal(stream_k, stream_p)),
            "first_mismatch": first,
            "plain_stream_replayed_exactly": bool(np.array_equal(replay, stream_p)),
            "steps_under_near_tie": int((gaps < NEAR_TIE).sum()),
            "flips": int(flips.sum()),
            "flips_above_near_tie": int((flips & (gaps >= NEAR_TIE)).sum()),
            "min_gap": float(gaps.min()), "logits_max_abs_diff": max_diff}


def timed_generate(model, opt, dev, rows, budget) -> dict:
    """One warm-up prefill and the prefill's time, then one `generate_tokens`
    call of `rows` rows, 1000 faces, `budget` tokens, EOS forbidden, with
    the forward kernel's and every decode kernel's launch count zeroed just
    before and read just after (speculative passes recorded too)."""
    from edgerunner_tpu_torch.generate import generate_tokens
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention

    points = np.random.default_rng(SEED).normal(size=(rows, opt.point_num, 3)).astype(
        np.float32)
    nf = torch.full((rows,), FACES, device=dev)
    prompt = torch.full((rows, 1), opt.bos_token_id, device=dev)
    max_len = decode_shape_of(opt, budget)[1]
    with torch.no_grad():  # warm-up, then the prefill's time
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(torch.tensor(points, device=dev), nf, prompt, max_len)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for fn in (flash_attention, *decode_wrappers()):
        fn.launches = 0
    with recorded_passes() as passes:
        t1 = time.perf_counter()
        tokens = generate_tokens(model, points, num_faces=FACES, max_new_tokens=budget,
                                 bench_no_eos=True)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t1
    return {"tokens": tokens, "points": points, "max_len": max_len, "prefill_s": prefill_s,
            "generate_s": gen_s, "tokens_per_s": tokens.size / gen_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "passes": passes,
            "launches": {"flash_attention_fwd": flash_attention.launches,
                         **{fn.__name__: fn.launches for fn in decode_wrappers()}}}


def decode_shape_of(opt, budget) -> tuple:
    """(new tokens, cache length) of a generate phase's 1000-face call."""
    from edgerunner_tpu_torch.generate import decode_shape

    return decode_shape(opt, 1, FACES, budget)


def expected_launches(opt, kernel, calls) -> dict:
    """Exact launch counts of a decode path: the forward kernel once per
    layer and the encoder, `kernel` once per layer and decode call, no other
    decode kernel."""
    want = {fn.__name__: 0 for fn in decode_wrappers()}
    want.update({"flash_attention_fwd": opt.num_layers + 1,
                 kernel.__name__: opt.num_layers * calls})
    return want


def phase_generate_q8(dev):
    """The generate path over the int8 KV cache (--kv_quant true): full
    width, bf16, 12 rows, Q8_BUDGET tokens with EOS forbidden. Each decode
    step launches the int8 kernel once per layer: exactly 24 x (steps - 1).
    Then the device time by kernel over PROFILE_STEPS steps at the budget's mean
    position."""
    from edgerunner_tpu_torch.ops import decode_attention as DA

    opt, *_ = main_path_shapes()
    opt = dataclasses.replace(opt, generate_mode="greedy", kv_quant=True,
                              decode_bucket=CUT_BUCKET)
    num_new = decode_shape_of(opt, Q8_BUDGET)[0]
    model = build_model(opt, dev, torch.bfloat16, SEED)
    run = timed_generate(model, opt, dev, ROWS, Q8_BUDGET)
    tokens, points = run.pop("tokens"), run.pop("points")
    want = expected_launches(opt, DA.fused_decode_attention_q8, num_new - 1)
    ok = (tokens.shape == (ROWS, num_new) and run["launches"] == want
          and not (tokens == 0).any() and not (tokens == 2).any())
    res = {"ok": ok, "rows": ROWS, "num_faces": FACES, "num_new": num_new,
           "max_len": run["max_len"], "layers": opt.num_layers, "hidden": opt.hidden_dim,
           "dtype": "bfloat16", "kv_cache": "int8", "prefill_s": run["prefill_s"],
           "generate_s": run["generate_s"],
           "ms_per_step": (run["generate_s"] - run["prefill_s"]) / (num_new - 1) * 1e3,
           "tokens_per_s": run["tokens_per_s"], "peak_mem_gib": run["peak_mem_gib"],
           "launches": run["launches"], "launches_expected": want, "card": card_line()}
    res.update(profile_decode(model, opt, dev, points, run["max_len"],
                              1 + opt.num_cond_tokens + num_new // 2))
    res["ok"] = ok and res["device_ms_per_step"] > 0
    return res


def phase_generate_q4(dev):
    """bench.py's quant_fast configuration (bench.py:464-469): full width,
    bf16, --kv_quant true --kv_bits 4 --w_quant true, Q4_ROWS rows, 1000
    faces, greedy with EOS forbidden, a Q4_BUDGET-token budget (cut from its
    4096 for time). Each decode step launches row 7's kernel once per layer
    and no other decode kernel: exactly 24 x (steps - 1). Then the device
    time by kernel over PROFILE_STEPS steps at the budget's mean position."""
    from edgerunner_tpu_torch.infer import load_model
    from edgerunner_tpu_torch.ops import decode_attention as DA

    opt, *_ = main_path_shapes()
    opt = dataclasses.replace(opt, generate_mode="greedy", kv_quant=True, kv_bits=4,
                              w_quant=True, decode_bucket=CUT_BUCKET)
    num_new = decode_shape_of(opt, Q4_BUDGET)[0]
    model = load_model(opt, dev)
    run = timed_generate(model, opt, dev, Q4_ROWS, Q4_BUDGET)
    tokens, points = run.pop("tokens"), run.pop("points")
    want = expected_launches(opt, DA.fused_decode_attention_q4, num_new - 1)
    ok = (tokens.shape == (Q4_ROWS, num_new) and run["launches"] == want
          and not (tokens == 0).any() and not (tokens == 2).any())
    res = {"ok": ok, "rows": Q4_ROWS, "num_faces": FACES, "num_new": num_new,
           "max_len": run["max_len"], "layers": opt.num_layers, "hidden": opt.hidden_dim,
           "dtype": "bfloat16", "kv_cache": "int4", "w_quant": True,
           "prefill_s": run["prefill_s"], "generate_s": run["generate_s"],
           "ms_per_step": (run["generate_s"] - run["prefill_s"]) / (num_new - 1) * 1e3,
           "tokens_per_s": run["tokens_per_s"], "peak_mem_gib": run["peak_mem_gib"],
           "launches": run["launches"], "launches_expected": want, "card": card_line()}
    res.update(profile_decode(model, opt, dev, points, run["max_len"],
                              1 + opt.num_cond_tokens + num_new // 2))
    res["ok"] = ok and res["device_ms_per_step"] > 0
    return res


def decode_wrappers():
    """Every decode kernel's wrapper, whose launch counts a path holds."""
    from edgerunner_tpu_torch.ops import decode_attention as DA

    return (DA.fused_decode_attention, DA.fused_decode_attention_multi,
            DA.fused_decode_attention_q8, DA.fused_decode_attention_q8_multi,
            DA.fused_decode_attention_q4, DA.fused_decode_attention_q4_multi)


def http(port: int, path: str, body=None):
    """(status, JSON answer) of one request to the server on localhost."""
    import urllib.error
    import urllib.request

    data = None if body is None else (body if isinstance(body, bytes) else
                                      json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_http(opt, dev) -> tuple:
    """Start `build_server` on port 0 and send it /healthz, /statz, a
    malformed /generate, and SERVE_HTTP_REQUESTS concurrent /generate
    requests (8 at once, the rest while those decode, so that they are
    admitted mid-flight). Returns (report, the server's model)."""
    import threading

    from edgerunner_tpu_torch.serve import build_server

    t0 = time.perf_counter()
    server, frontend = build_server(opt, port=0, device=str(dev))
    setup_s = time.perf_counter() - t0
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        health, statz0 = http(port, "/healthz"), http(port, "/statz")
        bad = http(port, "/generate", b"{not json")
        rng = np.random.default_rng(SEED)
        bodies = [{"points": rng.normal(size=(3000, 3)).tolist(),
                   "num_faces": SERVE_FACES[i % 2], "seed": i}
                  for i in range(SERVE_HTTP_REQUESTS)]
        answers = [None] * len(bodies)

        def send(i):
            time.sleep(0 if i < SERVE_ROWS else 2.0)
            answers[i] = http(port, "/generate", bodies[i])

        t1 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        http_s = time.perf_counter() - t1
        statz = http(port, "/statz")
    finally:
        server.shutdown()
        server.server_close()
        frontend.shutdown()
        frontend.engine.thread.join()
    keys = {"vertices", "faces", "tokens", "wall_s"}
    stat_keys = {"requests_done", "queue_depth", "slots_busy", "slots_total",
                 "mean_wall_s", "tokens_out", "uptime_s"}
    good = [a is not None and a[0] == 200 and set(a[1]) == keys
            and bool(np.isfinite(np.asarray(a[1]["vertices"], np.float64)).all())
            for a in answers]
    ok = (health == (200, {"ok": True, "cond_mode": "point", "batch": SERVE_ROWS,
                           "pipeline": False})
          and statz0[0] == 200 and set(statz0[1]) == stat_keys and bad[0] == 400
          and all(good) and statz[1]["requests_done"] == len(bodies))
    return {"ok": ok, "setup_s": setup_s, "requests": len(bodies),
            "num_faces": list(SERVE_FACES), "answers_ok": sum(good), "http_s": http_s,
            "tokens": [len(a[1]["tokens"]) for a in answers if a and a[0] == 200],
            "faces": [len(a[1]["faces"]) for a in answers if a and a[0] == 200],
            "malformed_status": bad[0], "statz": statz[1]}, frontend.engine.model


def serve_bench(model, opt, dev, kernel, requests) -> tuple:
    """The engine alone, EOS forbidden: `requests` requests of
    SERVE_BENCH_FACES faces into SERVE_ROWS slots. The kernels' counts are
    zeroed just before and read just after; `kernel` (the wrapper the
    engine's decode goes through) must have run exactly once per layer and
    engine step (a speculative pass under spec decoding), and the others not
    at all. Returns (report, the stopped engine)."""
    import threading

    from edgerunner_tpu_torch.generate import round_up_bucket
    from edgerunner_tpu_torch.serve_engine import ContinuousEngine

    engine = ContinuousEngine(model, opt, batch=SERVE_ROWS, bench_no_eos=True)
    points = serve_points(opt, requests)
    results = [None] * requests
    wrappers = decode_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers:
        fn.launches = 0
    steps0, t0 = engine.steps, time.perf_counter()
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, engine.submit(points[i], SERVE_BENCH_FACES, i))) for i in range(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    steps = engine.steps - steps0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    engine.shutdown()
    engine.thread.join()
    tokens = sum(len(r["tokens"]) for r in results if r)
    expected = {name: (opt.num_layers * steps if name == kernel.__name__ else 0)
                for name in launches}
    budget = round_up_bucket(min(SERVE_BENCH_FACES * 5 + 64, engine.N), opt.decode_bucket)
    ok = (all(r is not None and len(r["tokens"]) == budget for r in results)
          and launches == expected)
    return {"ok": ok, "requests": requests, "slots": SERVE_ROWS, "budget": budget,
            "tokens": tokens, "engine_steps": steps, "wall_s": wall,
            "tokens_per_s": tokens / wall, "ms_per_step": wall / steps * 1e3,
            "peak_mem_gib": peak, "launches": launches,
            "launches_expected": expected}, engine


def serve_points(opt, n):
    return np.random.default_rng(SEED + 5).normal(size=(n, opt.point_num, 3)).astype(
        np.float32)


def profile_segment(engine, dev, ms_per_step, kernel_name) -> dict:
    """Device time by kernel over a decode segment of PROFILE_STEPS steps of
    a stopped engine, driven on this thread (torch.profiler traces the
    kernels of the thread it runs on; run from another thread it read no
    kernels in one run and left that engine's later steps five times slower
    in another): SERVE_ROWS requests admitted, then one profiled segment of
    the engine's own `_segment`, warm from the timed run. The busy share divides
    the device time per step by the timed run's `ms_per_step` (the profiler
    itself slows the host about twofold; the share over the profiled wall
    time is reported too). The profile must show the path's decode kernel,
    `kernel_name` (a part of its full name: the persistent decode kernels
    share the name `decode_kernel` and differ in their kind, `DecodeM<` for
    the bf16/f32 cache, `DecodeQ<` for int8 and int4), and its device ms
    per step is reported."""
    from torch.profiler import ProfilerActivity, profile

    from edgerunner_tpu_torch.serve_engine import Request

    t_start = time.perf_counter()
    points = serve_points(engine.opt, engine.B)
    engine.segment_steps = PROFILE_STEPS
    with torch.inference_mode():
        for slot in range(engine.B):
            engine._admit_one(slot, Request(points[slot], SERVE_BENCH_FACES, slot))
        active = torch.ones(engine.B, dtype=torch.bool, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            s0, t0 = engine.steps, time.perf_counter()
            engine._segment(active)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            steps = engine.steps - s0
    kernels = sorted(((e.key, e.device_time_total / 1e3 / steps)
                      for e in prof.key_averages()
                      if e.device_type.name == "CUDA" and e.device_time_total > 0),
                     key=lambda x: -x[1])
    device_ms = sum(ms for _, ms in kernels)
    return {"profiled_steps": steps, "profiled_wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms, "device_busy_share": device_ms / ms_per_step,
            "profiled_busy_share": device_ms * steps / wall_ms,
            "top_kernels_ms_per_step": [(k[:60], ms) for k, ms in kernels[:10]],
            "decode_kernel_ms_per_step": sum(ms for k, ms in kernels if kernel_name in k),
            "profile_ok": any(kernel_name in k for k, _ in kernels),
            "profile_s": time.perf_counter() - t_start}


def phase_serve(dev):
    """The server as the README starts it (`--test_batch_size 8`), at full
    ArAE width in bf16 with random weights from seed 0: HTTP requests
    through `build_server`, then the engine alone with the bf16 cache
    (row 9's kernel), with `--kv_quant true --w_quant true` (row 11's
    kernel), and with `--kv_quant true --kv_bits 4` (row 10's kernel)."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.infer import load_model
    from edgerunner_tpu_torch.ops import decode_attention as DA
    from edgerunner_tpu_torch.serve_engine import engine_shape

    opt = dataclasses.replace(config_defaults["ArAE"], test_batch_size=SERVE_ROWS)
    bench_opt = dataclasses.replace(opt, decode_bucket=CUT_BUCKET)
    res = {"layers": opt.num_layers, "hidden": opt.hidden_dim, "dtype": "bfloat16",
           "generate_mode": opt.generate_mode, "cache_len": engine_shape(opt)[2],
           "card": card_line()}
    res["http"], model = serve_http(opt, dev)
    gc.collect()  # the HTTP engine's state
    torch.cuda.empty_cache()
    res["bench_bf16"], engine = serve_bench(model, bench_opt, dev,
                                            DA.fused_decode_attention_multi,
                                            SERVE_BENCH_REQUESTS)
    res["bench_bf16"].update(profile_segment(engine, dev, res["bench_bf16"]["ms_per_step"],
                                             "DecodeM<"))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    q_opt = dataclasses.replace(bench_opt, kv_quant=True, w_quant=True)
    model = load_model(q_opt, dev)
    res["bench_int8_wquant"], engine = serve_bench(
        model, q_opt, dev, DA.fused_decode_attention_q8_multi, SERVE_BENCH_Q8_REQUESTS)
    res["bench_int8_wquant"].update(
        profile_segment(engine, dev, res["bench_int8_wquant"]["ms_per_step"], "DecodeQ<"))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    q4_opt = dataclasses.replace(bench_opt, kv_quant=True, kv_bits=4)
    model = load_model(q4_opt, dev)
    res["bench_int4"], engine = serve_bench(
        model, q4_opt, dev, DA.fused_decode_attention_q4_multi, SERVE_BENCH_Q4_REQUESTS)
    res["bench_int4"].update(profile_segment(engine, dev, res["bench_int4"]["ms_per_step"],
                                             "DecodeQ<"))
    benches = ("bench_bf16", "bench_int8_wquant", "bench_int4")
    res["ok"] = res["http"]["ok"] and all(res[k]["ok"] and res[k]["profile_ok"]
                                          for k in benches)
    return res


def set_draft_heads(model, seed):
    """Random non-zero draft-head weights from a numpy seed: zero heads, as
    init_weights leaves them, would always draft the base head's token."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for head in model.mesh_decoder.mtp_proj:
            for p in (head.weight, head.bias):
                p.copy_(torch.from_numpy(rng.normal(0.0, MTP_STD, p.shape).astype(np.float32)))
    return model


@contextlib.contextmanager
def recorded_passes():
    """The accepted counts [B] of every speculative pass run inside."""
    from edgerunner_tpu_torch import generate as TG

    seen, spec_pass = [], TG.spec_pass

    def recording(*args, **kw):
        out = spec_pass(*args, **kw)
        seen.append(out[1])
        return out

    TG.spec_pass = recording
    try:
        yield seen
    finally:
        TG.spec_pass = spec_pass


def acceptance(seen) -> dict:
    """Tokens accepted per verify pass, over the rows that took tokens."""
    a = torch.cat([x[x > 0] for x in seen]).float()
    return {"passes": len(seen), "accepted_per_pass": a.mean().item(),
            "accepted_histogram": torch.bincount(a.long()).tolist()}


def spec_generate(model, opt, dev, kernel) -> dict:
    """`generate_tokens` with spec decoding at full width, SPEC_ROWS rows,
    EOS forbidden, SPEC_BUDGET tokens: every pass launches `kernel` (rows
    9 or 10 at T = 1 + mtp_heads) once per layer, and no other decode
    kernel runs."""
    num_new = decode_shape_of(opt, SPEC_BUDGET)[0]
    run = timed_generate(model, opt, dev, SPEC_ROWS, SPEC_BUDGET)
    tokens, stats = run["tokens"], acceptance(run["passes"])
    want = expected_launches(opt, kernel, stats["passes"])
    ok = (tokens.shape == (SPEC_ROWS, num_new) and run["launches"] == want
          and not (tokens == 0).any())
    return {"ok": ok, "rows": SPEC_ROWS, "num_new": num_new, "generate_s": run["generate_s"],
            "prefill_s": run["prefill_s"], "tokens_per_s": run["tokens_per_s"],
            "ms_per_pass": (run["generate_s"] - run["prefill_s"]) / stats["passes"] * 1e3,
            **stats, "peak_mem_gib": run["peak_mem_gib"], "launches": run["launches"],
            "launches_expected": want}


def replay_gaps(model, opt, dev, points, stream, max_len) -> np.ndarray:
    """The top-2 gap of the masked logits at each step [rows, steps] of the
    vanilla one-token path replayed on `stream`, EOS forbidden."""
    from edgerunner_tpu_torch.config import vocab_size_for
    from edgerunner_tpu_torch.ops import sampling as S

    rows = len(points)
    G, vocab = S.get_grammar(opt.meto_backend), vocab_size_for(opt)
    no_eos = torch.arange(vocab, device=dev)[None] != S.EOS_ID
    gaps = np.zeros(stream.shape)
    with torch.no_grad():
        logits, caches, plen = model.prefill(
            torch.tensor(points, device=dev), torch.full((rows,), FACES, device=dev),
            torch.full((rows, 1), opt.bos_token_id, device=dev), max_len)
        state = G.init(rows, dev)
        for i in range(stream.shape[1]):
            mask = G.mask(state, vocab) & no_eos
            top2 = torch.topk(S.apply_mask(logits[:, 0].float(), mask), 2).values
            gaps[:, i] = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            t = torch.as_tensor(stream[:, i], device=dev)
            state = G.advance(state, t)
            if i + 1 < stream.shape[1]:
                logits = model.step(t[:, None], caches, plen + i)
    return gaps


def spec_parity(dev, cache: dict) -> dict:
    """2 layers at full width in f32 (TF32 off), kernel path: speculative
    greedy streams against the vanilla greedy streams of the same model,
    EOS forbidden; the first token where a row's streams differ must come
    at a step whose top-2 gap on the vanilla path is under NEAR_TIE."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.generate import decode_shape, generate_tokens

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = dataclasses.replace(config_defaults["ArAE"], num_layers=2, generate_mode="greedy",
                              mtp_heads=SPEC_HEADS, spec_decode=True,
                              decode_bucket=CUT_BUCKET, **cache)
    model = set_draft_heads(build_model(opt, dev, torch.float32, SEED + 4), SEED + 4)
    points = np.random.default_rng(SEED + 4).normal(size=(2, opt.point_num, 3)).astype(
        np.float32)
    kw = dict(num_faces=FACES, max_new_tokens=PARITY_CUT_STEPS, bench_no_eos=True)
    with recorded_passes() as seen:
        spec = generate_tokens(model, points, **kw)
    model.opt = dataclasses.replace(opt, spec_decode=False)
    vanilla = generate_tokens(model, points, **kw)
    gaps = replay_gaps(model, model.opt, dev, points, vanilla,
                       decode_shape(model.opt, 1, FACES, PARITY_CUT_STEPS)[1])
    first = [int(np.argmax(a != b)) if (a != b).any() else None for a, b in zip(spec, vanilla)]
    ok = all(t is None or gaps[r, t] < NEAR_TIE for r, t in enumerate(first))
    return {"ok": ok, "layers": 2, "dtype": "float32", "tf32": False, "rows": 2,
            "steps": int(spec.shape[1]), "near_tie": NEAR_TIE,
            "streams_identical": bool(np.array_equal(spec, vanilla)), "first_mismatch": first,
            "steps_under_near_tie": int((gaps < NEAR_TIE).sum()),
            "min_gap": float(gaps.min()), **acceptance(seen)}


def phase_spec(dev):
    """Speculative decoding (--mtp_heads 2 --spec_decode true, greedy) with
    random draft heads from a numpy seed, at full ArAE width in bf16: on
    `generate_tokens` and on the engine (SERVE_ROWS slots, SERVE_BENCH_Q4_REQUESTS
    requests of SERVE_BENCH_FACES faces), over the bf16 cache (row 9 at T =
    3) and the int4 cache (row 10 at T = 3); tokens accepted per verify
    pass, ms per pass, each kernel's launches held to 24 per pass. Then the
    f32 spec streams against vanilla streams (kernel path, both caches) up
    to near-ties."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.infer import load_model
    from edgerunner_tpu_torch.ops import decode_attention as DA

    base = dataclasses.replace(config_defaults["ArAE"], generate_mode="greedy",
                               test_batch_size=SERVE_ROWS, mtp_heads=SPEC_HEADS,
                               spec_decode=True)
    res = {"mtp_heads": SPEC_HEADS, "draft_std": MTP_STD, "card": card_line()}
    for name, cache, kernel in (
            ("bf16", {}, DA.fused_decode_attention_multi),
            ("int4", {"kv_quant": True, "kv_bits": 4}, DA.fused_decode_attention_q4_multi)):
        opt = dataclasses.replace(base, **cache)
        model = set_draft_heads(load_model(opt, dev), SEED + 6)
        res[f"generate_{name}"] = spec_generate(model, opt, dev, kernel)
        with recorded_passes() as seen:
            bench, engine = serve_bench(model, opt, dev, kernel, SERVE_BENCH_Q4_REQUESTS)
        bench.update(acceptance(seen))
        bench["ms_per_pass"] = bench["ms_per_step"]
        res[f"engine_{name}"] = bench
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    res["parity_bf16_layout"] = spec_parity(dev, {})
    res["parity_int4"] = spec_parity(dev, {"kv_quant": True, "kv_bits": 4})
    res["ok"] = all(v["ok"] for v in res.values() if isinstance(v, dict))
    return res


def solo_with_gaps(model, opt, dev, points, num_faces) -> tuple:
    """A request's solo greedy stream (`generate_tokens`, batch 1, EOS
    forbidden) and, replayed on that stream, the top-2 gap of each step's
    masked logits, the step after its last token included."""
    from edgerunner_tpu_torch.config import vocab_size_for
    from edgerunner_tpu_torch.generate import decode_shape, generate_tokens, trim_eos
    from edgerunner_tpu_torch.ops import sampling as S

    stream = trim_eos(generate_tokens(model, points[None], num_faces=num_faces,
                                      bench_no_eos=True)[0])
    _, max_len = decode_shape(opt, 1, num_faces, None)
    G, vocab = S.get_grammar(opt.meto_backend), vocab_size_for(opt)
    no_eos = torch.arange(vocab, device=dev)[None] != S.EOS_ID
    gaps = []
    with torch.no_grad():
        logits, caches, plen = model.prefill(
            torch.tensor(points[None], device=dev), torch.full((1,), num_faces, device=dev),
            torch.full((1, 1), opt.bos_token_id, device=dev), max_len)
        state = G.init(1, dev)
        for i in range(len(stream) + 1):  # the step after the last token chose EOS
            mask = G.mask(state, vocab) & no_eos
            top2 = torch.topk(S.apply_mask(logits[:, 0].float(), mask), 2).values
            gaps.append((top2[0, 0] - top2[0, 1]).item())
            if i == len(stream):
                break
            t = torch.tensor([stream[i]], device=dev)
            state = G.advance(state, t)
            logits = model.step(t[:, None], caches, plen + i)
    return stream, gaps


def phase_serve_parity(dev):
    """The engine's guarantee (tests/test_continuous.py::
    test_greedy_identity_with_solo_decode) on the card: 2 layers at full
    width in f32 (TF32 off), greedy with EOS forbidden (random weights end
    early otherwise), 4 slots and 6 staggered requests whose budgets of 128
    and 256 tokens free slots mid-flight; each
    delivered stream equals the same request's solo `generate_tokens`
    stream up to near-ties: the first token where they differ must come at
    a step whose top-2 logit gap on the solo path is under NEAR_TIE. For
    the kernel path and the plain path, with the bf16-layout (here f32) and
    the int8 cache."""
    import threading

    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.generate import trim_eos
    from edgerunner_tpu_torch.serve_engine import ContinuousEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dataclasses.replace(config_defaults["ArAE"], num_layers=2, generate_mode="greedy",
                               decode_bucket=SERVE_PARITY_BUCKET)
    rng = np.random.default_rng(SEED + 3)
    points = rng.normal(size=(len(SERVE_PARITY_FACES), base.point_num, 3)).astype(np.float32)
    runs = {}
    for kv_quant in (False, True):
        opt = dataclasses.replace(base, kv_quant=kv_quant)
        for path, kernels in (("kernel", True), ("plain", False)):
            model = build_model(opt, dev, torch.float32, SEED + 3, use_kernels=kernels)
            solo = [solo_with_gaps(model, opt, dev, p, nf)
                    for p, nf in zip(points, SERVE_PARITY_FACES)]
            engine = ContinuousEngine(model, opt, batch=4, segment_steps=64, bench_no_eos=True)
            got = [None] * len(points)

            def send(i):
                time.sleep(0.3 * i)
                got[i] = engine.submit(points[i], SERVE_PARITY_FACES[i], None)["tokens"]

            threads = [threading.Thread(target=send, args=(i,)) for i in range(len(points))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            engine.shutdown()
            engine.thread.join()
            first, ok = [], True
            for (stream, gaps), out in zip(solo, got):
                out = trim_eos(out)
                n = min(len(out), len(stream))
                diff = np.nonzero(out[:n] != stream[:n])[0]
                t = int(diff[0]) if len(diff) else (None if len(out) == len(stream) else n)
                first.append(t)
                ok = ok and (t is None or (t < len(gaps) and gaps[t] < NEAR_TIE))
            runs[f"{path} {'int8' if kv_quant else 'bf16-layout'}"] = {
                "ok": ok, "identical": sum(t is None for t in first),
                "first_mismatch": first, "lengths": [len(s) for s, _ in solo],
                "min_gap": min(min(g) for _, g in solo if g)}
            del model, engine
    return {"ok": all(r["ok"] for r in runs.values()), "layers": 2, "dtype": "float32",
            "tf32": False, "slots": 4, "requests": len(points), "near_tie": NEAR_TIE,
            "num_faces": list(SERVE_PARITY_FACES), **runs}


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
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    res["f32"] = train_f32(dev, opt, batch)
    res["ok"] = res["ok"] and res["f32"]["ok"]
    return res


@contextlib.contextmanager
def flash_dtypes():
    """The dtype of every flash kernel launch (forward and backward, from
    any wrapper) while open, appended to the list it yields."""
    from edgerunner_tpu_torch.ops import flash_attention as FA

    seen, fwd, bwd = [], FA._forward_kernel, FA._backward_kernel

    def forward(q, *args, **kw):
        seen.append(("fwd", str(q.dtype)))
        return fwd(q, *args, **kw)

    def backward(q, *args, **kw):
        seen.append(("bwd", str(q.dtype)))
        return bwd(q, *args, **kw)

    FA._forward_kernel, FA._backward_kernel = forward, backward
    try:
        yield seen
    finally:
        FA._forward_kernel, FA._backward_kernel = fwd, bwd


def train_f32(dev, opt, batch) -> dict:
    """The train phase's path in f32 (`--mixed_precision no`: no autocast,
    the flash kernels' f32 instances: kernel A's 3xTF32 forward and kernel
    C's 3xTF32 backward), at full width on the same batch, TF32 off for the
    GEMMs as PyTorch's default leaves it: TRAIN_F32_STEPS steps, each step's
    launches counted from 0 and held to A 2 and C 1 per attention call, every
    one f32; s/it from the last; then one profiled step (device ms by kernel
    and kind)."""
    from edgerunner_tpu_torch.models.lmm import LMM, init_weights
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from edgerunner_tpu_torch.train.trainer import Trainer

    opt = dataclasses.replace(opt, mixed_precision="no")
    trainer = Trainer(init_weights(LMM(opt, device=dev), SEED), opt, total_steps=1000)
    calls = opt.num_layers + 1
    want = {"flash_attention_fwd": 2 * calls, "flash_attention_bwd": calls}
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with flash_dtypes() as seen:
        for _ in range(TRAIN_F32_STEPS):
            flash_attention.launches = flash_attention_bwd.launches = 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = trainer.train_step(batch)
            torch.cuda.synchronize()
            steps.append({"s": time.perf_counter() - t1, **m, "launches": {
                "flash_attention_fwd": flash_attention.launches,
                "flash_attention_bwd": flash_attention_bwd.launches}})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dtypes = sorted({d for _, d in seen})
    losses = [st["loss"] for st in steps]
    T = train_positions(opt)
    res = {"ok": (all(st["launches"] == want for st in steps) and dtypes == ["torch.float32"]
                  and len(seen) == TRAIN_F32_STEPS * 3 * calls and all(np.isfinite(losses))),
           "mixed_precision": "no", "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "steps": TRAIN_F32_STEPS, "launch_dtypes": dtypes,
           "s_per_it": steps[-1]["s"], "first_step_s": steps[0]["s"],
           "tokens_per_s": TRAIN_ROWS * T / steps[-1]["s"], "peak_mem_gib": peak,
           "losses": losses, "launches_per_step": [st["launches"] for st in steps],
           "launches_expected_per_step": want}
    res.update(profile_dit_train_step(trainer, batch))
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


def grad_err_over_tol(got: dict, want: dict) -> tuple:
    """(worst, its tensor's name, the largest reference gradient) of each
    gradient tensor's error over its tolerance: GRAD_TOL of its largest
    reference value plus 1e-6 of the model's largest; ok while worst <= 1."""
    top = max(g.abs().max().item() for g in want.values())
    worst, worst_name = 0.0, None
    for n, w in want.items():
        err = (got[n] - w).abs().max().item() / (GRAD_TOL * w.abs().max().item() + 1e-6 * top)
        if err > worst:
            worst, worst_name = err, n
    return worst, worst_name, top


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
    worst, worst_name, top = grad_err_over_tol(gk, gp)
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


# ---------------------------------------------------------------------- sp --

def param_checksum(params) -> int:
    """An exact fingerprint of f32 parameters: the sum of their bits as int64."""
    return int(sum(p.detach().view(torch.int32).long().sum().item() for p in params))


def sp_launch_counts() -> dict:
    from edgerunner_tpu_torch.ops import flash_attention as FA

    return {"flash_attention_lse": FA.flash_attention_lse.launches,
            "flash_attention_lse_bwd": FA.flash_attention_lse_bwd.launches,
            "flash_attention_fwd": FA.flash_attention.launches,
            "flash_attention_bwd": FA.flash_attention_bwd.launches}


def zero_sp_launch_counts():
    from edgerunner_tpu_torch.ops import flash_attention as FA

    for fn in (FA.flash_attention_lse, FA.flash_attention_lse_bwd, FA.flash_attention,
               FA.flash_attention_bwd):
        fn.launches = 0


def sp_ring(dev, sp) -> list:
    """Causal ring attention of the full train-batch arrays [2, 6148, 16, 96]
    over the group, bf16 and f32: the gathered output and the gradients
    (summed over the ranks) against single-process `attention` (kernels A
    and C) on the same arrays, on rank 0; row 5 launched r + 1 times
    forward and backward on rank r."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.ops.attention import attention
    from edgerunner_tpu_torch.ops.ring_attention import ring_self_attention
    from edgerunner_tpu_torch.parallel import all_reduce_

    opt = config_defaults["ArAE"]
    H, D, N = opt.num_heads, opt.hidden_dim // opt.num_heads, sp_positions(opt)
    runs = []
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(11)
        q, k, v, do = (torch.randn((TRAIN_ROWS, N, H, D), device=dev, generator=g).to(dtype)
                       for _ in range(4))
        x = [t.clone().requires_grad_() for t in (q, k, v)]
        zero_sp_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ring_self_attention(*x, sp, causal=True)
        grads = list(torch.autograd.grad(out, x, do))
        all_reduce_(grads, sp)
        torch.cuda.synchronize()
        run = {"dtype": str(dtype).split(".")[-1], "shape": [TRAIN_ROWS, N, H, D],
               "s": time.perf_counter() - t0, "launches": sp_launch_counts(),
               "launches_expected": {"flash_attention_lse": sp.rank + 1,
                                     "flash_attention_lse_bwd": sp.rank + 1,
                                     "flash_attention_fwd": 0, "flash_attention_bwd": 0}}
        run["ok"] = run["launches"] == run["launches_expected"]
        if sp.rank == 0:
            y = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = attention(*y, causal=True)
            refs = torch.autograd.grad(ref, y, do)
            checks = {"out": compare(out, ref, dtype),
                      **{f"d{n}": compare(a, b, dtype) for n, a, b in zip("qkv", grads, refs)}}
            run.update(checks)
            run["ok"] = run["ok"] and all(c["ok"] for c in checks.values())
            del ref, refs, y
        runs.append(run)
        del x, out, grads, q, k, v, do
    return runs


def sp_train(dev, sp) -> dict:
    """The ArAE training step at full width over the group: bench.py's train
    batch (2 rows of 6147 positions, padded to 6148), bf16 autocast,
    checkpointing and dropout on, as the train phase. First the held-out
    loss of the batch under sp against rank 0's single-process loss from
    the same weights (within 2^-8 of it: one bf16 step); then one warm-up
    and SP_TRAIN_STEPS timed steps, each step's launches counted from 0 and
    held to 2 * layers * (r + 1) forward and layers * (r + 1) backward
    launches of row 5 on rank r (checkpointing replays the forward), and 2
    forward and 1 backward of rows 1/3 (the point encoder)."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.models.lmm import LMM, init_weights
    from edgerunner_tpu_torch.parallel import ring_shift
    from edgerunner_tpu_torch.train.trainer import Trainer, pad_for_sp

    opt = dataclasses.replace(config_defaults["ArAE"], batch_size=TRAIN_ROWS, sp_size=sp.size)
    t0 = time.perf_counter()
    trainer = Trainer(init_weights(LMM(opt, device=dev), SEED), opt, total_steps=1000, sp=sp)
    trainer.init_state()
    batch = train_batch(opt, TRAIN_ROWS)
    setup_s = time.perf_counter() - t0
    res = {"rows": TRAIN_ROWS, "positions": train_positions(opt),
           "padded_positions": pad_for_sp(batch, sp.size, opt.pad_token_id)["labels"].shape[1],
           "layers": opt.num_layers, "autocast": "bfloat16", "checkpointing": opt.checkpointing,
           "setup_s": setup_s, "eval_loss_sp": trainer.eval_loss(batch)}
    if sp.rank == 0:
        with torch.no_grad():
            res["eval_loss_solo"] = float(trainer.eval_step(batch)["loss"])
        res["eval_loss_rel_err"] = abs(res["eval_loss_sp"] - res["eval_loss_solo"]) / abs(
            res["eval_loss_solo"])
        res["eval_loss_tolerance"] = 2.0 ** -8
    L, r = opt.num_layers, sp.rank
    want = {"flash_attention_lse": 2 * L * (r + 1), "flash_attention_lse_bwd": L * (r + 1),
            "flash_attention_fwd": 2, "flash_attention_bwd": 1}
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for _ in range(1 + SP_TRAIN_STEPS):
        zero_sp_launch_counts()
        sent = ring_shift.bytes
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t1, **m, "launches": sp_launch_counts(),
                      "ring_bytes": ring_shift.bytes - sent})
    losses = [st["loss"] for st in steps]
    res.update(
        warmup_s=steps[0]["s"], timed_steps=SP_TRAIN_STEPS,
        s_per_it=sum(st["s"] for st in steps[1:]) / SP_TRAIN_STEPS,
        s_per_it_label=f"{sp.size} ranks sharing one card",
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        ring_bytes_per_step=steps[-1]["ring_bytes"],
        allreduce_bytes_per_step=sum(p.numel() * p.element_size()
                                     for p in trainer.params.values()),
        losses=losses, grad_norms=[st["grad_norm"] for st in steps],
        launches_per_step=[st["launches"] for st in steps], launches_expected_per_step=want,
        launches={k: sum(st["launches"][k] for st in steps[1:]) for k in want},
        param_checksum=param_checksum(trainer.params.values()))
    ok = (all(st["launches"] == want for st in steps) and all(np.isfinite(losses))
          and losses[-1] < losses[0])
    if sp.rank == 0:
        ok = ok and res["eval_loss_rel_err"] <= res["eval_loss_tolerance"]
    res["ok"] = bool(ok)
    return res


def sp_parity(dev, sp) -> dict:
    """2 layers at full width in f32 (TF32 off), dropout off: the loss and
    every parameter's gradient (summed over the ranks) of a step over the
    group against rank 0's single-process step on the same weights and the
    train batch with its second row cut to TRAIN_RAGGED_LEN, under train
    parity's tolerance."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.models.lmm import LMM, init_weights
    from edgerunner_tpu_torch.parallel import all_reduce_, sequence_parallel
    from edgerunner_tpu_torch.train.trainer import pad_for_sp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = dataclasses.replace(config_defaults["ArAE"], num_layers=2, mixed_precision="no",
                              sp_size=sp.size)
    model = init_weights(LMM(opt, device=dev), SEED + 2)
    params = dict(model.named_parameters())
    batch = train_batch(opt, TRAIN_ROWS, lengths=[train_positions(opt), TRAIN_RAGGED_LEN])

    def loss_and_grads(b):
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        o = model(b["conds"], b["tokens"], b["labels"], b["num_faces"], b["lengths"],
                  train=False)
        return o["loss"], list(torch.autograd.grad(o["loss"], list(params.values())))

    with sequence_parallel(sp):
        loss, grads = loss_and_grads(pad_for_sp(batch, sp.size, opt.pad_token_id))
    total = torch.stack([loss.detach()])
    all_reduce_([total] + grads, sp)
    res = {"layers": 2, "dtype": "float32", "tf32": False, "loss_sp": total.item()}
    if sp.rank != 0:
        return res
    loss1, grads1 = loss_and_grads(batch)
    worst, worst_name, _ = grad_err_over_tol(dict(zip(params, grads)), dict(zip(params, grads1)))
    loss_err = abs(total.item() - loss1.item()) / abs(loss1.item())
    res.update(loss_solo=loss1.item(), loss_rel_err=loss_err, grad_tensors=len(grads1),
               grad_worst_err_over_tol=worst, grad_worst_tensor=worst_name,
               tolerance=f"loss rel <= 1e-5; per tensor max|dg| <= {GRAD_TOL} * "
                         "max|g_solo| + 1e-6 * max over tensors of max|g_solo|",
               ok=loss_err <= 1e-5 and worst <= 1.0)
    return res


def sp_rank(rank, R, path):
    """One rank of the sp phase: joins the group through a file under
    `path`, runs the ring at full width and, with SP_TRAIN_RANKS ranks, the
    training step and its f32 parity, with 4 ranks the dp x sp f32 parity
    (SP_DP_SP); writes its results to path/rank{rank}.json."""
    import torch.distributed as dist

    from edgerunner_tpu_torch.parallel import (
        SequenceParallel,
        init_distributed,
        make_layout,
        rank_device,
    )

    os.environ["LOCAL_RANK"] = str(rank)
    dev = rank_device("cuda")
    backend = init_distributed(dev, rank=rank, world_size=R,
                               init_method=f"file://{os.path.join(path, 'init')}")
    sp = SequenceParallel.world(dev)
    out = {"rank": rank, "device": str(dev), "backend": backend, "staged": sp.staged,
           "describe": sp.describe()}
    try:
        out["ring"] = sp_ring(dev, sp)
        if R == SP_TRAIN_RANKS:
            torch.cuda.empty_cache()
            out["train"] = sp_train(dev, sp)
            torch.cuda.empty_cache()
            out["parity"] = sp_parity(dev, sp)
        if R == SP_DP_SP[0] * SP_DP_SP[1]:
            torch.cuda.empty_cache()
            out["dp_sp_parity"] = lmm_dp_parity(dev, *make_layout(dev, *SP_DP_SP))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_sp(dev):
    """Sequence parallelism on the card: SP_RING_RANKS groups of ranks that
    share the card (gloo, pinned host staging), spawned from this process
    with `torch.multiprocessing.spawn`; a rank that fails fails the phase.
    R = 2: the ring at full width, the ArAE training step at full width,
    its f32 parity at 2 layers. R = 4: the ring at full width, then the f32
    parity of a dp 2 x sp 2 step at 2 layers (`lmm_dp_parity`)."""
    import tempfile

    import torch.multiprocessing as mp

    from edgerunner_tpu_torch.parallel import choose_backend

    res = {"card": card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        for R in SP_RING_RANKS:
            path = os.path.join(tmp, f"ranks{R}")
            os.makedirs(path)
            t0 = time.perf_counter()
            mp.spawn(sp_rank, args=(R, path), nprocs=R, join=True)
            ranks = []
            for r in range(R):
                with open(os.path.join(path, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            res[f"R{R}"] = {"seconds": time.perf_counter() - t0,
                            "backend": ranks[0]["backend"], "staged": ranks[0]["staged"],
                            "expected_backend": choose_backend(dev, R), "ranks": ranks}
    ok = True
    for R in SP_RING_RANKS:
        ranks = res[f"R{R}"]["ranks"]
        ok = ok and res[f"R{R}"]["backend"] == res[f"R{R}"]["expected_backend"]
        ok = ok and all(run["ok"] for rk in ranks for run in rk["ring"])
        if R == SP_TRAIN_RANKS:
            ok = ok and all(rk["train"]["ok"] for rk in ranks) and ranks[0]["parity"]["ok"]
            sums = {rk["train"]["param_checksum"] for rk in ranks}
            res["train_param_checksums_equal"] = len(sums) == 1
            ok = ok and len(sums) == 1
        if R == SP_DP_SP[0] * SP_DP_SP[1]:
            ok = ok and ranks[0]["dp_sp_parity"]["ok"]
    res["ok"] = bool(ok)
    return res


# ---------------------------------------------------------------------- dp --

def rows_of(batch: dict, d: int, groups: int) -> dict:
    """Dp group d's contiguous share of a global batch's rows."""
    per = len(batch["lengths" if "lengths" in batch else "points"]) // groups
    return {k: v[d * per:(d + 1) * per] for k, v in batch.items()}


def dp_train(dev, dp) -> dict:
    """(a) The ArAE training step at full width with dp ranks sharing the
    card: `Trainer` as main builds it, bf16 autocast, checkpointing and
    dropout on, each rank TRAIN_ROWS rows of its own of bench.py's train
    batch (a global batch of TRAIN_ROWS x dp rows, 6147 positions each).
    First the held-out loss of the global batch taken as dp shares
    (train=False) and summed, against rank 0's single-process loss of the
    same rows (within 2^-8: one bf16 step); then one warm-up and
    DP_TRAIN_STEPS timed steps, each step's launches counted from 0 and held
    to A 2 and C 1 per attention call (the decoder's layers and the point
    encoder), the bytes the all-reduce sums per step, the parameters'
    checksum."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.models.lmm import LMM, init_weights
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from edgerunner_tpu_torch.parallel import all_reduce_, data_parallel
    from edgerunner_tpu_torch.train.trainer import Trainer

    opt = dataclasses.replace(config_defaults["ArAE"], batch_size=TRAIN_ROWS, dp_size=dp.size)
    t0 = time.perf_counter()
    trainer = Trainer(init_weights(LMM(opt, device=dev), SEED), opt, total_steps=1000, dp=dp)
    trainer.init_state()
    whole = train_batch(opt, TRAIN_ROWS * dp.size)
    batch = rows_of(whole, dp.rank, dp.size)
    setup_s = time.perf_counter() - t0
    with torch.no_grad(), data_parallel(dp):
        share = trainer.forward(batch, train=False)["loss"].float().reshape(1)
    all_reduce_([share], dp.world)
    res = {"rows_per_rank": TRAIN_ROWS, "global_rows": TRAIN_ROWS * dp.size,
           "positions": train_positions(opt), "layers": opt.num_layers,
           "autocast": "bfloat16", "checkpointing": opt.checkpointing, "setup_s": setup_s,
           "eval_loss_dp": share.item()}
    if dp.world.rank == 0:
        with torch.no_grad():
            res["eval_loss_solo"] = float(trainer.eval_step(whole)["loss"])
        res["eval_loss_rel_err"] = abs(res["eval_loss_dp"] - res["eval_loss_solo"]) / abs(
            res["eval_loss_solo"])
        res["eval_loss_tolerance"] = 2.0 ** -8
    calls = opt.num_layers + 1
    want = {"flash_attention_fwd": 2 * calls, "flash_attention_bwd": calls}
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for _ in range(1 + DP_TRAIN_STEPS):
        flash_attention.launches = flash_attention_bwd.launches = 0
        summed = all_reduce_.bytes
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t1, **m,
                      "allreduce_bytes": all_reduce_.bytes - summed, "launches": {
                          "flash_attention_fwd": flash_attention.launches,
                          "flash_attention_bwd": flash_attention_bwd.launches}})
    losses = [st["loss"] for st in steps]
    res.update(
        warmup_s=steps[0]["s"], timed_steps=DP_TRAIN_STEPS,
        s_per_it=sum(st["s"] for st in steps[1:]) / DP_TRAIN_STEPS,
        s_per_it_label=f"{dp.size} ranks sharing one card",
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        allreduce_bytes_per_step=steps[-1]["allreduce_bytes"],
        gradient_bytes=sum(p.numel() * p.element_size() for p in trainer.params.values()),
        losses=losses, grad_norms=[st["grad_norm"] for st in steps],
        launches_per_step=[st["launches"] for st in steps], launches_expected_per_step=want,
        param_checksum=param_checksum(trainer.params.values()))
    ok = (all(st["launches"] == want for st in steps) and all(np.isfinite(losses))
          and losses[-1] < losses[0])
    if dp.world.rank == 0:
        ok = ok and res["eval_loss_rel_err"] <= res["eval_loss_tolerance"]
    res["ok"] = bool(ok)
    return res


def lmm_dp_parity(dev, dp, sp=None) -> dict:
    """(b), and (c) with `sp`: 2 layers at full width in f32 (TF32 off),
    dropout off (train=False): the loss of a global batch of TRAIN_ROWS x dp
    rows, its last row cut to TRAIN_RAGGED_LEN so that the dp groups' label
    counts differ (where a mean of the groups' mean losses would miss), taken
    as this rank's share under the dp (and sp) context and summed over the
    world, and every parameter's gradient summed over the world, against
    rank 0's single-process step on the whole batch, under train parity's
    tolerance."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.models.lmm import LMM, init_weights
    from edgerunner_tpu_torch.parallel import all_reduce_, data_parallel, sequence_parallel
    from edgerunner_tpu_torch.train.trainer import pad_for_sp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sp_size = 1 if sp is None else sp.size
    opt = dataclasses.replace(config_defaults["ArAE"], num_layers=2, mixed_precision="no",
                              dp_size=dp.size, sp_size=sp_size)
    model = init_weights(LMM(opt, device=dev), SEED + 2)
    params = dict(model.named_parameters())
    rows = TRAIN_ROWS * dp.size
    whole = train_batch(opt, rows, lengths=[train_positions(opt)] * (rows - 1)
                        + [TRAIN_RAGGED_LEN])

    def loss_and_grads(b):
        b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        o = model(b["conds"], b["tokens"], b["labels"], b["num_faces"], b["lengths"],
                  train=False)
        return o["loss"], list(torch.autograd.grad(o["loss"], list(params.values())))

    mine = rows_of(whole, dp.rank, dp.size)
    with sequence_parallel(sp), data_parallel(dp):
        loss, grads = loss_and_grads(pad_for_sp(mine, sp_size, opt.pad_token_id))
    total = torch.stack([loss.detach()])
    all_reduce_([total] + grads, dp.world)
    res = {"layers": 2, "dtype": "float32", "tf32": False, "dp": dp.size, "sp": sp_size,
           "lengths": whole["lengths"].tolist(), "loss_dp": total.item()}
    if dp.world.rank != 0:
        return res
    loss1, grads1 = loss_and_grads(whole)
    worst, worst_name, _ = grad_err_over_tol(dict(zip(params, grads)), dict(zip(params, grads1)))
    loss_err = abs(total.item() - loss1.item()) / abs(loss1.item())
    res.update(loss_solo=loss1.item(), loss_rel_err=loss_err, grad_tensors=len(grads1),
               grad_worst_err_over_tol=worst, grad_worst_tensor=worst_name,
               tolerance=f"loss rel <= 1e-5; per tensor max|dg| <= {GRAD_TOL} * "
                         "max|g_solo| + 1e-6 * max over tensors of max|g_solo|",
               ok=loss_err <= 1e-5 and worst <= 1.0)
    return res


def mdit_dp_parity(dev, dp) -> dict:
    """(b) for the MDiT: 2 DiT and 2 CLIP layers at full width in f32 (TF32
    off), the point encoder at full width, DIT_PARITY_ROWS synthetic
    samples per rank and one set of draws (condition dropout, noise,
    timesteps) for the global batch, each rank taking its rows: the loss as
    the ranks' summed shares and every trainable gradient summed over the
    world, against rank 0's single-process loss of the whole batch, under
    train parity's tolerance."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.data.dataset_dit import DiTMeshDataset, collate_dit
    from edgerunner_tpu_torch.models.mdit import MDiT
    from edgerunner_tpu_torch.parallel import all_reduce_, data_parallel
    from edgerunner_tpu_torch.train.state import frozen_param_keys, trainable_parameters
    from edgerunner_tpu_torch.weights import init_mdit_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    R = DIT_PARITY_ROWS * dp.size
    opt = dataclasses.replace(config_defaults["DiT"], dit_num_layers=2, clip_num_layers=2,
                              mixed_precision="no", synthetic_size=R, dp_size=dp.size)
    model = init_mdit_weights(MDiT(opt, device=dev), SEED + 3)
    params = trainable_parameters(model, frozen_param_keys(opt, "dit"))
    ds = DiTMeshDataset(opt, training=True)
    batch = collate_dit([ds[i] for i in range(R)], opt)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    whole = {"images": torch.as_tensor(batch["images"], device=dev),
             "points": torch.as_tensor(batch["points"], device=dev),
             "keep": torch.rand((R, 1, 1), generator=g, device=dev) >= 0.1,
             "noise": torch.randn((R, opt.point_latent_size, opt.point_latent_dim),
                                  generator=g, device=dev),
             "t": torch.randint(0, 1000, (R,), generator=g, device=dev)}

    def loss_and_grads(b):
        out = model(b["images"], b["points"], train=True, keep=b["keep"], noise=b["noise"],
                    t=b["t"])
        return out["loss"], list(torch.autograd.grad(out["loss"], list(params.values())))

    with data_parallel(dp):
        loss, grads = loss_and_grads(rows_of(whole, dp.rank, dp.size))
    total = torch.stack([loss.detach()])
    all_reduce_([total] + grads, dp.world)
    res = {"dit_layers": 2, "clip_layers": 2, "rows": R, "dtype": "float32", "tf32": False,
           "loss_dp": total.item()}
    if dp.world.rank != 0:
        return res
    loss1, grads1 = loss_and_grads(whole)
    worst, worst_name, _ = grad_err_over_tol(dict(zip(params, grads)), dict(zip(params, grads1)))
    loss_err = abs(total.item() - loss1.item()) / abs(loss1.item())
    res.update(loss_solo=loss1.item(), loss_rel_err=loss_err, grad_tensors=len(grads1),
               grad_worst_err_over_tol=worst, grad_worst_tensor=worst_name,
               ok=loss_err <= 1e-5 and worst <= 1.0)
    return res


def dp_rank(rank, R, path):
    """One rank of the dp phase: joins the group of R ranks through a file
    under `path`, lays it out as dp R, runs (a), (b) and `main` under dp
    (`dp_main`); writes its results to path/rank{rank}.json."""
    import torch.distributed as dist

    from edgerunner_tpu_torch.parallel import init_distributed, make_layout, rank_device

    os.environ["LOCAL_RANK"] = str(rank)
    dev = rank_device("cuda")
    backend = init_distributed(dev, rank=rank, world_size=R,
                               init_method=f"file://{os.path.join(path, 'init')}")
    dp, _ = make_layout(dev, R, 1)
    out = {"rank": rank, "device": str(dev), "backend": backend, "describe": dp.describe()}
    try:
        out["train"] = dp_train(dev, dp)
        torch.cuda.empty_cache()
        out["parity"] = lmm_dp_parity(dev, dp)
        torch.cuda.empty_cache()
        out["mdit_parity"] = mdit_dp_parity(dev, dp)
        gc.collect()
        torch.cuda.empty_cache()
        out["main"] = dp_main(path)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def fleet_generate(dev) -> tuple:
    """(d) The decode fleet on the card: `generate_tokens(..., devices=[dev,
    dev])`, two replicas of the generate phase's model (full width, bf16,
    random weights from seed 0) on the one card, decoded by two threads on
    two streams: ROWS rows, 1000 faces, EOS forbidden, FLEET_BUDGET tokens.
    Each replica's rows must come out bit-identical to the one-device decode
    of the same rows at the same budget (kernel B divides its work by the
    batch, so a decode of all ROWS rows at once may round otherwise: its
    agreement is reported). Kernel A's and B's launches are counted from 0
    for the fleet's call and held exactly: A once per layer and the encoder,
    B once per layer and decode step, on each replica. Returns (report, the
    model)."""
    from edgerunner_tpu_torch.generate import generate_tokens, replicate_model
    from edgerunner_tpu_torch.ops.decode_attention import fused_decode_attention
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention

    opt, *_ = main_path_shapes()
    opt = dataclasses.replace(opt, generate_mode="greedy", decode_bucket=FLEET_BUDGET)
    num_new = decode_shape_of(opt, FLEET_BUDGET)[0]
    model = build_model(opt, dev, torch.bfloat16, SEED)
    points = np.random.default_rng(SEED).normal(size=(ROWS, opt.point_num, 3)).astype(
        np.float32)

    def decode(m, pts, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate_tokens(m, pts, num_faces=FACES, max_new_tokens=FLEET_BUDGET,
                              bench_no_eos=True, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    half = ROWS // 2
    solo = [decode(model, points[i * half:(i + 1) * half])[0] for i in range(2)]
    batch, one_s = decode(model, points)
    devices = [dev, dev]
    t0 = time.perf_counter()
    reps = replicate_model(model, devices)
    replicate_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention.launches = fused_decode_attention.launches = 0
    fleet, fleet_s = decode(reps, points, devices=devices)
    launches = {"flash_attention_fwd": flash_attention.launches,
                "fused_decode_attention": fused_decode_attention.launches}
    want = {"flash_attention_fwd": 2 * (opt.num_layers + 1),
            "fused_decode_attention": 2 * opt.num_layers * (num_new - 1)}
    equal = [bool(np.array_equal(fleet[i * half:(i + 1) * half], solo[i])) for i in range(2)]
    ok = fleet.shape == (ROWS, num_new) and all(equal) and launches == want
    del reps
    return {"ok": bool(ok), "rows": ROWS, "replicas": len(devices), "num_new": num_new,
            "num_faces": FACES, "dtype": "bfloat16", "replicate_s": replicate_s,
            "fleet_s": fleet_s, "fleet_tokens_per_s": fleet.size / fleet_s,
            "one_device_s": one_s, "one_device_tokens_per_s": batch.size / one_s,
            "equal_to_one_device_per_replica": equal,
            "equal_to_one_batch_of_all_rows": bool(np.array_equal(fleet, batch)),
            "fleet_peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "launches": launches, "launches_expected": want}, model


def fleet_infer(dev, model) -> dict:
    """(d') infer's fleet path: `infer.generate_meshes` with devices [dev,
    dev] and the replicas `infer.main` makes (`replicate_model`) of
    `fleet_generate`'s model, greedy, infer's seeded generator,
    FLEET_INFER_REPEATS repeats of one point cloud in groups of 2 (the
    last group, of 1, decodes on the first replica, infer.py:79-82),
    FLEET_BUDGET tokens, EOS allowed; against `generate_meshes` on the
    model alone, one row at a time: the same files, every tokens file
    bit-identical."""
    import tempfile

    from edgerunner_tpu_torch.generate import replicate_model
    from edgerunner_tpu_torch.infer import generate_meshes
    from edgerunner_tpu_torch.utils import get_tokenizer

    cond = np.random.default_rng(SEED + 3).normal(size=(1, model.opt.point_num, 3)).astype(
        np.float32)
    tokenizer, _ = get_tokenizer(model.opt)
    devices = [dev, dev]
    tokens, seconds = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for batch, m, devs in ((1, model, None), (2, replicate_model(model, devices), devices)):
            opt = dataclasses.replace(
                model.opt, workspace=os.path.join(tmp, f"b{batch}"), test_batch_size=batch,
                test_repeat=FLEET_INFER_REPEATS, test_num_face=(FACES,),
                test_max_seq_length=FLEET_BUDGET)
            gen = torch.Generator(device=dev).manual_seed(opt.seed)
            t0 = time.perf_counter()
            paths = generate_meshes(opt, m, tokenizer, "fleet", cond, gen, devices=devs)
            seconds.append(time.perf_counter() - t0)
            tokens.append({os.path.basename(p): np.load(p.replace(".ply", "_tokens.npy"))
                           for p in paths})
            del m
    same = (tokens[0].keys() == tokens[1].keys()
            and all(np.array_equal(tokens[0][k], tokens[1][k]) for k in tokens[0]))
    return {"ok": bool(same and len(tokens[0]) == FLEET_INFER_REPEATS),
            "repeats": FLEET_INFER_REPEATS, "groups_of": 2, "budget": FLEET_BUDGET,
            "files": sorted(tokens[1]), "tokens_per_file": [len(t) for t in tokens[1].values()],
            "equal_to_one_device_row_by_row": bool(same), "one_device_s": seconds[0],
            "fleet_s": seconds[1]}


def fleet_serve(dev, model) -> dict:
    """(e) The engine fleet: `build_server` with --dp_size 2 on [dev, dev]
    (two engines, the model and one replica), FLEET_REQUESTS concurrent
    HTTP requests of FLEET_FACES faces: every request answered, both
    engines taking at least one, /statz listing 2 engines whose counts add
    up; kernel D launched exactly once per layer and engine step."""
    import threading

    from edgerunner_tpu_torch.ops.decode_attention import fused_decode_attention_multi
    from edgerunner_tpu_torch.serve import build_server

    opt = dataclasses.replace(model.opt, dp_size=2, test_batch_size=FLEET_REQUESTS // 2,
                              test_num_face=(FLEET_FACES,))
    server, fleet = build_server(opt, port=0, device=str(dev), model=model, devices=[dev, dev])
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    rng = np.random.default_rng(SEED + 7)
    bodies = [{"points": rng.normal(size=(3000, 3)).tolist(), "num_faces": FLEET_FACES,
               "seed": i} for i in range(FLEET_REQUESTS)]
    answers = [None] * len(bodies)
    for fn in decode_wrappers():
        fn.launches = 0
    steps0 = [fe.engine.steps for fe in fleet.frontends]
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, http(port, "/generate", bodies[i]))) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        statz = http(port, "/statz")
    finally:
        server.shutdown()
        server.server_close()
        fleet.shutdown()
        for fe in fleet.frontends:
            fe.engine.thread.join()
    steps = [fe.engine.steps - s for fe, s in zip(fleet.frontends, steps0)]
    launches = {fn.__name__: fn.launches for fn in decode_wrappers()}
    want = {name: (opt.num_layers * sum(steps)
                   if name == fused_decode_attention_multi.__name__ else 0)
            for name in launches}
    engines = statz[1].get("engines", [])
    good = [a is not None and a[0] == 200 and len(a[1]["tokens"]) > 0 for a in answers]
    ok = (all(good) and statz[0] == 200 and len(engines) == 2
          and all(e["requests_done"] >= 1 for e in engines)
          and statz[1]["requests_done"] == len(bodies) and launches == want)
    return {"ok": bool(ok), "engines": 2, "slots_per_engine": opt.test_batch_size,
            "requests": len(bodies), "num_faces": FLEET_FACES, "wall_s": wall,
            "answers_ok": sum(good), "engine_steps": steps,
            "requests_per_engine": [e["requests_done"] for e in engines],
            "tokens": [len(a[1]["tokens"]) for a in answers if a and a[0] == 200],
            "launches": launches, "launches_expected": want}


def dp_main_argv(data_root: str, workspace: str, *more) -> list:
    """main's command line in the dp phase: the ArAE preset at full width,
    the decoder cut to DP_MAIN_LAYERS, TRAIN_ROWS rows per rank, one epoch."""
    return ["ArAE", "--dp_size", str(DP_RANKS), "--data_root", data_root, "--workspace",
            workspace, "--num_layers", str(DP_MAIN_LAYERS), "--batch_size", str(TRAIN_ROWS),
            "--testset_size", "2", "--num_epochs", "1", "--num_workers", "2",
            "--seed", str(SEED), *more]


def dp_main(path: str) -> dict:
    """(a') `main ArAE --dp_size 2` as torchrun runs it, called in this
    rank's process of the dp phase's world (`run_ranks` takes the world
    that is there): full width, the decoder cut to DP_MAIN_LAYERS, bf16
    autocast, checkpointing and dropout, TRAIN_ROWS rows per rank, the
    folder of DP_MAIN_MESHES procedural meshes under `path` for one epoch;
    then `--resume_train_state` from that epoch's checkpoint for a second,
    in a workspace of its own. This rank's train items (`shard_train_items`),
    the checkpoints it wrote (`CheckpointManager` over the world), each
    step's launches held to A 2 and C 1 per attention call, its losses,
    the parameters' checksum, and the step the resumed run started at."""
    from edgerunner_tpu_torch import main as main_cli
    from edgerunner_tpu_torch.train import checkpoint, ranks

    writes, shards, steps = [], [], []
    write, shard = checkpoint.CheckpointManager._write, ranks.shard_items_for_host

    def counted(self, tag, *a, **kw):
        writes.append(tag)
        return write(self, tag, *a, **kw)

    def recorded(items, r, world):
        shards.append(shard(items, r, world))
        return shards[-1]

    data_root, ws = os.path.join(path, "meshes"), os.path.join(path, "main_ws")
    checkpoint.CheckpointManager._write, ranks.shard_items_for_host = counted, recorded
    t0 = time.perf_counter()
    try:
        with counted_train_steps(steps, {}):
            trainer = main_cli.main(dp_main_argv(data_root, ws))
            n_first, first_step, first_writes = len(steps), trainer.step, len(writes)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            trainer = main_cli.main(dp_main_argv(
                data_root, os.path.join(path, "main_ws_resumed"), "--num_epochs", "2",
                "--resume", os.path.join(ws, "ep0000", "model.safetensors"),
                "--resume_train_state"))
    finally:
        checkpoint.CheckpointManager._write, ranks.shard_items_for_host = write, shard
    L = trainer.opt.num_layers
    want = {"flash_attention_fwd": 2 * (L + 1), "flash_attention_bwd": L + 1}
    losses = [st["loss"] for st in steps]
    res = {"layers": L, "hidden": trainer.opt.hidden_dim, "dp_size": trainer.dp.size,
           "rows_per_rank": trainer.opt.batch_size, "seconds": time.perf_counter() - t0,
           "items": shards[0] if shards else [], "steps_first_run": n_first,
           "first_run_end_step": first_step,
           "resumed_start_step": trainer.step - (len(steps) - n_first),
           "resumed_end_step": trainer.step, "writes_first_run": first_writes,
           "writes": len(writes), "losses": losses,
           "launches_per_step": [st["launches"] for st in steps],
           "launches_expected_per_step": want,
           "param_checksum": param_checksum(trainer.params.values())}
    res["ok"] = bool(all(st["launches"] == want for st in steps) and all(np.isfinite(losses))
                     and n_first > 0 and len(steps) == 2 * n_first
                     and res["resumed_start_step"] == first_step)
    del trainer
    return res


def dp_main_meshes(root: str) -> None:
    """DP_MAIN_MESHES jittered icospheres of 320 faces, each its own .obj."""
    from edgerunner_tpu_torch.data import save_mesh_file
    from edgerunner_tpu_torch.data._procgen import icosphere

    os.makedirs(root)
    v, f = icosphere(2)
    rng = np.random.default_rng(SEED)
    for i in range(DP_MAIN_MESHES):
        save_mesh_file(os.path.join(root, f"m{i:02d}.obj"),
                       v * rng.uniform(0.5, 1.0, 3) + rng.normal(0, 0.02, v.shape), f)


def dp_ranks(dev, R) -> dict:
    """`dp_rank` on R spawned ranks (rank r on cuda:r % device_count): their
    results, the backend against `choose_backend`'s, and whether the
    training step's launches held and its parameters ended equal on every
    rank, and whether `main` under dp sharded the items disjoint and equal,
    wrote each checkpoint once (rank 0) and left equal parameters."""
    import tempfile

    import torch.multiprocessing as mp

    from edgerunner_tpu_torch.parallel import choose_backend

    with tempfile.TemporaryDirectory() as tmp:
        dp_main_meshes(os.path.join(tmp, "meshes"))
        t0 = time.perf_counter()
        mp.spawn(dp_rank, args=(R, tmp), nprocs=R, join=True)
        ranks = []
        for r in range(R):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        saved = [os.path.exists(os.path.join(tmp, ws, ep, "model.safetensors"))
                 for ws, ep in (("main_ws", "ep0000"), ("main_ws_resumed", "ep0001"))]
    sums = {rk["train"]["param_checksum"] for rk in ranks}
    mains = [rk["main"] for rk in ranks]
    items = [set(m["items"]) for m in mains]
    shard = (DP_MAIN_MESHES - 2) // R
    main_res = {
        "items_per_rank": [len(i) for i in items],
        "items_disjoint": len(set().union(*items)) == sum(len(i) for i in items),
        "writes_per_rank": [m["writes"] for m in mains], "checkpoints_saved": saved,
        "param_checksums_equal": len({m["param_checksum"] for m in mains}) == 1,
        "losses_equal": all(m["losses"] == mains[0]["losses"] for m in mains)}
    main_res["ok"] = bool(
        all(m["ok"] for m in mains) and main_res["items_per_rank"] == [shard] * R
        and main_res["items_disjoint"] and all(saved)
        and main_res["writes_per_rank"] == [2] + [0] * (R - 1)
        and mains[0]["writes_first_run"] == 1
        and main_res["param_checksums_equal"] and main_res["losses_equal"])
    res = {"ranks_s": time.perf_counter() - t0, "backend": ranks[0]["backend"],
           "expected_backend": choose_backend(dev, R),
           "train_param_checksums_equal": len(sums) == 1, "main": main_res, "ranks": ranks}
    res["ok"] = (res["backend"] == res["expected_backend"] and len(sums) == 1
                 and all(rk["train"]["ok"] for rk in ranks) and main_res["ok"])
    return res


def phase_dp(dev):
    """Data parallelism on the card: DP_RANKS ranks that share the card
    (gloo, pinned host staging), spawned from this process; a rank that
    fails fails the phase. (a) the full-width ArAE training step
    (`dp_train`), (b) the f32 parities of the LMM and the MDiT at 2 layers
    (`lmm_dp_parity`, `mdit_dp_parity`); the parameters' checksum must be
    equal on every rank; then `main` under dp (`dp_main`). Then, in this
    process, (d) the decode fleet (`fleet_generate`, then infer's path,
    `fleet_infer`) and (e) the engine fleet (`fleet_serve`). The dp x sp
    parity (c) runs in the sp phase's 4-rank spawn."""
    res = {"card": card_line(), **dp_ranks(dev, DP_RANKS)}
    ok = res["ok"] and res["ranks"][0]["parity"]["ok"] and res["ranks"][0]["mdit_parity"]["ok"]
    t1 = time.perf_counter()
    res["fleet"], model = fleet_generate(dev)
    res["fleet"]["seconds"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    res["infer_fleet"] = fleet_infer(dev, model)
    res["infer_fleet"]["seconds"] = time.perf_counter() - t2
    t3 = time.perf_counter()
    res["engine_fleet"] = fleet_serve(dev, model)
    res["engine_fleet"]["seconds"] = time.perf_counter() - t3
    res["ok"] = bool(ok and res["fleet"]["ok"] and res["infer_fleet"]["ok"]
                     and res["engine_fleet"]["ok"])
    return res


def dit_options(**changes):
    """The image pipeline's options: the ArAE preset with the LMM on the
    DiT's latents, as infer_dit and the pipeline server set it."""
    from edgerunner_tpu_torch.config import config_defaults, validate

    return validate(dataclasses.replace(config_defaults["ArAE"], cond_mode="point_latent",
                                        **changes))


def dit_image(size=512) -> np.ndarray:
    """[size, size, 3] in [0,1]: a procedural mesh's surface points rendered
    (render_points_image), the CLI's 512 x 512 input."""
    from edgerunner_tpu_torch.data._procgen import icosphere
    from edgerunner_tpu_torch.data.image_io import render_points_image
    from edgerunner_tpu_torch.ops.pointops import sample_surface_points

    v, f = icosphere(2)
    v = v * np.array([1.0, 0.6, 0.8])  # an ellipsoid: a shading that is not symmetric
    pts = sample_surface_points(v, f, 8192, np.random.default_rng(SEED))
    return render_points_image(pts, size=size)


def profile_ddim_step(model_dit, cond_cat, lat, t) -> dict:
    """Device time by kernel of one DDIM step (the DiT on 2R rows), and its
    share of the step's wall time (torch.profiler's CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    from edgerunner_tpu_torch.infer_dit import DDIM_STEPS, GUIDANCE_SCALE

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model_dit.denoise_step(lat, cond_cat, t, GUIDANCE_SCALE, DDIM_STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key[:60], e.device_time_total / 1e3) for e in prof.key_averages()
                      if e.device_type.name == "CUDA" and e.device_time_total > 0),
                     key=lambda x: -x[1])
    device_ms = sum(ms for _, ms in kernels)
    return {"profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "top_kernels_ms": kernels[:10],
            "flash_ms": sum(ms for k, ms in kernels if "flash_fwd" in k)}


def dit_cli(dev) -> dict:
    """infer_dit as the CLI runs it, f32, one group of DIT_REPEATS repeats."""
    import tempfile

    from edgerunner_tpu_torch import infer_dit
    from edgerunner_tpu_torch.data import save_mesh
    from edgerunner_tpu_torch.diffusion import ddim_timesteps
    from edgerunner_tpu_torch.generate import decode_shape, generate_tokens
    from edgerunner_tpu_torch.models.mdit import run_mdit
    from edgerunner_tpu_torch.ops import decode_attention as DA
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention
    from edgerunner_tpu_torch.utils import get_tokenizer

    opt = dit_options(test_batch_size=DIT_REPEATS, decode_bucket=CUT_BUCKET)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, model_dit = infer_dit.load_models(opt, dev)
    setup_s = time.perf_counter() - t0
    image = dit_image()[None]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.inference_mode():
        # warm-up: every library call of the DDIM loop and of get_cond
        run_mdit(model_dit, image, num_inference_steps=2, num_repeat=DIT_REPEATS, generator=gen)
        img = torch.as_tensor(image, device=dev)
        clip_ms = time_ms(lambda: model_dit.get_cond(img), 3)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t1 = time.perf_counter()
        latents = infer_dit.ddim_latents(model_dit, image, DIT_REPEATS, gen)
        torch.cuda.synchronize()
        ddim_s = time.perf_counter() - t1
        ddim_launches = flash_attention.launches
        want_ddim = 2 * opt.dit_num_layers * infer_dit.DDIM_STEPS

        num_new = decode_shape(opt, 1, FACES, DIT_BUDGET)[0]
        for fn in (flash_attention, *decode_wrappers()):
            fn.launches = 0
        t2 = time.perf_counter()
        tokens = generate_tokens(model, latents, num_faces=FACES, max_new_tokens=DIT_BUDGET,
                                 generator=gen, bench_no_eos=True)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t2
        launches = {"flash_attention_fwd": flash_attention.launches,
                    **{fn.__name__: fn.launches for fn in decode_wrappers()}}
        # the LMM's prefill (no point encoder) and one single-query decode per
        # layer and step, over the f32 cache (kernel B's f32 instance)
        want = {fn.__name__: 0 for fn in decode_wrappers()}
        want.update({"flash_attention_fwd": opt.num_layers,
                     "fused_decode_attention": opt.num_layers * (num_new - 1)})
        cond_cat = model_dit.prepare_cond_cfg(img).repeat_interleave(DIT_REPEATS, dim=0)
        ts = ddim_timesteps(model_dit.schedule, infer_dit.DDIM_STEPS)
        profile = profile_ddim_step(model_dit, cond_cat, latents, int(ts[len(ts) // 2]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokenizer, _ = get_tokenizer(opt)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dit_0.obj")
        verts, faces = save_mesh(tokens[0], opt, path, tokenizer=tokenizer, clean=True)
        obj_bytes = os.path.getsize(path)
    lat = latents.float()
    ok = (ddim_launches == want_ddim and launches == want
          and tuple(latents.shape) == (DIT_REPEATS, opt.point_latent_size, opt.point_latent_dim)
          and bool(torch.isfinite(lat).all()) and tokens.shape == (DIT_REPEATS, num_new)
          and not (tokens == 0).any() and not (tokens == 2).any()
          and bool(np.isfinite(verts).all()) and obj_bytes > 0
          and profile["device_ms"] > 0)
    mesh_s = ddim_s + decode_s
    return {"ok": ok, "dtype": "float32", "repeats": DIT_REPEATS, "image": list(image.shape),
            "clip_layers": opt.clip_num_layers, "clip_hidden": opt.clip_hidden_dim,
            "dit_layers": opt.dit_num_layers, "dit_hidden": opt.dit_hidden_dim,
            "lmm_layers": opt.num_layers, "lmm_hidden": opt.hidden_dim, "setup_s": setup_s,
            "clip_ms": clip_ms, "ddim_steps": infer_dit.DDIM_STEPS, "ddim_s": ddim_s,
            "ms_per_ddim_step": ddim_s / infer_dit.DDIM_STEPS * 1e3,
            "ddim_launches": {"flash_attention_fwd": ddim_launches},
            "ddim_launches_expected": want_ddim,
            "latents_std": lat.std().item(), "latents_max_abs": lat.abs().max().item(),
            "num_faces": FACES, "num_new": num_new, "decode_s": decode_s,
            "tokens_per_s": tokens.size / decode_s, "launches": launches,
            "launches_expected": want, "ddim_share_of_mesh": ddim_s / mesh_s,
            "mesh_s_per_group": mesh_s, "mesh0_vertices": int(len(verts)),
            "mesh0_faces": int(len(faces)), "mesh0_obj_bytes": obj_bytes,
            "peak_mem_gib": peak, "profiled_ddim_step": profile, "card": card_line()}


def dit_serve(dev) -> dict:
    """The server in pipeline mode, as `serve ArAE --resume2 ...` starts it
    (bf16 LMM, f32 MDiT, 100 DDIM steps at 7.5), with random weights from
    seed 0: /healthz, two /generate_image requests of [224][224][3] floats,
    a latent /generate, a malformed image body."""
    import threading

    from edgerunner_tpu_torch.serve import build_server

    opt = dataclasses.replace(dit_options(), cond_mode="point", test_batch_size=SERVE_ROWS)
    t0 = time.perf_counter()
    server, frontend = build_server(opt, port=0, device=str(dev), pipeline=True)
    setup_s = time.perf_counter() - t0
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    img = dit_image(opt.clip_image_size).tolist()
    try:
        health = http(port, "/healthz")
        answers = [None] * len(DIT_SERVE_FACES)

        def send(i):
            answers[i] = http(port, "/generate_image",
                              {"image": img, "num_faces": DIT_SERVE_FACES[i], "seed": i})

        t1 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(answers))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        images_s = time.perf_counter() - t1
        lat = np.random.default_rng(SEED).normal(
            size=(opt.point_latent_size, opt.point_latent_dim)).tolist()
        latent = http(port, "/generate", {"latents": lat, "num_faces": 10, "seed": 0})
        bad = http(port, "/generate_image", {"image": [[[0.0, 0.0, 0.0]], [[0.0]]]})
        statz = http(port, "/statz")
    finally:
        server.shutdown()
        server.server_close()
        frontend.shutdown()
        frontend.inner.engine.thread.join()
    keys = {"vertices", "faces", "tokens", "wall_s"}
    good = [a is not None and a[0] == 200 and set(a[1]) == keys | {"ddim_s"}
            and a[1]["ddim_s"] > 0
            and bool(np.isfinite(np.asarray(a[1]["vertices"], np.float64)).all())
            for a in answers]
    ok = (health == (200, {"ok": True, "cond_mode": "point_latent", "batch": SERVE_ROWS,
                           "pipeline": True})
          and all(good) and latent[0] == 200 and set(latent[1]) == keys and bad[0] == 400
          and statz[1].get("ddim_runs") == len(answers))
    return {"ok": ok, "setup_s": setup_s, "dit_steps": frontend.dit_steps,
            "num_faces": list(DIT_SERVE_FACES), "answers_ok": sum(good),
            "images_s": images_s,
            "ddim_s": [a[1].get("ddim_s") for a in answers if a and a[0] == 200],
            "wall_s": [a[1].get("wall_s") for a in answers if a and a[0] == 200],
            "tokens": [len(a[1]["tokens"]) for a in answers if a and a[0] == 200],
            "faces": [len(a[1]["faces"]) for a in answers if a and a[0] == 200],
            "latent_status": latent[0], "malformed_status": bad[0], "statz": statz[1]}


def phase_dit(dev):
    res = {"cli": dit_cli(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    res["serve"] = dit_serve(dev)
    res["ok"] = res["cli"]["ok"] and res["serve"]["ok"]
    return res


def phase_dit_parity(dev):
    """Kernel path against plain path for the image pipeline, f32 with TF32
    off, 2 DiT and 2 CLIP layers at full width, weights from a seed: the
    image condition (CLIP runs plain on both paths: within 1e-6 of its
    largest value), then the latents after a DIT_PARITY_STEPS-step DDIM run
    from the same noise (within LATENT_TOL of their largest value: the
    kernel's f32 sums in another order, ~1e-6, grown by guidance 7.5 over
    the steps); then `parity_run` of a 2-layer point_latent LMM on the
    plain path's latents."""
    from edgerunner_tpu_torch.models.mdit import MDiT, run_mdit
    from edgerunner_tpu_torch.weights import init_mdit_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = dit_options(dit_num_layers=2, clip_num_layers=2, num_layers=2,
                      generate_mode="greedy")
    kernel = init_mdit_weights(MDiT(opt, device=dev), SEED + 2).eval()
    plain = MDiT(opt, device=dev, use_kernels=False).eval()
    plain.load_state_dict(kernel.state_dict())
    image = dit_image()[None]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    noise = torch.randn((DIT_PARITY_REPEATS, opt.point_latent_size, opt.point_latent_dim),
                        generator=gen, device=dev)
    with torch.inference_mode():
        img = torch.as_tensor(image, device=dev)
        cond_k, cond_p = kernel.get_cond(img), plain.get_cond(img)
        lat_k, lat_p = (run_mdit(m, image, num_inference_steps=DIT_PARITY_STEPS,
                                 num_repeat=DIT_PARITY_REPEATS, noise=noise)
                        for m in (kernel, plain))
    cond_err = (cond_k - cond_p).abs().max().item()
    cond_ok = cond_err <= 1e-6 * cond_p.abs().max().item()
    lat_err = (lat_k - lat_p).abs().max().item()
    lat_scale = lat_p.abs().max().item()
    lat_ok = bool(torch.isfinite(lat_k).all()) and lat_err <= LATENT_TOL * lat_scale
    del kernel, plain
    torch.cuda.empty_cache()
    lmm = parity_run(dev, PARITY_STEPS, conds=lat_p.cpu().numpy(), cond_mode="point_latent")
    return {"ok": cond_ok and lat_ok and lmm["ok"], "dit_layers": 2, "clip_layers": 2,
            "dtype": "float32", "tf32": False, "cond_max_abs_err": cond_err,
            "ddim_steps": DIT_PARITY_STEPS, "latents_max_abs_err": lat_err,
            "latents_max_abs": lat_scale,
            "latents_tolerance": f"|err| <= {LATENT_TOL} * {lat_scale:.4g}", "lmm": lmm}


# --------------------------------------------------------------- dit train --

def dit_train_args(workspace: str) -> list:
    """main_dit's command line in the dit_train phase: the DiT preset at full
    width (its batch, bf16 autocast, checkpointing), synthetic data, one epoch."""
    return ["DiT", "--data_root", os.path.join(workspace, "absent"), "--workspace", workspace,
            "--synthetic_size", str(DIT_TRAIN_SAMPLES), "--num_epochs", "1",
            "--seed", str(SEED)]


def kernel_kinds(kernels) -> dict:
    """Device ms of a profile's kernels by kind: kernel A, kernel C, the
    GEMMs (cuBLAS's kernels), and the rest (elementwise, reductions, norms)."""
    kinds = {"flash_fwd": 0.0, "flash_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms in kernels:
        low = name.lower()
        if "flash_fwd" in low:
            kinds["flash_fwd"] += ms
        elif "flash_bwd" in low:
            kinds["flash_bwd"] += ms
        elif any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass")):
            kinds["gemm"] += ms
        else:
            kinds["other"] += ms
    return kinds


def profile_dit_train_step(trainer, batch) -> dict:
    """One more training step under torch.profiler: device time by kernel
    and kind; the optimizer's update (elementwise kernels, counted in
    'other') also alone: the device time of the kernels launched in its
    profiler range, and the time from CUDA events around it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    update, spans = trainer.optimizer.update, []

    def timed_update(grads):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        with record_function("optimizer_update"):
            out = update(grads)
        b.record()
        spans.append((a, b))
        return out

    trainer.optimizer.update = timed_update
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        del trainer.optimizer.update
    # the range appears twice: on the host, with the device time of the
    # kernels launched in it, and on the device as an annotation spanning
    # them, which is no kernel
    events = prof.key_averages()
    kernels = sorted(((e.key, e.device_time_total / 1e3) for e in events
                      if e.device_type.name == "CUDA" and e.device_time_total > 0
                      and e.key != "optimizer_update"), key=lambda x: -x[1])
    device_ms = sum(ms for _, ms in kernels)
    return {"profiled_wall_ms": wall_ms, "profiled_device_ms": device_ms,
            "profiled_device_busy_share": device_ms / wall_ms,
            "device_ms_by_kind": kernel_kinds(kernels),
            "optimizer_device_ms": sum(e.device_time_total for e in events
                                       if e.key == "optimizer_update"
                                       and e.device_type.name == "CPU") / 1e3,
            "optimizer_ms_cuda_events": spans[0][0].elapsed_time(spans[0][1]),
            "top_kernels_ms": [(k[:60], ms) for k, ms in kernels[:16]]}


@contextlib.contextmanager
def counted_train_steps(steps: list, snapshot: dict):
    """`Trainer.train_step` patched inside: each step's seconds, metrics and
    kernel A's and C's launches (counted from 0) appended to `steps`, and
    the parameters before the first step copied into `snapshot`."""
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from edgerunner_tpu_torch.train.trainer import Trainer

    original = Trainer.train_step

    def counted_step(self, batch):
        if not snapshot:
            snapshot.update({n: p.detach().cpu() for n, p in self.model.named_parameters()})
        flash_attention.launches = flash_attention_bwd.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = original(self, batch)
        torch.cuda.synchronize()
        steps.append({"s": time.perf_counter() - t1, **m, "launches": {
            "flash_attention_fwd": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches}})
        return m

    Trainer.train_step = counted_step
    try:
        yield
    finally:
        Trainer.train_step = original


def frozen_and_unmoved(trainer, snapshot: dict) -> tuple:
    """(the frozen parameters' names, whether each is bit-unchanged since
    `snapshot`, the trainable parameters that did not move)."""
    frozen = [n for n in snapshot if n not in trainer.params]
    frozen_same = bool(frozen) and all(
        torch.equal(p.detach().cpu(), snapshot[n])
        for n, p in trainer.model.named_parameters() if n in frozen)
    unmoved = [n for n, p in trainer.params.items()
               if torch.equal(p.detach().cpu(), snapshot[n])]
    return frozen, frozen_same, unmoved


def phase_dit_train(dev):
    """DiT training as `python -m edgerunner_tpu_torch.main_dit DiT` runs it,
    full width (CLIP ViT-H/14 and the point encoder frozen; the DiT 24 x
    1024), random weights from seed 0, the preset's batch on synthetic data
    for one epoch in a temporary workspace (deleted afterwards): one warm-up
    and four timed steps, each step's launches counted from 0 and held to
    kernel A 2 x 2 x 24 + 1 (each attention's forward and its replay under
    checkpointing, and the frozen point encoder) and kernel C 2 x 24; frozen
    parameters bit-unchanged, every trainable one moved. Then the saved
    checkpoint loads strictly into a fresh MDiT (weights equal to the
    trainer's) and samples finite latents in a short DDIM run; one profiled
    step; and DIT_PROBE_STEPS timed steps at bench.py's dit_train_probe batch."""
    import dataclasses as dc
    import shutil
    import tempfile

    from edgerunner_tpu_torch import main_dit
    from edgerunner_tpu_torch.data.dataset_dit import DiTMeshDataset, collate_dit
    from edgerunner_tpu_torch.models.mdit import MDiT, run_mdit
    from edgerunner_tpu_torch.weights import load_mdit

    workspace = tempfile.mkdtemp(prefix="chip_smoke_dit_train_")
    steps, snapshot = [], {}
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with counted_train_steps(steps, snapshot):
            trainer = main_dit.main(dit_train_args(workspace))
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        opt = trainer.opt
        L = opt.dit_num_layers
        want = {"flash_attention_fwd": 2 * 2 * L + 1, "flash_attention_bwd": 2 * L}
        timed = steps[1:]
        s_per_it = sum(st["s"] for st in timed) / max(len(timed), 1)
        losses = [st["loss"] for st in steps]
        n_trainable = len(trainer.params)
        frozen, frozen_same, unmoved = frozen_and_unmoved(trainer, snapshot)
        snapshot.clear()
        # the saved checkpoint, strictly into a fresh MDiT, then a short DDIM run
        ckpt = os.path.join(workspace, "model.safetensors")
        fresh = load_mdit(MDiT(opt, device=dev), dc.replace(opt, resume2=ckpt))
        ckpt_same = all(torch.equal(a, b) for a, b in zip(
            fresh.state_dict().values(), trainer.model.state_dict().values()))
        with torch.inference_mode():
            lat = run_mdit(fresh, dit_image(opt.clip_image_size)[None],
                           num_inference_steps=DIT_DDIM_CHECK_STEPS,
                           generator=torch.Generator(device=dev).manual_seed(SEED)).float()
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
        ds = DiTMeshDataset(opt, training=True)
        batch = collate_dit([ds[i] for i in range(DIT_TRAIN_ROWS)], opt)
        prof = profile_dit_train_step(trainer, batch)
        # bench.py's dit_train_probe batch (bench.py:225-230)
        rng = np.random.default_rng(0)
        probe = {"images": rng.uniform(0, 1, (DIT_PROBE_ROWS, opt.clip_image_size,
                                              opt.clip_image_size, 3)).astype(np.float32),
                 "points": rng.normal(size=(DIT_PROBE_ROWS, opt.point_num, 3)).astype(np.float32)}
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(probe)  # warm-up at this batch
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        probe_losses = [trainer.train_step(probe)["loss"] for _ in range(DIT_PROBE_STEPS)]
        torch.cuda.synchronize()
        probe_s = (time.perf_counter() - t2) / DIT_PROBE_STEPS
        probe_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del trainer
    finally:
        shutil.rmtree(workspace, ignore_errors=True)
    counts_ok = len(steps) == DIT_TRAIN_SAMPLES // DIT_TRAIN_ROWS and all(
        st["launches"] == want for st in steps)
    ok = (counts_ok and all(np.isfinite(losses)) and all(np.isfinite(probe_losses))
          and frozen_same and not unmoved and ckpt_same
          and tuple(lat.shape) == (1, opt.point_latent_size, opt.point_latent_dim)
          and bool(torch.isfinite(lat).all()) and prof["profiled_device_ms"] > 0)
    return {"ok": ok, "rows": DIT_TRAIN_ROWS, "samples": DIT_TRAIN_SAMPLES,
            "dit_layers": L, "dit_hidden": opt.dit_hidden_dim, "clip_layers": opt.clip_num_layers,
            "clip_hidden": opt.clip_hidden_dim, "latents": [opt.point_latent_size,
                                                            opt.point_latent_dim],
            "point_num": opt.point_num, "autocast": opt.mixed_precision,
            "checkpointing": opt.checkpointing, "run_s": run_s, "warmup_s": steps[0]["s"],
            "timed_steps": len(timed), "s_per_it": s_per_it,
            "samples_per_s": DIT_TRAIN_ROWS / s_per_it, "peak_mem_gib": peak,
            "losses": losses, "grad_norms": [st["grad_norm"] for st in steps],
            "launches_per_step": [st["launches"] for st in steps],
            "launches_expected_per_step": want,
            "launches": {k: sum(st["launches"][k] for st in steps) for k in want},
            "frozen_tensors": len(frozen), "frozen_bit_unchanged": frozen_same,
            "trainable_tensors": n_trainable, "trainable_unmoved": unmoved,
            "checkpoint_loads_strictly_equal": ckpt_same,
            "ddim_check_steps": DIT_DDIM_CHECK_STEPS, "ddim_latents_std": lat.std().item(),
            **prof, "probe_rows": DIT_PROBE_ROWS, "probe_steps": DIT_PROBE_STEPS,
            "probe_s_per_it": probe_s, "probe_samples_per_s": DIT_PROBE_ROWS / probe_s,
            "probe_peak_mem_gib": probe_peak, "probe_losses": probe_losses,
            "card": card_line()}


def phase_dit_train_parity(dev):
    """Kernel path against plain path of the DiT training loss and every
    trainable gradient: 2 DiT and 2 CLIP layers at full width in f32 (TF32
    off), the point encoder at full width, the same weights, the same
    DIT_PARITY_ROWS synthetic samples and the same draws (condition dropout,
    noise, timesteps), checkpointing on. This runs kernel A's 3xTF32
    instance and kernel C's scalar f32 instance at D 64, self (2048 keys)
    and cross (257 keys). Tolerance as train_parity's: the loss within 1e-5
    relative, each gradient within GRAD_TOL of its largest plain value plus
    1e-6 of the model's largest plain gradient (the key projections' biases
    hold only rounding noise)."""
    from edgerunner_tpu_torch.config import config_defaults
    from edgerunner_tpu_torch.data.dataset_dit import DiTMeshDataset, collate_dit
    from edgerunner_tpu_torch.models.mdit import MDiT
    from edgerunner_tpu_torch.train.state import frozen_param_keys, trainable_parameters
    from edgerunner_tpu_torch.weights import init_mdit_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = dataclasses.replace(config_defaults["DiT"], dit_num_layers=2, clip_num_layers=2,
                              mixed_precision="no", synthetic_size=DIT_PARITY_ROWS)
    kernel = init_mdit_weights(MDiT(opt, device=dev), SEED + 3)
    plain = MDiT(opt, device=dev, use_kernels=False)
    plain.load_state_dict(kernel.state_dict())
    ds = DiTMeshDataset(opt, training=True)
    batch = collate_dit([ds[i] for i in range(DIT_PARITY_ROWS)], opt)
    images, points = (torch.as_tensor(batch[k], device=dev) for k in ("images", "points"))
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    R = DIT_PARITY_ROWS
    keep = torch.rand((R, 1, 1), generator=g, device=dev) >= 0.1
    noise = torch.randn((R, opt.point_latent_size, opt.point_latent_dim), generator=g,
                        device=dev)
    t = torch.randint(0, 1000, (R,), generator=g, device=dev)

    def loss_and_grads(model):
        params = trainable_parameters(model, frozen_param_keys(opt, "dit"))
        out = model(images, points, train=True, keep=keep, noise=noise, t=t)
        return out["loss"].item(), dict(zip(params, torch.autograd.grad(
            out["loss"], list(params.values()))))

    (lk, gk), (lp, gp) = (loss_and_grads(m) for m in (kernel, plain))
    worst, worst_name, top = grad_err_over_tol(gk, gp)
    loss_err = abs(lk - lp) / abs(lp)
    ok = loss_err <= 1e-5 and worst <= 1.0 and all(
        torch.isfinite(g).all().item() for g in gk.values())
    return {"ok": ok, "dit_layers": 2, "clip_layers": 2, "rows": R, "dtype": "float32",
            "tf32": False, "keep": keep.flatten().tolist(), "t": t.tolist(),
            "loss_kernel": lk, "loss_plain": lp, "loss_rel_err": loss_err,
            "grad_tensors": len(gp), "grad_max_abs": top, "grad_worst_err_over_tol": worst,
            "grad_worst_tensor": worst_name,
            "tolerance": f"loss rel <= 1e-5; per tensor max|dg| <= {GRAD_TOL} * max|g_plain| "
                         "+ 1e-6 * max over tensors of max|g_plain|"}


# ------------------------------------------------------------------- image --

def image_options(**changes):
    """The default preset (cond_mode 'image': CLIP ViT-H/14, 257 condition
    tokens, the decoder 24 x 1024 with 16 heads of 64), as `infer default`
    and `main default` take it."""
    from edgerunner_tpu_torch.config import config_defaults, validate

    return validate(dataclasses.replace(config_defaults["default"], **changes))


def image_train_batch(opt, rows: int, lengths=None) -> dict:
    """`train_batch` of the image-conditioned ArAE: its tokens and labels
    after CLIP's 257 condition tokens (4355 positions a row), and as each
    row's condition the procedural mesh's point-splat render at CLIP's size."""
    images = np.repeat(dit_image(opt.clip_image_size)[None], rows, axis=0)
    return dict(train_batch(opt, rows, lengths), conds=images)


def phase_image(dev):
    """The image-conditioned ArAE as `python -m edgerunner_tpu_torch.infer
    default` runs it: the default preset at full width, bf16, random weights
    from seed 0 (`infer.load_model`), the CLI's sampling, ROWS rows of the
    512 x 512 render `dit_image()`, 1000 faces, EOS forbidden, and an
    IMAGE_BUDGET-token budget: cut for time from the CLI's 5120 tokens
    (1000 x 5 + 64, rounded up to the 1024-token bucket; kernel B's case in
    the kernels phase runs at that budget's cache, 5632 rows).
    CLIP ms per image, prefill s, tokens/s, ms per step, peak memory; the
    launches held exactly, counted from 0 over the generate call: kernel A
    once per decoder layer in the prefill (the CLIP tower attends plainly,
    at head dim 80), kernel B once per layer and decode step, no other
    decode kernel. A profiled segment of PROFILE_STEPS steps gives device ms per step.
    Then infer's own path after the image's read (`infer.generate_meshes`)
    on one image, as `infer default --test_max_seq_length 256
    --decode_bucket 256` runs it, writes a .ply and its tokens."""
    import tempfile

    from edgerunner_tpu_torch import infer
    from edgerunner_tpu_torch.generate import generate_tokens
    from edgerunner_tpu_torch.models.clip_vit import preprocess_images
    from edgerunner_tpu_torch.ops.flash_attention import flash_attention
    from edgerunner_tpu_torch.utils import get_tokenizer

    opt = image_options()
    num_new, max_len = decode_shape_of(opt, IMAGE_BUDGET)
    t0 = time.perf_counter()
    model = infer.load_model(opt, dev)
    setup_s = time.perf_counter() - t0
    image = dit_image()
    images = np.repeat(image[None], ROWS, axis=0)
    nf = torch.full((ROWS,), FACES, device=dev)
    prompt = torch.full((ROWS, 1), opt.bos_token_id, device=dev)
    with torch.inference_mode():
        one = torch.as_tensor(image[None], device=dev)
        clip_ms = time_ms(lambda: model.image_encoder(
            preprocess_images(one, size=opt.clip_image_size)), 3)
        imgs = torch.as_tensor(images, device=dev)
        for _ in range(2):  # warm-up, then the prefill's time
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.prefill(imgs, nf, prompt, max_len)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    for fn in (flash_attention, *decode_wrappers()):
        fn.launches = 0
    t2 = time.perf_counter()
    tokens = generate_tokens(model, images, num_faces=FACES, max_new_tokens=IMAGE_BUDGET,
                             generator=torch.Generator(device=dev).manual_seed(SEED),
                             bench_no_eos=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t2
    launches = {"flash_attention_fwd": flash_attention.launches,
                **{fn.__name__: fn.launches for fn in decode_wrappers()}}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {fn.__name__: 0 for fn in decode_wrappers()}
    want.update({"flash_attention_fwd": opt.num_layers,
                 "fused_decode_attention": opt.num_layers * (num_new - 1)})
    res = {"rows": ROWS, "num_faces": FACES, "num_new": num_new, "max_len": max_len,
           "prompt_len": 1 + opt.num_cond_tokens, "layers": opt.num_layers,
           "hidden": opt.hidden_dim, "heads": opt.num_heads, "clip_layers": opt.clip_num_layers,
           "clip_hidden": opt.clip_hidden_dim, "image": list(image.shape), "dtype": "bfloat16",
           "generate_mode": opt.generate_mode, "setup_s": setup_s,
           "clip_ms_per_image": clip_ms, "prefill_s": prefill_s, "generate_s": gen_s,
           "ms_per_step": (gen_s - prefill_s) / (num_new - 1) * 1e3,
           "tokens_per_s": tokens.size / gen_s, "peak_mem_gib": peak, "launches": launches,
           "launches_expected": want, "card": card_line()}
    res.update(profile_decode(model, opt, dev, images, max_len, res["prompt_len"] + num_new // 2))
    # infer's path after the read, as the CLI runs it with a short budget
    cli_opt = dataclasses.replace(opt, test_max_seq_length=IMAGE_CLI_BUDGET,
                                  decode_bucket=IMAGE_CLI_BUDGET)
    model.opt = cli_opt
    tokenizer, _ = get_tokenizer(opt)
    with tempfile.TemporaryDirectory() as tmp:
        t3 = time.perf_counter()
        written = infer.generate_meshes(dataclasses.replace(cli_opt, workspace=tmp), model,
                                        tokenizer, "image", image[None],
                                        torch.Generator(device=dev).manual_seed(SEED))
        cli_s = time.perf_counter() - t3
        cli_tokens = np.load(os.path.join(tmp, "image_0_tokens.npy"))
        ply_bytes = [os.path.getsize(p) for p in written]
    res.update(cli_s=cli_s, cli_tokens=int(len(cli_tokens)), cli_ply_bytes=ply_bytes)
    res["ok"] = (launches == want and tokens.shape == (ROWS, num_new)
                 and not (tokens == 0).any() and not (tokens == 2).any()
                 and res["device_ms_per_step"] > 0 and len(ply_bytes) == 1
                 and ply_bytes[0] > 0 and 0 < len(cli_tokens) <= IMAGE_CLI_BUDGET)
    return res


def phase_image_parity(dev):
    """Kernel path against plain path of the image-conditioned ArAE, f32 with
    TF32 off, 2 decoder and 2 CLIP layers at full width: `parity_run`'s
    greedy streams of two images (`dit_image()` and its mirror) over
    PARITY_CUT_STEPS steps, up to near-ties; then one training step's loss
    and gradients on `image_train_batch` (2 rows, the second cut to
    IMAGE_RAGGED_LEN), tolerance as train_parity's: the loss within 1e-5
    relative, each trainable gradient within GRAD_TOL of its largest plain
    value plus 1e-6 of the model's largest plain gradient; and no gradient
    reaches the frozen tower on either path."""
    from edgerunner_tpu_torch.models.lmm import LMM, init_weights

    image = dit_image()
    conds = np.stack([image, np.ascontiguousarray(image[:, ::-1])])
    stream = parity_run(dev, PARITY_CUT_STEPS, conds=conds, preset="default",
                        clip_num_layers=2, decode_bucket=CUT_BUCKET)
    opt = image_options(num_layers=2, clip_num_layers=2, mixed_precision="no")
    kernel = init_weights(LMM(opt, device=dev), SEED + 5)
    plain = LMM(opt, device=dev, use_kernels=False)
    plain.load_state_dict(kernel.state_dict())
    batch = image_train_batch(opt, 2, lengths=[train_positions(opt), IMAGE_RAGGED_LEN])
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def loss_and_grads(model):
        o = model(b["conds"], b["tokens"], b["labels"], b["num_faces"], b["lengths"],
                  train=False)
        params = dict(model.named_parameters())
        return o["loss"].item(), dict(zip(params, torch.autograd.grad(
            o["loss"], list(params.values()), allow_unused=True)))

    (lk, gk), (lp, gp) = (loss_and_grads(m) for m in (kernel, plain))
    tower = [n for n in gk if n.startswith("image_encoder.")]
    tower_free = bool(tower) and all(gk[n] is None and gp[n] is None for n in tower)
    gk, gp = ({n: g for n, g in gs.items() if n not in tower} for gs in (gk, gp))
    worst, worst_name, top = grad_err_over_tol(gk, gp)
    loss_err = abs(lk - lp) / abs(lp)
    ok = (stream["ok"] and tower_free and loss_err <= 1e-5 and worst <= 1.0
          and all(torch.isfinite(g).all().item() for g in gk.values()))
    return {"ok": ok, "layers": 2, "clip_layers": 2, "dtype": "float32", "tf32": False,
            "streams": stream, "train_rows": 2, "lengths": batch["lengths"].tolist(),
            "loss_kernel": lk, "loss_plain": lp, "loss_rel_err": loss_err,
            "grad_tensors": len(gp), "grad_max_abs": top, "grad_worst_err_over_tol": worst,
            "grad_worst_tensor": worst_name, "tower_tensors": len(tower),
            "tower_takes_no_gradient": tower_free,
            "tolerance": f"loss rel <= 1e-5; per tensor max|dg| <= {GRAD_TOL} * max|g_plain| "
                         "+ 1e-6 * max over tensors of max|g_plain|"}


def image_train_args(workspace: str) -> list:
    """main's command line in the image_train phase: the default preset at
    full width (its batch, bf16 autocast, checkpointing), synthetic data, one
    epoch."""
    return ["default", "--data_root", os.path.join(workspace, "absent"), "--workspace",
            workspace, "--synthetic_size", str(IMAGE_TRAIN_SAMPLES), "--num_epochs", "1",
            "--seed", str(SEED)]


def phase_image_train(dev):
    """Training of the image-conditioned ArAE as `python -m
    edgerunner_tpu_torch.main default` runs it: full width (CLIP ViT-H/14
    frozen, the decoder 24 x 1024 with 16 heads of 64), random weights from
    seed 0, the preset's batch of 4, bf16 autocast, checkpointing, synthetic
    meshes with point-splat renders for one epoch in a temporary workspace
    outside the repository (deleted afterwards; a save holds ~3.8 GB of f32
    weights): one warm-up and three timed steps, each step's launches
    counted from 0 and held to kernel A 2 x 24 (each layer's forward and its
    replay under checkpointing) and kernel C 24; the tower bit-unchanged and
    every trainable tensor moved; the saved checkpoint loads strictly into a
    fresh LMM, equal to the trainer's weights at the end of the epoch. Then
    IMAGE_PROBE_STEPS timed steps after a warm-up on bench.py's train rows
    at 4 x 4355 positions (`image_train_batch`), launches held there too:
    s/it, tokens/s, peak memory, and one profiled step's busy share."""
    import shutil
    import tempfile

    from edgerunner_tpu_torch import main as main_cli
    from edgerunner_tpu_torch.models.lmm import LMM
    from edgerunner_tpu_torch.weights import load_state, read_safetensors

    workspace = tempfile.mkdtemp(prefix="chip_smoke_image_train_")
    steps, snapshot = [], {}
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with counted_train_steps(steps, snapshot):
            trainer = main_cli.main(image_train_args(workspace))
            run_s = time.perf_counter() - t0
            opt, n_trainable = trainer.opt, len(trainer.params)
            n_epoch = len(steps)
            # the saved checkpoint, before the probe steps move the weights
            fresh = LMM(opt, device=dev)
            load_state(fresh, read_safetensors(os.path.join(workspace, "model.safetensors")))
            ckpt_same = all(torch.equal(a, b) for a, b in zip(
                fresh.state_dict().values(), trainer.model.state_dict().values()))
            del fresh
            gc.collect()
            torch.cuda.empty_cache()
            probe = image_train_batch(opt, IMAGE_TRAIN_ROWS)
            trainer.train_step(probe)  # warm-up at this batch
            probe_steps = [trainer.train_step(probe) for _ in range(IMAGE_PROBE_STEPS)]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        L = opt.num_layers
        want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L}
        epoch_steps, probe_runs = steps[:n_epoch], steps[n_epoch + 1:]
        s_per_it = sum(st["s"] for st in epoch_steps[1:]) / max(len(epoch_steps) - 1, 1)
        probe_s = sum(st["s"] for st in probe_runs) / len(probe_runs)
        T = train_positions(opt)
        frozen, frozen_same, unmoved = frozen_and_unmoved(trainer, snapshot)
        snapshot.clear()
        prof = profile_train(trainer, probe)
        del trainer
    finally:
        shutil.rmtree(workspace, ignore_errors=True)
    losses = [st["loss"] for st in steps]
    counts_ok = (n_epoch == IMAGE_TRAIN_SAMPLES // IMAGE_TRAIN_ROWS
                 and all(st["launches"] == want for st in steps))
    ok = (counts_ok and all(np.isfinite(losses)) and frozen_same and not unmoved and ckpt_same
          and len(probe_steps) == IMAGE_PROBE_STEPS and prof["profiled_device_ms"] > 0)
    return {"ok": ok, "rows": IMAGE_TRAIN_ROWS, "samples": IMAGE_TRAIN_SAMPLES,
            "layers": L, "hidden": opt.hidden_dim, "heads": opt.num_heads,
            "clip_layers": opt.clip_num_layers, "clip_hidden": opt.clip_hidden_dim,
            "autocast": opt.mixed_precision, "checkpointing": opt.checkpointing,
            "run_s": run_s, "warmup_s": epoch_steps[0]["s"],
            "timed_steps": len(epoch_steps) - 1, "s_per_it": s_per_it,
            "peak_mem_gib": peak, "losses": losses,
            "grad_norms": [st["grad_norm"] for st in steps],
            "launches_per_step": [st["launches"] for st in steps],
            "launches_expected_per_step": want,
            "frozen_tensors": len(frozen), "frozen_bit_unchanged": frozen_same,
            "trainable_tensors": n_trainable,
            "trainable_unmoved": unmoved, "checkpoint_loads_strictly_equal": ckpt_same,
            "probe_positions": T, "probe_steps": IMAGE_PROBE_STEPS,
            "probe_s_per_it": probe_s, "probe_tokens_per_s": IMAGE_TRAIN_ROWS * T / probe_s,
            **prof, "card": card_line()}


def kernels_line(results):
    """One entry per kernel: main-path numbers from this run; launches from
    the path that runs it, each counted from 0 over its run: the generate
    path (forward and decode kernels), the train path (backward kernel; its
    f32 steps in launches_by_path), the
    generate path over the int8 cache (row 8) and over the int4 cache (row
    7), and the serving engine (rows 9, 11 and 10); launches_by_path adds
    the speculative paths (rows 9 and 10 at T = 3) and the image pipeline
    (kernel A in one DDIM run and in the f32 prefill, kernel B's f32
    decode), DiT training (kernels A and C, per step) and the
    image-conditioned ArAE (kernels A and B in its generate call, A and C
    per training step), and data parallelism (A and C per step and rank of
    the dp training step, A and B in the decode fleet's call, D in the
    engine fleet's requests)."""
    kern, gen, train, serve, spec, sp, dp = (results[k] for k in (
        "kernels", "generate", "train", "serve", "spec", "sp", "dp"))
    dp_train_step = dp["ranks"][0]["train"]["launches_per_step"][-1]
    fleet, engine_fleet = dp["fleet"]["launches"], dp["engine_fleet"]["launches"]
    dit_train = results["dit_train"]["launches_per_step"][-1]
    dit = results["dit"]["cli"]
    image, image_train = results["image"], results["image_train"]["launches_per_step"][-1]
    gen_q8, gen_q4 = results["generate_q8"], results["generate_q4"]
    def case(cases, prefix):
        return next(c for c in cases if c["case"].startswith(prefix))

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    # the decode kernels' other timings; the f32 flash cases' bound on the CUDA cores
    extra = ("ms_device", "ms_l2_flushed", "bound_ms_cuda_cores")

    def sub(c):
        return {"shape": c["shape"], "max_abs_err": c["max_abs_err"], **{k: c[k] for k in keys},
                **{k: c[k] for k in extra if k in c}}

    def entry(name, source, replaces, launches, c, **more):
        if source == "flash_fwd.cu":
            more = {"route_detail": "cuda, mma.sync bf16; mma.sync 3xTF32 f32", **more}
        elif source == "flash_bwd.cu":
            more = {"route_detail": "cuda, mma.sync bf16; mma.sync 3xTF32 f32", **more}
        more = {**{k: c[k] for k in extra if k in c}, **more}
        return {"name": name, "route": "cuda", "source": f"edgerunner_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": c["max_abs_err"],
                **{k: c[k] for k in keys}, "shape": c["shape"], **more}

    prefill, bwd = case(kern["flash"], "prefill"), case(kern["flash_bwd"], "decoder train")
    dec = next(c for c in kern["decode"] if c["case"].startswith("index")
               and "main path" in c["case"])
    multi = kern["decode_multi"]
    bench_bf16, bench_q8, bench_q4 = (serve[k] for k in (
        "bench_bf16", "bench_int8_wquant", "bench_int4"))

    def by_path(name, **paths):
        return {path: run["launches"][name] for path, run in paths.items()}

    # row 5: launches of the sp train path's timed steps, over both ranks
    sp_ranks = sp[f"R{SP_TRAIN_RANKS}"]["ranks"]

    def sp_launches(name):
        return sum(rk["train"]["launches"][name] for rk in sp_ranks)

    lse = kern["flash_lse"]
    lse_main = case(lse, f"ring R={SP_TRAIN_RANKS} off-diagonal bfloat16")
    lse_diag = case(lse, f"ring R={SP_TRAIN_RANKS} diagonal bfloat16")
    lse_r4 = case(lse, "ring R=4 off-diagonal bfloat16")
    return {"kernels": [
        entry("flash_attention_fwd", "flash_fwd.cu", "edgerunner_tpu/ops/flash_attention.py:258",
              gen["launches"]["flash_attention_fwd"], prefill,
              launches_by_path={"generate": gen["launches"]["flash_attention_fwd"],
                                "train": train["launches"]["flash_attention_fwd"],
                                "train_f32_per_step":
                                    train["f32"]["launches_per_step"][-1]["flash_attention_fwd"],
                                "dit_ddim": dit["ddim_launches"]["flash_attention_fwd"],
                                "dit_decode": dit["launches"]["flash_attention_fwd"],
                                "dit_train_per_step": dit_train["flash_attention_fwd"],
                                "image": image["launches"]["flash_attention_fwd"],
                                "image_train_per_step": image_train["flash_attention_fwd"],
                                "dp_train_per_step_and_rank":
                                    dp_train_step["flash_attention_fwd"],
                                "dp_fleet": fleet["flash_attention_fwd"]},
              encoder_shape=sub(case(kern["flash"], "encoder (main")),
              train_decoder_shape=sub(case(kern["flash"], "decoder train")),
              train_encoder_shape=sub(case(kern["flash"], "encoder train")),
              f32_train_decoder_shape=sub(case(kern["flash"], "decoder train float32")),
              f32_train_encoder_shape=sub(case(kern["flash"], "encoder train float32")),
              **{f"dit_{kind}_{dt}_shape": sub(case(kern["flash"], f"dit {kind} {dt}"))
                 for kind in ("self", "cross") for dt in ("float32", "bfloat16")},
              **{f"dit_train_{kind}_shape": sub(case(kern["flash"], f"dit train {kind}"))
                 for kind in ("self", "cross")},
              image_prefill_shape=sub(case(kern["flash"], "image prefill")),
              image_train_shape=sub(case(kern["flash"], "image decoder train"))),
        entry("fused_decode_attention", "decode_attention.cu",
              "edgerunner_tpu/ops/decode_attention_pallas.py:139",
              gen["launches"]["fused_decode_attention"], dec, index=dec["index"],
              launches_by_path={"generate": gen["launches"]["fused_decode_attention"],
                                "dit_decode_f32": dit["launches"]["fused_decode_attention"],
                                "image": image["launches"]["fused_decode_attention"],
                                "dp_fleet": fleet["fused_decode_attention"]},
              image_d64_shape=sub(case(kern["decode"], "image index"))),
        entry("flash_attention_bwd", "flash_bwd.cu", "edgerunner_tpu/ops/flash_attention.py:520",
              train["launches"]["flash_attention_bwd"], bwd, lengths=bwd["kv_len"],
              launches_by_path={"train": train["launches"]["flash_attention_bwd"],
                                "train_f32_per_step":
                                    train["f32"]["launches_per_step"][-1]["flash_attention_bwd"],
                                "dit_train_per_step": dit_train["flash_attention_bwd"],
                                "image_train_per_step": image_train["flash_attention_bwd"],
                                "dp_train_per_step_and_rank":
                                    dp_train_step["flash_attention_bwd"]},
              encoder_shape=sub(case(kern["flash_bwd"], "encoder train")),
              **{f"dit_train_{kind}_shape": sub(case(kern["flash_bwd"], f"dit train {kind}"))
                 for kind in ("self", "cross")},
              image_train_shape=sub(case(kern["flash_bwd"], "image decoder train")),
              f32_shape=sub(case(kern["flash_bwd"], "dit self float32")),
              f32_train_decoder_shape=sub(case(kern["flash_bwd"], "decoder train float32")),
              f32_train_encoder_shape=sub(case(kern["flash_bwd"], "encoder train float32"))),
        entry("fused_decode_attention_multi", "decode_attention_multi.cu",
              "edgerunner_tpu/ops/decode_attention_pallas.py:585",
              bench_bf16["launches"]["fused_decode_attention_multi"],
              case(multi, "engine bf16 T=1"), index=case(multi, "engine bf16 T=1")["index"],
              launches_by_path={**by_path("fused_decode_attention_multi", serve=bench_bf16,
                                          spec_generate=spec["generate_bf16"],
                                          spec_engine=spec["engine_bf16"]),
                                "dp_engine_fleet": engine_fleet["fused_decode_attention_multi"]},
              t3_shape=sub(case(multi, "engine bf16 T=3")),
              f32_shape=sub(case(multi, "engine f32 T=1"))),
        entry("fused_decode_attention_q8_multi", "decode_attention_quant.cu",
              "edgerunner_tpu/ops/decode_attention_pallas.py:866",
              bench_q8["launches"]["fused_decode_attention_q8_multi"],
              case(multi, "engine int8 T=1"), index=case(multi, "engine int8 T=1")["index"],
              t3_shape=sub(case(multi, "engine int8 T=3"))),
        entry("fused_decode_attention_q8", "decode_attention_quant.cu",
              "edgerunner_tpu/ops/decode_attention_pallas.py:445",
              gen_q8["launches"]["fused_decode_attention_q8"],
              case(multi, "generate q8 index"), index=case(multi, "generate q8 index")["index"]),
        entry("fused_decode_attention_q4_multi", "decode_attention_quant.cu",
              "edgerunner_tpu/ops/decode_attention_pallas.py:824",
              bench_q4["launches"]["fused_decode_attention_q4_multi"],
              case(multi, "engine int4 T=1"), index=case(multi, "engine int4 T=1")["index"],
              launches_by_path=by_path("fused_decode_attention_q4_multi", serve_int4=bench_q4,
                                       spec_generate_int4=spec["generate_int4"],
                                       spec_engine_int4=spec["engine_int4"]),
              t3_shape=sub(case(multi, "engine int4 T=3")),
              g96_shape=sub(case(multi, "engine int4 g96 T=1")),
              g96_t3_shape=sub(case(multi, "engine int4 g96 T=3"))),
        entry("fused_decode_attention_q4", "decode_attention_quant.cu",
              "edgerunner_tpu/ops/decode_attention_pallas.py:401",
              gen_q4["launches"]["fused_decode_attention_q4"],
              case(multi, "generate q4 index"), index=case(multi, "generate q4 index")["index"]),
        entry("flash_attention_lse", "flash_fwd.cu", "edgerunner_tpu/ops/flash_attention.py:1363",
              sp_launches("flash_attention_lse"), lse_main,
              launches_by_rank=[rk["train"]["launches"]["flash_attention_lse"]
                                for rk in sp_ranks],
              diagonal_shape=sub(lse_diag), r4_shape=sub(lse_r4)),
        entry("flash_attention_lse_bwd", "flash_bwd.cu",
              "edgerunner_tpu/ops/flash_attention.py:1235", sp_launches("flash_attention_lse_bwd"),
              dict(lse_main["bwd"], max_abs_err=lse_main["max_abs_err"],
                   shape=lse_main["shape"]),
              launches_by_rank=[rk["train"]["launches"]["flash_attention_lse_bwd"]
                                for rk in sp_ranks],
              diagonal_shape={"shape": lse_diag["shape"], "max_abs_err": lse_diag["max_abs_err"],
                              **{k: lse_diag["bwd"][k] for k in keys}},
              r4_shape={"shape": lse_r4["shape"], "max_abs_err": lse_r4["max_abs_err"],
                        **{k: lse_r4["bwd"][k] for k in keys}}),
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
            "generate": lambda: phase_generate(dev),
            "generate_q8": lambda: phase_generate_q8(dev),
            "generate_q4": lambda: phase_generate_q4(dev), "parity": lambda: phase_parity(dev),
            "parity_q4": lambda: phase_parity_q4(dev), "serve": lambda: phase_serve(dev),
            "serve_parity": lambda: phase_serve_parity(dev), "spec": lambda: phase_spec(dev),
            "train": lambda: phase_train(dev), "train_parity": lambda: phase_train_parity(dev),
            "sp": lambda: phase_sp(dev), "dp": lambda: phase_dp(dev),
            "dit": lambda: phase_dit(dev),
            "dit_parity": lambda: phase_dit_parity(dev),
            "dit_train": lambda: phase_dit_train(dev),
            "dit_train_parity": lambda: phase_dit_train_parity(dev),
            "image": lambda: phase_image(dev), "image_parity": lambda: phase_image_parity(dev),
            "image_train": lambda: phase_image_train(dev)}
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
        # a phase's models may sit in reference cycles (its server's threads):
        # free them before the next phase reads its peak memory
        gc.collect()
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
    emit(kernels_line(results))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

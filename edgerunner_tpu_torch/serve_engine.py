"""Continuous-batching decode engine of the port (edgerunner_tpu/serve_engine.py:42-468).

The engine keeps ONE decode state of `batch` row slots on the device and
interleaves, on its own worker thread:

    admit   free slots take queued requests: a B=1 prefill encodes the new
            request's condition, and its cache rows are copied into the slot;
    decode  a segment of up to `segment_steps` steps in which every row
            advances at its own position (LMM.verify_step with T = 1, over
            the multi-query decode kernel) and finishes on its own (EOS or
            budget);
    finish  finished rows deliver their tokens and free their slots.

Greedy decode through the engine gives each request the tokens that the
solo decode path (generate.py) gives it: rows never influence each other.
Sampling keeps one seeded generator per slot, set from the request's seed
at admission, so a request's sampled tokens depend on its seed alone.

Differences from the JAX engine, whose segment is one compiled
`lax.while_loop`: the segment is a Python loop of eager steps, and the
condition "some row is still live" is read through an asynchronous host
copy every DECODE_CHUNK steps (as generate.py reads its EOS flags), so a
segment may run up to 2·DECODE_CHUNK steps after its last row ended. Such
steps change nothing a delivered stream reads: a dead row writes PAD at
tokens[n], and its n, pos and done stay as they are. All device work runs
on the worker thread, under `torch.inference_mode()`; the callers' threads
only queue requests and wait.

With `spec_decode`, `mtp_heads` > 0 and greedy mode, each engine step is a
speculative pass instead (`body_spec`, serve_engine.py:254-316; the pass is
generate.py's `spec_pass`): every row proposes 1 + mtp_heads tokens,
verifies them in one multi-query pass at its own position and accepts 1 to
1 + mtp_heads of them within its budget; the state carries the frontier's
hidden state `h_last`, and the token buffer 1 + mtp_heads columns of write
headroom. Without draft heads, or when sampling, spec_decode warns and the
engine decodes one token per step, as the JAX engine does.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from edgerunner_tpu_torch import generate as TG
from edgerunner_tpu_torch.config import vocab_size_for
from edgerunner_tpu_torch.generate import round_up_bucket
from edgerunner_tpu_torch.ops import sampling as S


class EngineOverloaded(RuntimeError):
    """Queue depth reached max_queue; the caller should shed load (HTTP 503)."""


class Request:
    __slots__ = ("points", "num_faces", "seed", "slot_result", "done_event", "t_submit")

    def __init__(self, points, num_faces, seed):
        self.points = points
        self.num_faces = num_faces
        self.seed = seed
        self.slot_result: dict = {}
        self.done_event = threading.Event()
        self.t_submit = time.time()


def engine_shape(opt, max_faces: Optional[int] = None) -> tuple:
    """(prompt length, budget cap N, cache length) exactly as the JAX engine
    sizes its state (serve_engine.py:86-96): the prompt is the condition and
    BOS, the budget is bounded by the largest face count, the cache rounds
    to 512."""
    plen = opt.num_cond_tokens + 1
    max_faces = max_faces or max(opt.test_num_face)
    cap = min(opt.max_seq_length, max_faces * 5 + 64)
    N = round_up_bucket(cap, opt.decode_bucket)
    return plen, N, round_up_bucket(plen + N + 1, 512)


class ContinuousEngine:
    """Slot-based continuous batching over a fixed-shape decode state."""

    def __init__(self, model, opt, *, batch: int, segment_steps: int = 128,
                 max_faces: Optional[int] = None, bench_no_eos: bool = False,
                 max_queue: Optional[int] = None):
        self.model = model
        self.device = next(model.parameters()).device
        self.opt = opt
        self.B = max(1, batch)
        self.segment_steps = segment_steps
        self.vocab = vocab_size_for(opt)
        self.G = S.get_grammar(opt.meto_backend)
        self.mode = opt.generate_mode
        # benchmarking/tests: mask EOS so every row decodes its full budget
        self.no_eos = bench_no_eos
        # speculative decoding: 1 + num_draft proposals per row and pass,
        # greedy only (serve_engine.py:76-85)
        self.num_draft = (opt.mtp_heads if (opt.spec_decode and opt.mtp_heads > 0
                                            and self.mode == "greedy") else 0)
        if opt.spec_decode and self.num_draft == 0:
            print("[WARN] serve engine: spec_decode needs mtp_heads > 0 and "
                  "greedy mode; decoding one token per step")
        self.T = 1 + self.num_draft
        self.plen, self.N, self.max_len = engine_shape(opt, max_faces)

        # bounded when max_queue is set: put_nowait in submit() enforces the
        # limit atomically
        self.q: queue.Queue = queue.Queue(maxsize=max_queue or 0)
        self._stop = threading.Event()
        self._slots: list = [None] * self.B
        # unseeded requests take their streams' seeds from here
        self._seed_fallback = np.random.default_rng(opt.seed)
        self.max_queue = max_queue
        self._t_start = time.time()
        self._stats_lock = threading.Lock()
        self._done_count = 0
        self._wall_sum = 0.0
        self._tokens_out = 0
        # decode steps run so far, each one verify_step over every slot (a
        # speculative pass under spec decoding)
        self.steps = 0

        self._ready = threading.Event()
        self._init_error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()
        self._ready.wait()
        if self._init_error is not None:
            raise self._init_error

    # ------------------------------------------------------------- public --
    def submit(self, points: np.ndarray, num_faces: int, seed: Optional[int]) -> dict:
        """Blocking: queue one request, return {"tokens", "wall_s"}."""
        req = Request(points, num_faces, seed)
        try:
            self.q.put_nowait(req)
        except queue.Full:
            raise EngineOverloaded(f"queue depth {self.q.qsize()} >= max_queue "
                                   f"{self.max_queue}") from None
        req.done_event.wait()
        if "error" in req.slot_result:
            raise RuntimeError(req.slot_result["error"])
        return req.slot_result

    def shutdown(self):
        self._stop.set()
        try:
            # wake a worker blocked in the idle q.get()
            self.q.put_nowait(None)
        except queue.Full:
            pass

    def load(self) -> int:
        """Unfinished requests (queued or in a slot); racy reads are fine."""
        return self.q.qsize() + sum(r is not None for r in self._slots)

    def stats(self) -> dict:
        """Serving observability snapshot (the JAX engine's keys)."""
        with self._stats_lock:
            done, wall, toks = self._done_count, self._wall_sum, self._tokens_out
        return {
            "requests_done": done,
            "queue_depth": self.q.qsize(),
            "slots_busy": sum(r is not None for r in self._slots),
            "slots_total": self.B,
            "mean_wall_s": round(wall / done, 3) if done else None,
            "tokens_out": toks,
            "uptime_s": round(time.time() - self._t_start, 1),
        }

    # -------------------------------------------------------------- state --
    def _prefill(self, conds, num_faces: int):
        nf = torch.full((1,), num_faces, dtype=torch.int64, device=self.device)
        prompt = torch.full((1, 1), self.opt.bos_token_id, dtype=torch.int64,
                            device=self.device)
        logits, caches, _, h_last = self.model.prefill(conds, nf, prompt, self.max_len,
                                                       with_hidden=True)
        return logits, caches, h_last

    def _init_state(self):
        B, dev = self.B, self.device
        # one B=1 prefill on a dummy request gives the caches' layout
        # (their kind depends on kv_quant)
        logits, caches, h_last = self._prefill(self._dummy_cond(), 100)

        def zero(r):
            return torch.zeros((B,) + tuple(r.shape[1:]), dtype=r.dtype, device=dev)

        self.state = {
            # + T columns of write headroom: a speculative pass writes T
            # tokens at n <= budget - 1; rejected ones are overwritten later
            "tokens": torch.zeros((B, self.N + self.T), dtype=torch.int64, device=dev),
            "next_logits": zero(logits),
            # the frontier's hidden state, from which the draft heads propose
            "h_last": zero(h_last),
            "caches": tuple([zero(r) for r in rows] for rows in caches),
            # a free slot keeps decoding at its frozen position
            "pos": torch.full((B,), self.plen, dtype=torch.int32, device=dev),
            "n": torch.zeros(B, dtype=torch.int32, device=dev),
            "budget": torch.zeros(B, dtype=torch.int32, device=dev),
            "gstate": self.G.init(B, dev),
            "done": torch.ones(B, dtype=torch.bool, device=dev),
        }
        self.gens = [torch.Generator(device=dev).manual_seed(self.opt.seed + i)
                     for i in range(B)]
        self._no_eos = torch.arange(self.vocab, device=dev)[None] != S.EOS_ID
        self._cols = torch.arange(self.T, device=dev)

    def _dummy_cond(self):
        if self.opt.cond_mode == "point":
            return torch.zeros((1, self.opt.point_num, 3), device=self.device)
        return torch.zeros((1, 0), device=self.device)

    # ------------------------------------------------------------- worker --
    def _admit_one(self, slot: int, req: Request):
        opt, st, dev = self.opt, self.state, self.device
        conds = torch.as_tensor(np.asarray(req.points, np.float32)[None], device=dev)
        row_logits, row_caches, row_h = self._prefill(conds, req.num_faces)
        budget = round_up_bucket(min(req.num_faces * 5 + 64, self.N), opt.decode_bucket)
        for bigs, rows in zip(st["caches"], row_caches):
            for big, row in zip(bigs, rows):
                big[slot] = row[0]
        st["tokens"][slot] = 0
        st["next_logits"][slot] = row_logits[0]
        st["h_last"][slot] = row_h[0]
        st["pos"][slot] = self.plen
        st["n"][slot] = 0
        st["budget"][slot] = min(budget, self.N)
        for big, fresh in zip(st["gstate"], self.G.init(1, dev)):
            big[slot] = fresh[0]
        st["done"][slot] = False
        seed = int(req.seed) if req.seed is not None else int(
            self._seed_fallback.integers(2 ** 62))
        self.gens[slot] = torch.Generator(device=dev).manual_seed(seed)
        self._slots[slot] = req

    def _segment(self, active: torch.Tensor):
        """Up to segment_steps decode steps of every slot (the vanilla body,
        serve_engine.py:220-252, or the speculative one); stops within
        2·DECODE_CHUNK steps of the step after which no row is live."""
        st = self.state
        ended = None  # the host copy of "no row live" in flight
        for i in range(self.segment_steps):
            if self.num_draft:
                self._step_spec(active)
            else:
                self._step(active)
            self.steps += 1
            if (i + 1) % TG.DECODE_CHUNK == 0:
                if ended is not None and TG.arrived(ended):
                    break
                live = active & ~st["done"] & (st["n"] < st["budget"])
                ended = TG.copy_to_host(~live.any())

    def _step_spec(self, active: torch.Tensor):
        """One speculative pass of every slot (serve_engine.py:254-316)."""
        st = self.state
        live = active & ~st["done"] & (st["n"] < st["budget"])
        P, a, eos = TG.spec_pass(self.model, self.G, self.vocab, st, st["pos"], live,
                                 st["budget"] - st["n"], self._no_eos if self.no_eos else None)
        st["tokens"].scatter_(1, st["n"].long()[:, None] + self._cols, P)
        st["done"] = st["done"] | eos
        st["n"] = st["n"] + a
        st["pos"] = st["pos"] + a

    def _step(self, active: torch.Tensor):
        """One decode step of every slot (serve_engine.py:220-252)."""
        st, G, opt = self.state, self.G, self.opt
        mask = G.mask(st["gstate"], self.vocab)
        if self.no_eos:
            mask = mask & self._no_eos
        logits = S.apply_mask(st["next_logits"][:, 0].float(), mask)
        if self.mode == "greedy":
            nxt = S.greedy_token(logits)
        else:
            nxt = S.sample_token_per_row(logits, self.gens, top_k=opt.top_k,
                                         temperature=opt.temperature, top_p=opt.top_p)
        live = active & ~st["done"] & (st["n"] < st["budget"])
        nxt = torch.where(live, nxt, S.PAD_ID)
        st["gstate"] = G.advance(st["gstate"], nxt)
        st["done"] = st["done"] | (live & (nxt == S.EOS_ID))
        st["tokens"].scatter_(1, st["n"].long()[:, None], nxt[:, None])
        st["n"] = st["n"] + live.int()
        st["next_logits"] = self.model.verify_step(nxt[:, None], st["caches"], st["pos"])
        st["pos"] = st["pos"] + live.int()

    def _finish_row(self, slot: int, tokens_np, n_np):
        req = self._slots[slot]
        self._slots[slot] = None
        if req is None:
            return
        # a copy: on the CPU tokens_np shares the state's memory
        req.slot_result["tokens"] = np.array(tokens_np[slot, :int(n_np[slot])])
        wall = time.time() - req.t_submit
        req.slot_result["wall_s"] = round(wall, 3)
        with self._stats_lock:
            self._done_count += 1
            self._wall_sum += wall
            self._tokens_out += int(n_np[slot])
        req.done_event.set()

    def _fail(self, req: Request, exc: BaseException):
        req.slot_result["error"] = str(exc)
        req.done_event.set()

    def _worker(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                self._init_state()
        except Exception as exc:  # noqa: BLE001 - raised again by __init__
            self._init_error = exc
            return
        finally:
            self._ready.set()
        with torch.inference_mode():
            self._serve()

    def _serve(self):
        while not self._stop.is_set():
            # ---- admit into free slots
            for slot in range(self.B):
                if self._slots[slot] is not None:
                    continue
                try:
                    req = self.q.get_nowait()
                except queue.Empty:
                    break
                if req is None:
                    return
                try:
                    self._admit_one(slot, req)
                except Exception as exc:  # noqa: BLE001
                    self._fail(req, exc)

            if not any(r is not None for r in self._slots):
                # idle: block until the next request (or shutdown)
                req = self.q.get()
                if req is None or self._stop.is_set():
                    return
                try:
                    self._admit_one(0, req)
                except Exception as exc:  # noqa: BLE001
                    self._fail(req, exc)
                continue

            # ---- one decode segment
            st = self.state
            try:
                active = torch.tensor([r is not None for r in self._slots], device=self.device)
                self._segment(active)
                n_np, done_np, budget_np = torch.stack(
                    [st["n"], st["done"].int(), st["budget"]]).cpu().numpy()
            except Exception as exc:  # noqa: BLE001
                for slot, req in enumerate(self._slots):
                    if req is not None:
                        self._fail(req, exc)
                        self._slots[slot] = None
                continue

            # ---- deliver finished rows
            finished = [s for s in range(self.B) if self._slots[s] is not None
                        and (done_np[s] or n_np[s] >= budget_np[s])]
            if finished:
                tokens_np = st["tokens"].cpu().numpy()
                for s in finished:
                    self._finish_row(s, tokens_np, n_np)

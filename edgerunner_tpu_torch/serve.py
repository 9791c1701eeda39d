"""HTTP mesh generation of the port over the continuous-batching engine
(the counterpart of serve.py:54-597).

    python -m edgerunner_tpu_torch.serve ArAE [--resume w.safetensors] \\
        --port 8217 --test_batch_size 8 [--kv_quant true [--kv_bits 4] --w_quant true] \\
        [--mtp_heads 2 --spec_decode true --generate_mode greedy] [--device cuda|cpu]

API, with the JAX server's JSON:
    GET  /healthz         -> {"ok": true, "cond_mode", "batch", "pipeline": false}
    GET  /statz           -> {"requests_done", "queue_depth", "slots_busy",
                              "slots_total", "mean_wall_s", "tokens_out", "uptime_s"}
    POST /generate        body {"points": [[x,y,z], ...], "num_faces": 1000,
                          "seed": 0} -> {"vertices", "faces", "tokens", "wall_s"};
                          malformed input answers 400, a full queue 503
    POST /generate_image  400: the image pipeline is not ported yet

Two scheduling engines, as in the JAX server: continuous batching (the
default, serve_engine.py), and with `--no_continuous` a micro-batcher that
runs each collected batch to completion through `generate_tokens`. The
model runs on the card unless `--device cpu` is given; without a card and
without `--device cpu` it raises. The multi-device fleet (`--dp_size`) and
the image pipeline (`--resume2`) are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch


def _cond_shape(opt) -> tuple:
    """Per-row conditioning shape (matches ContinuousEngine._dummy_cond)."""
    return (opt.point_num, 3)


def _mesh_result(opt, tokenizer, tokens, wall_s) -> dict:
    """The /generate answer for one token stream: the detokenised mesh, the
    tokens without the +3 offset, and the request's wall time."""
    from edgerunner_tpu_torch.data import save_mesh
    from edgerunner_tpu_torch.generate import trim_eos

    verts, faces = save_mesh(tokens, opt, None, tokenizer=tokenizer, clean=True)
    return {"vertices": np.asarray(verts).tolist(), "faces": np.asarray(faces).tolist(),
            "tokens": (trim_eos(tokens) - 3).tolist(), "wall_s": wall_s}


class Batcher:
    """Collects requests into fixed-size batches and runs each to completion
    (`--no_continuous`). A seeded request samples from a stream of its own
    seed, whatever shares its batch."""

    def __init__(self, opt, model, tokenizer, max_wait_ms: float = 30.0):
        self.opt = opt
        self.model = model
        self.tokenizer = tokenizer
        self.batch = max(1, opt.test_batch_size)
        self.max_wait = max_wait_ms / 1e3
        self.q: queue.Queue = queue.Queue()
        self.device = next(model.parameters()).device
        # seeds of the unseeded rows' streams
        self._seeds = np.random.default_rng(opt.seed)
        self._stop = threading.Event()
        self._t_start = time.time()
        self._stats_lock = threading.Lock()
        self._done_count = 0
        self._wall_sum = 0.0
        self._tokens_out = 0
        self._busy = 0
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def submit(self, points: np.ndarray, num_faces: int, seed) -> dict:
        """Blocking: queue one request, wait for its result."""
        done = threading.Event()
        slot: dict = {}
        self.q.put((points, num_faces, seed, slot, done))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot

    def shutdown(self):
        self._stop.set()
        self.q.put(None)

    def stats(self) -> dict:
        with self._stats_lock:
            done, wall, toks, busy = (self._done_count, self._wall_sum,
                                      self._tokens_out, self._busy)
        return {
            "requests_done": done,
            "queue_depth": self.q.qsize(),
            "slots_busy": busy,
            "slots_total": self.batch,
            "mean_wall_s": round(wall / done, 3) if done else None,
            "tokens_out": toks,
            "uptime_s": round(time.time() - self._t_start, 1),
        }

    def _drain(self):
        """One micro-batch: the first request blocks, stragglers up to max_wait."""
        first = self.q.get()
        if first is None:
            return None
        items = [first]
        deadline = time.time() + self.max_wait
        while len(items) < self.batch:
            timeout = deadline - time.time()
            if timeout <= 0:
                break
            try:
                nxt = self.q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                return items
            items.append(nxt)
        return items

    def _generator(self, seed):
        seed = int(seed) if seed is not None else int(self._seeds.integers(2 ** 62))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _worker(self):
        from edgerunner_tpu_torch.generate import generate_tokens

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            items = self._drain()
            if items is None:
                break
            t0 = time.time()
            with self._stats_lock:
                self._busy = len(items)
            try:
                conds = np.zeros((self.batch,) + _cond_shape(self.opt), np.float32)
                for i, item in enumerate(items):
                    conds[i] = item[0]
                # the largest request's face budget serves the whole batch
                num_faces = max(item[1] for item in items)
                seeds = [item[2] for item in items] + [None] * (self.batch - len(items))
                with torch.inference_mode():
                    tokens = generate_tokens(self.model, conds, num_faces=num_faces,
                                             generator=[self._generator(s) for s in seeds])
                wall = round(time.time() - t0, 3)
                toks = 0
                for i, (_, _, _, slot, done) in enumerate(items):
                    slot.update(_mesh_result(self.opt, self.tokenizer, tokens[i], wall))
                    toks += len(slot["tokens"])
                    done.set()
                with self._stats_lock:
                    self._done_count += len(items)
                    self._wall_sum += (time.time() - t0) * len(items)
                    self._tokens_out += toks
                    self._busy = 0
            except Exception as e:  # noqa: BLE001 - every waiting request gets the error
                for _, _, _, slot, done in items:
                    slot["error"] = str(e)
                    done.set()
                with self._stats_lock:
                    self._busy = 0


class ContinuousFrontend:
    """ContinuousEngine behind the handler: the engine decodes tokens on its
    worker thread, detokenisation runs in the request's own thread."""

    def __init__(self, opt, model, tokenizer, batch: int, segment_steps: int = 128,
                 max_queue: Optional[int] = None):
        from edgerunner_tpu_torch.serve_engine import ContinuousEngine

        self.opt = opt
        self.tokenizer = tokenizer
        self.batch = batch
        self.engine = ContinuousEngine(model, opt, batch=batch, segment_steps=segment_steps,
                                       max_queue=max_queue)

    def stats(self) -> dict:
        return self.engine.stats()

    def submit(self, points: np.ndarray, num_faces: int, seed) -> dict:
        res = self.engine.submit(points, num_faces, seed)
        return _mesh_result(self.opt, self.tokenizer, res["tokens"], res["wall_s"])

    def shutdown(self):
        self.engine.shutdown()


def make_handler(batcher, opt):
    from edgerunner_tpu_torch.serve_engine import EngineOverloaded

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "cond_mode": opt.cond_mode,
                                 "batch": batcher.batch, "pipeline": False})
            elif self.path == "/statz":
                self._json(200, batcher.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/generate_image":
                self._json(400, {"error": "server not in pipeline mode "
                                 "(start with --resume2 DIT_CKPT)"})
                return
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            # malformed client input (ragged lists, non-numeric fields, bad
            # json) is a 400, never a 500
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                num_faces = int(req.get("num_faces", opt.test_num_face[0]))
                pts = np.asarray(req.get("points", []), np.float32)
                if pts.ndim != 2 or pts.shape[1] != 3 or len(pts) == 0:
                    self._json(400, {"error": "points must be [[x,y,z], ...]"})
                    return
                # resample to the model's fixed point count
                rng = np.random.default_rng(int(req.get("seed") or 0))
                idx = (rng.integers(0, len(pts), size=opt.point_num)
                       if len(pts) != opt.point_num else np.arange(opt.point_num))
                cond = pts[idx]
            except (ValueError, TypeError, AttributeError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                self._json(200, batcher.submit(cond, num_faces, req.get("seed")))
            except Exception as e:  # noqa: BLE001
                self._json(503 if isinstance(e, EngineOverloaded) else 500,
                           {"error": str(e)})

    return Handler


def build_server(opt, port: int = 0, max_wait_ms: float = 30.0, continuous: bool = True,
                 segment_steps: int = 128, max_queue: Optional[int] = None,
                 device: str = "cuda", dtype=torch.bfloat16, model=None):
    """(server, batcher) for `opt`; separated from main() for tests. The
    model is built and loaded as infer.py loads it (the exact weights, then
    quantised under w_quant), unless one is given."""
    from edgerunner_tpu_torch.infer import load_model, resolve_device
    from edgerunner_tpu_torch.utils import get_tokenizer

    if model is None:
        model = load_model(opt, resolve_device(device), dtype=dtype)
    tokenizer, _ = get_tokenizer(opt)
    if continuous:
        batcher = ContinuousFrontend(opt, model, tokenizer, batch=max(1, opt.test_batch_size),
                                     segment_steps=segment_steps, max_queue=max_queue)
    else:
        batcher = Batcher(opt, model, tokenizer,
                          max_wait_ms=max_wait_ms)
    server = ThreadingHTTPServer(("0.0.0.0", port), make_handler(batcher, opt))
    return server, batcher


def main(argv: Optional[List[str]] = None):
    from edgerunner_tpu_torch.config import parse_cli, validate

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--port", type=int, default=8217)
    ap.add_argument("--max_wait_ms", type=float, default=30.0)
    ap.add_argument("--no_continuous", action="store_true",
                    help="use the run-to-completion micro-batcher instead of "
                         "continuous batching")
    ap.add_argument("--segment_steps", type=int, default=128,
                    help="decode steps between admission points (continuous)")
    ap.add_argument("--max_queue", type=int, default=0,
                    help="shed load (HTTP 503) when this many requests are "
                         "already queued (0 = unbounded)")
    args, rest = ap.parse_known_args(argv)
    opt = validate(parse_cli(rest, prog="python -m edgerunner_tpu_torch.serve"))
    if opt.cond_mode != "point":
        raise ValueError("the port's server conditions on a point cloud (cond_mode 'point')")
    server, _ = build_server(opt, port=args.port, max_wait_ms=args.max_wait_ms,
                             continuous=not args.no_continuous,
                             segment_steps=args.segment_steps,
                             max_queue=args.max_queue or None, device=args.device)
    mode = "micro-batch" if args.no_continuous else "continuous"
    print(f"[serve] listening on :{server.server_address[1]} (batch "
          f"{max(1, opt.test_batch_size)}, cond {opt.cond_mode}, {mode}, "
          f"device {args.device})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()

"""HTTP mesh generation of the port over the continuous-batching engine
(the counterpart of serve.py:54-597), with the image pipeline.

    python -m edgerunner_tpu_torch.serve ArAE [--resume w.safetensors] \\
        --port 8217 --test_batch_size 8 [--kv_quant true [--kv_bits 4] --w_quant true] \\
        [--mtp_heads 2 --spec_decode true --generate_mode greedy] \\
        [--resume2 dit.safetensors [--dit_steps 100 --guidance_scale 7.5]] [--device cuda|cpu] \\
        [--dp_size N]

API, with the JAX server's JSON:
    GET  /healthz         -> {"ok": true, "cond_mode", "batch", "pipeline"}
    GET  /statz           -> {"requests_done", "queue_depth", "slots_busy",
                              "slots_total", "mean_wall_s", "tokens_out", "uptime_s"}
                              (+ "ddim_runs" in pipeline mode, + "engines", each
                              engine's own, under --dp_size)
    POST /generate        body {"points": [[x,y,z], ...], "num_faces": 1000,
                          "seed": 0} -> {"vertices", "faces", "tokens", "wall_s"};
                          a pipeline server takes {"latents": [L][D]} instead;
                          malformed input answers 400, a full queue 503
    POST /generate_image  pipeline mode: body {"image": [H][W][3] floats in
                          [0,1] or base64 image file bytes, "num_faces", "seed"}
                          -> the /generate answer + "ddim_s"; 400 otherwise

Two scheduling engines, as in the JAX server: continuous batching (the
default, serve_engine.py), and with `--no_continuous` a micro-batcher that
runs each collected batch to completion through `generate_tokens`. With
`--resume2` (a DiT checkpoint) the server runs the image pipeline
(`PipelineFrontend`): the ArAE takes point latents, in bf16, and an image
request first runs one DDIM pass of the MDiT, in f32, on a lock. A file
image goes through `load_image_cond` and an array of another size than
CLIP's through a PIL resize: PIL is needed for those only. The model runs on
the card unless `--device cpu` is given; without a card and without
`--device cpu` it raises. With `--dp_size N` (N > 1) continuous batching
runs as the JAX server's fleet (`FleetFrontend`, serve.py:369-410): one
engine with `--test_batch_size` slots and a replica of the model on each of
cuda:0 .. N-1 (N on the CPU with `--device cpu`), each request to the
least-loaded engine; the micro-batcher stays on one device, as in the JAX
server. An image-conditioned ArAE (cond_mode 'image', the default preset)
is refused, because the JAX server has no request body for it
(`IMAGE_MODE_REFUSED`).
"""

from __future__ import annotations

import argparse
import base64
import binascii
import dataclasses
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import numpy as np
import torch


def _cond_shape(opt) -> tuple:
    """Per-row conditioning shape (matches ContinuousEngine._dummy_cond)."""
    if opt.cond_mode == "point_latent":
        return (opt.point_latent_size, opt.point_latent_dim)
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
        return self.answer(self.engine.enqueue(points, num_faces, seed))

    def answer(self, req) -> dict:
        """Blocking: the /generate answer of a request queued on the engine."""
        res = self.engine.result(req)
        return _mesh_result(self.opt, self.tokenizer, res["tokens"], res["wall_s"])

    def check_overloaded(self):
        """Raise EngineOverloaded if a submit would be refused now: lets the
        pipeline shed a request before its DDIM pass (racy by design; the
        bounded queue still enforces the limit at submit)."""
        from edgerunner_tpu_torch.serve_engine import EngineOverloaded

        e = self.engine
        if e.max_queue is not None and e.q.qsize() >= e.max_queue:
            raise EngineOverloaded(f"queue depth {e.q.qsize()} >= max_queue {e.max_queue}")

    def shutdown(self):
        self.engine.shutdown()


class FleetFrontend:
    """One `ContinuousFrontend` per device, each engine on a replica of its
    own (JAX serve.py:369-410): a request goes to the engine with the least
    load (`ContinuousEngine.load`: queued and admitted requests), chosen and
    queued under one lock, so that concurrent requests spread; `stats` adds
    the engines' up and lists each."""

    def __init__(self, opt, replicas, tokenizer, batch: int, segment_steps: int = 128,
                 max_queue: Optional[int] = None):
        self.batch = batch
        self.frontends = [ContinuousFrontend(opt, m, tokenizer, batch,
                                             segment_steps=segment_steps,
                                             max_queue=max_queue)
                          for m in replicas]
        self._lock = threading.Lock()

    def _least_loaded(self) -> ContinuousFrontend:
        return min(self.frontends, key=lambda f: f.engine.load())

    def submit(self, points: np.ndarray, num_faces: int, seed) -> dict:
        with self._lock:
            fe = self._least_loaded()
            req = fe.engine.enqueue(points, num_faces, seed)
        return fe.answer(req)

    def check_overloaded(self):
        """Raise EngineOverloaded if the least-loaded engine would refuse a
        request now (the pipeline's check before its DDIM pass)."""
        self._least_loaded().check_overloaded()

    def stats(self) -> dict:
        per = [f.stats() for f in self.frontends]
        done = sum(s["requests_done"] for s in per)
        walls = [s["mean_wall_s"] * s["requests_done"] for s in per
                 if s["mean_wall_s"] is not None]
        return {
            "requests_done": done,
            "queue_depth": sum(s["queue_depth"] for s in per),
            "slots_busy": sum(s["slots_busy"] for s in per),
            "slots_total": sum(s["slots_total"] for s in per),
            "mean_wall_s": round(sum(walls) / done, 3) if done else None,
            "tokens_out": sum(s["tokens_out"] for s in per),
            "uptime_s": max(s["uptime_s"] for s in per),
            "engines": per,
        }

    def shutdown(self):
        for fe in self.frontends:
            fe.shutdown()


class PipelineFrontend:
    """Image serving: image -> DiT DDIM -> point latent -> ArAE decode (the
    reference's infer_dit.py flow over HTTP; JAX serve.py:414-470). The
    inner frontend serves a point_latent ArAE, so latent requests still
    work; an image request runs one DDIM pass first. DDIM passes run one at
    a time on a lock; decode admission and batching stay with the inner
    frontend."""

    def __init__(self, inner, model_dit, dit_steps: int = 100,
                 guidance_scale: float = 7.5):
        self.inner = inner
        self.batch = inner.batch
        self.model_dit = model_dit
        self.device = next(model_dit.parameters()).device
        self.dit_steps = dit_steps
        self.guidance = guidance_scale
        self._lock = threading.Lock()
        self._ddim_runs = 0

    def submit(self, points: np.ndarray, num_faces: int, seed) -> dict:
        return self.inner.submit(points, num_faces, seed)

    def stats(self) -> dict:
        return {**self.inner.stats(), "ddim_runs": self._ddim_runs}

    def submit_image(self, image: np.ndarray, num_faces: int, seed) -> dict:
        """image [H, W, 3] in [0,1] -> the mesh answer and "ddim_s"."""
        from edgerunner_tpu_torch.models.mdit import run_mdit

        # shed load before the serialised DDIM pass: a request the inner
        # engine would refuse must not take a DDIM run and the lock
        if hasattr(self.inner, "check_overloaded"):
            self.inner.check_overloaded()
        t0 = time.time()
        seed_ = int(seed) if seed is not None else int(np.random.default_rng().integers(2 ** 31))
        gen = torch.Generator(device=self.device).manual_seed(seed_)
        with self._lock:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.inference_mode():
                latents = run_mdit(self.model_dit, np.asarray(image, np.float32)[None],
                                   num_inference_steps=self.dit_steps,
                                   guidance_scale=self.guidance, generator=gen)
                latents = latents[0].cpu().numpy()
            self._ddim_runs += 1
        ddim_s = time.time() - t0
        out = self.inner.submit(latents, num_faces, seed)
        out["ddim_s"] = round(ddim_s, 3)
        return out

    def shutdown(self):
        self.inner.shutdown()


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
                                 "batch": batcher.batch,
                                 "pipeline": hasattr(batcher, "submit_image")})
            elif self.path == "/statz":
                self._json(200, batcher.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def _answer(self, submit, cond, num_faces, seed):
            try:
                self._json(200, submit(cond, num_faces, seed))
            except Exception as e:  # noqa: BLE001
                self._json(503 if isinstance(e, EngineOverloaded) else 500,
                           {"error": str(e)})

        def do_POST(self):
            if self.path == "/generate_image":
                self._generate_image()
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
                if opt.cond_mode == "point_latent":
                    # a pipeline server also takes a raw latent condition
                    cond = np.asarray(req.get("latents", []), np.float32)
                    if cond.shape != _cond_shape(opt):
                        self._json(400, {"error": f"latents must be {list(_cond_shape(opt))}"})
                        return
                else:
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
            self._answer(batcher.submit, cond, num_faces, req.get("seed"))

        def _generate_image(self):
            """body {"image": base64 file bytes or [H][W][3] floats in [0,1],
            "num_faces": N, "seed": S} -> the mesh answer and "ddim_s"."""
            if not hasattr(batcher, "submit_image"):
                self._json(400, {"error": "server not in pipeline mode "
                                 "(start with --resume2 DIT_CKPT)"})
                return
            s = opt.clip_image_size
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                num_faces = int(req.get("num_faces", opt.test_num_face[0]))
                raw = req.get("image")
                if isinstance(raw, str):
                    # an image file: background removal, recentring, white
                    # background (reference: infer.py:71-83)
                    from edgerunner_tpu_torch.data.image_io import load_image_cond

                    img = load_image_cond(io.BytesIO(base64.b64decode(raw)), size=s)
                elif raw is not None:
                    img = np.asarray(raw, np.float32)
                    if img.ndim != 3 or img.shape[2] != 3:
                        self._json(400, {"error": "image must be [H][W][3]"})
                        return
                    if img.shape[:2] != (s, s):
                        from edgerunner_tpu_torch.data.image_io import resize_bilinear

                        # bilinear, as load_image_cond resizes, so that both
                        # inputs condition alike
                        img = resize_bilinear(img, s, s)
                else:
                    self._json(400, {"error": "missing image"})
                    return
            except (ValueError, TypeError, AttributeError, OSError, binascii.Error,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            self._answer(batcher.submit_image, img, num_faces, req.get("seed"))

    return Handler


# the JAX server reads "points" in every mode but point_latent and sizes its
# condition as (point_num, 3) (serve.py:54-58, :281-305): it has no request
# body for an image-conditioned ArAE, so the port serves none either
IMAGE_MODE_REFUSED = (
    "the server does not serve cond_mode 'image': the JAX server has no image "
    "request body in this mode (its /generate reads point clouds); generate "
    "from images with python -m edgerunner_tpu_torch.infer default --test_path "
    "IMAGE, or serve images through the DiT pipeline (serve ArAE --resume2 DIT_CKPT)")


def build_server(opt, port: int = 0, max_wait_ms: float = 30.0, continuous: bool = True,
                 segment_steps: int = 128, max_queue: Optional[int] = None,
                 device: str = "cuda", dtype=torch.bfloat16, model=None,
                 pipeline: Optional[bool] = None, dit_steps: int = 100,
                 guidance_scale: float = 7.5, devices: Optional[Sequence] = None):
    """(server, batcher) for `opt`; separated from main() for tests. The
    model is built and loaded as infer.py loads it (the exact weights, then
    quantised under w_quant), unless one is given. `pipeline` (by default:
    whether `opt.resume2` names a DiT checkpoint) serves images: the LMM
    takes point latents, and an f32 MDiT with the weights of `resume2`, or
    drawn from `opt.seed`, runs `dit_steps` DDIM steps at `guidance_scale`.
    Continuous batching with `opt.dp_size` N > 1 serves from a
    `FleetFrontend` of N engines on `devices` (by default cuda:0 .. N-1, or
    N times the CPU for device 'cpu'), each on a replica of the model."""
    from edgerunner_tpu_torch.generate import replicate_model
    from edgerunner_tpu_torch.infer import fleet_devices, load_model, resolve_device
    from edgerunner_tpu_torch.utils import get_tokenizer

    if pipeline is None:
        pipeline = opt.resume2 is not None
    if opt.cond_mode == "image" and not pipeline:
        raise ValueError(IMAGE_MODE_REFUSED)
    if pipeline:
        # the ArAE takes the DiT's latents (reference: infer_dit.py:55)
        opt = dataclasses.replace(opt, cond_mode="point_latent")
    dev = resolve_device(device)
    if continuous and opt.dp_size > 1:
        devices = (fleet_devices(opt.dp_size, dev) if devices is None
                   else [torch.device(d) for d in devices])
        if len(devices) != opt.dp_size:
            raise ValueError(f"--dp_size {opt.dp_size} with {len(devices)} devices")
        dev = devices[0]
    if model is None:
        model = load_model(opt, dev, dtype=dtype)
    tokenizer, _ = get_tokenizer(opt)
    batch = max(1, opt.test_batch_size)
    if continuous and opt.dp_size > 1:
        batcher = FleetFrontend(opt, replicate_model(model, devices), tokenizer, batch,
                                segment_steps=segment_steps, max_queue=max_queue)
    elif continuous:
        batcher = ContinuousFrontend(opt, model, tokenizer, batch=batch,
                                     segment_steps=segment_steps, max_queue=max_queue)
    else:
        batcher = Batcher(opt, model, tokenizer,
                          max_wait_ms=max_wait_ms)
    if pipeline:
        from edgerunner_tpu_torch.models.mdit import MDiT
        from edgerunner_tpu_torch.weights import load_mdit

        model_dit = load_mdit(MDiT(opt, device=next(model.parameters()).device), opt)
        if opt.resume2:
            print(f"[serve] loaded DiT checkpoint from {opt.resume2}")
        batcher = PipelineFrontend(batcher, model_dit, dit_steps=dit_steps,
                                   guidance_scale=guidance_scale)
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
    ap.add_argument("--dit_steps", type=int, default=100,
                    help="DDIM steps for /generate_image (pipeline mode)")
    ap.add_argument("--guidance_scale", type=float, default=7.5)
    ap.add_argument("--max_queue", type=int, default=0,
                    help="shed load (HTTP 503) when this many requests are "
                         "already queued (0 = unbounded)")
    args, rest = ap.parse_known_args(argv)
    opt = validate(parse_cli(rest, prog="python -m edgerunner_tpu_torch.serve"))
    if opt.cond_mode not in ("point", "image"):  # image mode: build_server decides
        raise ValueError("the port's server conditions on a point cloud (cond_mode "
                         "'point'), or with --resume2 on the DiT's latents")
    server, batcher = build_server(opt, port=args.port, max_wait_ms=args.max_wait_ms,
                                   continuous=not args.no_continuous,
                                   segment_steps=args.segment_steps,
                                   max_queue=args.max_queue or None, device=args.device,
                                   dit_steps=args.dit_steps,
                                   guidance_scale=args.guidance_scale)
    mode = "micro-batch" if args.no_continuous else "continuous"
    cond = opt.cond_mode
    if hasattr(batcher, "submit_image"):
        mode += f" + image pipeline ({args.dit_steps}-step DDIM)"
        cond = "point_latent"  # build_server sets it in pipeline mode
    if hasattr(batcher, "frontends"):
        mode += f", {len(batcher.frontends)} engines"
    print(f"[serve] listening on :{server.server_address[1]} (batch "
          f"{max(1, opt.test_batch_size)}, cond {cond}, {mode}, "
          f"device {args.device})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()

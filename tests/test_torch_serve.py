"""The port's serving path on the CPU at a tiny width, against the JAX
package: the continuous-batching engine's greedy streams equal the JAX
engine's and the solo decode's, with the exact and the int8 cache;
mid-flight admission, slot reuse, stats, backpressure and per-request
sampling streams; the HTTP server's answers and JSON keys; and the CLI's
refusal to run without a card unless asked for the CPU."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edgerunner_tpu_torch.generate as TG
from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.serve_engine import ContinuousEngine as JEngine
from edgerunner_tpu_torch import serve
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.serve_engine import ContinuousEngine, EngineOverloaded
from edgerunner_tpu_torch.utils import get_tokenizer
from edgerunner_tpu_torch.weights import load_state, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_POINTS = 40
BASE = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
            point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
            hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=512,
            use_num_face_cond=True, checkpointing=False, decode_bucket=64,
            generate_mode="greedy", point_num=N_POINTS, test_batch_size=2,
            test_num_face=(64,))
FACES = (20, 30, 20, 30)  # budgets of 192 and 256 tokens


def _pts(seed):
    return np.random.default_rng(seed).normal(size=(N_POINTS, 3)).astype(np.float32)


def _pair(**over):
    """The JAX LMM with its params and the port's LMM on the same weights
    (widened so that the point clouds steer the streams)."""
    kw = dict(BASE, **over)
    jm = JLMM(Options(**kw))
    rng = jax.random.PRNGKey(3)
    tokens = jnp.array([[1, 6, 7, 8, 2]])
    labels = jnp.concatenate([jnp.full((1, 18), -100), tokens[:, 1:]], axis=1)
    params = jm.init({"params": rng, "nof": rng, "dropout": rng},
                     jnp.zeros((1, N_POINTS, 3)), tokens, labels, jnp.array([100]),
                     jnp.array([23], jnp.int32))
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0, params)
    tm = LMM(TOptions(**kw))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm.eval()


def _concurrent(submit, args, delays):
    """Submit each request from its own thread after its delay; results in order."""
    out = [None] * len(args)

    def run(i):
        time.sleep(delays[i])
        out[i] = submit(*args[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_greedy_streams_equal_the_jax_engine_and_the_solo_decode(monkeypatch,
                                                                        kv_quant):
    # a short host-check interval: segments end early after their last row
    monkeypatch.setattr(TG, "DECODE_CHUNK", 4)
    jm, params, tm = _pair(kv_quant=kv_quant)
    opt = tm.opt
    args = [(_pts(i), nf, None) for i, nf in enumerate(FACES)]
    delays = [0.0, 0.0, 0.05, 0.1]
    jeng = JEngine(jm, params, Options(**dict(BASE, kv_quant=kv_quant)), batch=2,
                   segment_steps=16)
    teng = ContinuousEngine(tm, opt, batch=2, segment_steps=64)
    try:
        ref = _concurrent(jeng.submit, args, delays)
        out = _concurrent(teng.submit, args, delays)
    finally:
        jeng.shutdown()
        teng.shutdown()
    lengths = []
    for (pts, nf, _), r, o in zip(args, ref, out):
        np.testing.assert_array_equal(o["tokens"], np.asarray(r["tokens"]))
        solo = TG.generate_tokens(tm, pts[None], num_faces=nf)[0]
        np.testing.assert_array_equal(TG.trim_eos(o["tokens"]), TG.trim_eos(solo))
        lengths.append(len(o["tokens"]))
    assert len(set(lengths)) > 1 and max(lengths) > 64, lengths
    assert int(teng.state["pos"].max()) < teng.max_len  # every write stayed in the cache


@pytest.fixture(scope="module")
def tiny_model():
    torch.manual_seed(0)
    return _pair()[2]


def test_midflight_admission_slot_reuse_and_stats(tiny_model):
    opt = tiny_model.opt
    eng = ContinuousEngine(tiny_model, opt, batch=2, segment_steps=16, bench_no_eos=True)
    done_at = {}

    def submit(name, nf, seed):
        res = eng.submit(_pts(seed), nf, None)
        done_at[name] = time.time()
        return res

    try:
        # the long request (384 tokens) is in flight when the short ones (128
        # tokens) arrive; five requests through two slots
        res = _concurrent(submit, [("long", 64, 1), ("a", 2, 2), ("b", 2, 3), ("c", 2, 4),
                                   ("d", 2, 5)], [0.0, 0.05, 0.05, 0.1, 0.1])
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert [len(r["tokens"]) for r in res] == [384, 128, 128, 128, 128]
    assert all(done_at[k] < done_at["long"] for k in "ab")
    jeng_keys = {"requests_done", "queue_depth", "slots_busy", "slots_total",
                 "mean_wall_s", "tokens_out", "uptime_s"}
    assert set(stats) == jeng_keys
    assert stats["requests_done"] == 5 and stats["tokens_out"] == 384 + 4 * 128
    assert stats["slots_busy"] == 0 and stats["slots_total"] == 2


def test_sampled_request_is_the_same_alone_and_cobatched(tiny_model):
    import dataclasses

    opt = dataclasses.replace(tiny_model.opt, generate_mode="sample")
    eng = ContinuousEngine(tiny_model, opt, batch=3, segment_steps=16)
    try:
        alone = eng.submit(_pts(9), 16, 7)["tokens"]
        together = _concurrent(eng.submit, [(_pts(10), 16, 1), (_pts(9), 16, 7),
                                            (_pts(11), 16, None)], [0.0, 0.02, 0.0])
        other_seed = eng.submit(_pts(9), 16, 8)["tokens"]
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(together[1]["tokens"], alone)
    assert not np.array_equal(other_seed, alone)
    # the stream is the solo decode's with a generator of the request's seed
    greedy, tiny_model.opt = tiny_model.opt, opt
    try:
        solo = TG.generate_tokens(tiny_model, _pts(9)[None], num_faces=16,
                                  generator=torch.Generator().manual_seed(7))[0]
    finally:
        tiny_model.opt = greedy
    np.testing.assert_array_equal(TG.trim_eos(alone), TG.trim_eos(solo))


def _http(port, path, body=None):
    data = None if body is None else (body if isinstance(body, bytes) else
                                      json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("continuous", [True, False])
def test_http_server_answers_with_the_jax_schema(continuous):
    from edgerunner_tpu_torch.config import parse_cli, validate

    tiny = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
            "--point_hidden_dim", "64", "--point_num_heads", "2", "--point_latent_size", "16",
            "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "64",
            "--max_seq_length", "256", "--decode_bucket", "64", "--test_num_face", "20",
            "--test_batch_size", "2", "--kv_quant", "true", "--w_quant", "true"]
    opt = validate(parse_cli(["ArAE", *tiny]))
    server, batcher = serve.build_server(opt, port=0, device="cpu", continuous=continuous,
                                         dtype=torch.float32)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        assert _http(port, "/healthz") == (200, {"ok": True, "cond_mode": "point",
                                                 "batch": 2, "pipeline": False})
        pts = np.random.default_rng(0).normal(size=(100, 3)).tolist()
        answers = _concurrent(lambda s: _http(port, "/generate", {"points": pts,
                                                                  "num_faces": 10, "seed": s}),
                              [(0,), (1,), (0,)], [0.0, 0.0, 0.0])
        status, statz = _http(port, "/statz")
        bad = [_http(port, "/generate", b"{nope"), _http(port, "/generate", {"points": [1, 2]}),
               _http(port, "/generate", {"points": [[0, 0, 0]], "num_faces": "many"})]
        lost = _http(port, "/nowhere"), _http(port, "/generate_image", {"image": []})
    finally:
        server.shutdown()
        server.server_close()
        batcher.shutdown()
    for code, body in answers:
        assert code == 200 and set(body) == {"vertices", "faces", "tokens", "wall_s"}
        assert all(len(v) == 3 for v in body["vertices"])
    assert answers[0][1]["tokens"] == answers[2][1]["tokens"]  # the same seed
    assert status == 200 and statz["requests_done"] == 3
    assert set(statz) == {"requests_done", "queue_depth", "slots_busy", "slots_total",
                          "mean_wall_s", "tokens_out", "uptime_s"}
    assert [c for c, _ in bad] == [400, 400, 400] and all("error" in b for _, b in bad)
    assert lost[0] == (404, {"error": "unknown path"})
    assert lost[1] == (400, {"error": "server not in pipeline mode "
                                      "(start with --resume2 DIT_CKPT)"})


def test_max_queue_answers_503(tiny_model):
    tokenizer, _ = get_tokenizer(tiny_model.opt)
    frontend = serve.ContinuousFrontend(tiny_model.opt, tiny_model, tokenizer, batch=1,
                                        max_queue=1)
    frontend.engine.no_eos = True  # the first request holds its slot for its whole budget
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(frontend, tiny_model.opt))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port, engine = server.server_address[1], frontend.engine
    body = {"points": _pts(0).tolist(), "num_faces": 64}
    try:
        first = threading.Thread(target=_http, args=(port, "/generate", body))
        first.start()
        while engine.load() < 1 or engine.q.qsize():
            time.sleep(0.005)           # the first request holds the only slot
        second = threading.Thread(target=_http, args=(port, "/generate", body))
        second.start()
        while engine.q.qsize() < 1:
            time.sleep(0.005)           # the second waits in the queue
        code, answer = _http(port, "/generate", body)
        with pytest.raises(EngineOverloaded):
            engine.submit(_pts(0), 64, None)
        first.join(timeout=120)
        second.join(timeout=120)
    finally:
        server.shutdown()
        server.server_close()
        frontend.shutdown()
    assert code == 503 and "max_queue" in answer["error"]


def test_serve_cli_without_a_card_or_device_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["ArAE", "--port", "0"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "edgerunner_tpu_torch.serve", "ArAE",
                        "--port", "0", "--test_batch_size", "8"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "--device cpu" in r.stderr

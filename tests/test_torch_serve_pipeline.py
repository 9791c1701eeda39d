"""The port's image pipeline over HTTP on the CPU: image -> DiT DDIM -> point
latent -> ArAE (`build_server(pipeline=True)`), the counterparts of the seven
cases of tests/test_serve_pipeline.py at its sizes, and a file image in
base64, a malformed body and the overload check before the DDIM pass."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from edgerunner_tpu_torch import serve
from edgerunner_tpu_torch.config import Options
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# tests/test_serve_pipeline.py:20-27
PIPELINE = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
                point_hidden_dim=32, point_num_heads=4, point_latent_dim=8,
                dit_hidden_dim=32, dit_num_heads=4, dit_num_layers=2,
                clip_image_size=32, clip_patch_size=8, clip_hidden_dim=32,
                clip_num_heads=4, clip_num_layers=2,
                hidden_dim=64, num_layers=2, num_heads=4, max_seq_length=256,
                use_num_face_cond=True, checkpointing=False, decode_bucket=64,
                generate_mode="greedy", point_num=64, test_batch_size=2,
                test_num_face=(8,))


@pytest.fixture(scope="module")
def server():
    srv, batcher = serve.build_server(Options(**PIPELINE), port=0, pipeline=True,
                                      segment_steps=16, dit_steps=4, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", batcher
    srv.shutdown()
    srv.server_close()
    batcher.shutdown()


def _post(url, obj, timeout=600):
    data = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _status(url, obj):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, obj, timeout=60)
    return e.value.code


def test_healthz_reports_pipeline(server):
    url, _ = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert h == {"ok": True, "cond_mode": "point_latent", "batch": 2, "pipeline": True}


def test_generate_image(server):
    url, batcher = server
    img = np.random.default_rng(0).uniform(0, 1, (32, 32, 3)).tolist()
    out = _post(url + "/generate_image", {"image": img, "num_faces": 8, "seed": 0})
    assert {"tokens", "vertices", "faces", "wall_s", "ddim_s"} <= set(out)
    assert out["ddim_s"] > 0 and out["wall_s"] > 0
    assert batcher.stats()["ddim_runs"] >= 1


def test_generate_image_resizes(server):
    # an image of another size than CLIP's is resized on the host first
    url, _ = server
    img = np.random.default_rng(1).uniform(0, 1, (48, 40, 3)).tolist()
    assert "tokens" in _post(url + "/generate_image", {"image": img, "num_faces": 8, "seed": 1})


def test_seeded_requests_reproduce(server):
    url, _ = server
    img = np.random.default_rng(2).uniform(0, 1, (32, 32, 3)).tolist()
    a = _post(url + "/generate_image", {"image": img, "num_faces": 8, "seed": 7})
    b = _post(url + "/generate_image", {"image": img, "num_faces": 8, "seed": 7})
    assert a["tokens"] == b["tokens"]


def test_raw_latent_request(server):
    # a pipeline server still takes a raw point-latent condition on /generate
    url, _ = server
    lat = np.random.default_rng(3).normal(size=(16, 8)).tolist()
    out = _post(url + "/generate", {"latents": lat, "num_faces": 8, "seed": 0})
    assert "tokens" in out and "vertices" in out


def test_latent_shape_validated(server):
    url, _ = server
    assert _status(url + "/generate", {"latents": np.zeros((4, 8)).tolist(),
                                       "num_faces": 8}) == 400


def test_non_pipeline_server_rejects_image():
    opt = Options(**{**PIPELINE, "test_batch_size": 1})
    srv, batcher = serve.build_server(opt, port=0, pipeline=False, segment_steps=16,
                                      device="cpu", dtype=torch.float32)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        assert _status(url + "/generate_image", {"image": np.zeros((8, 8, 3)).tolist(),
                                                 "num_faces": 8}) == 400
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.shutdown()


def test_file_image_and_malformed_bodies(server):
    """base64 file bytes go through load_image_cond; a ragged array, a wrong
    shape, bytes that are no image, no image at all and bad JSON answer 400."""
    from PIL import Image

    url, _ = server
    buf = io.BytesIO()
    Image.fromarray(np.full((40, 40, 3), 255, np.uint8)).save(buf, format="PNG")
    out = _post(url + "/generate_image", {"image": base64.b64encode(buf.getvalue()).decode(),
                                          "num_faces": 8, "seed": 3})
    assert "tokens" in out and out["ddim_s"] > 0
    for body in ({"image": [[[0, 0, 0]], [[0, 0]]]}, {"image": np.zeros((8, 8)).tolist()},
                 {"image": base64.b64encode(b"not an image").decode()}, {"num_faces": 8},
                 {"image": "%%%"}, b"{not json"):
        assert _status(url + "/generate_image", body) == 400, body


def test_overloaded_engine_sheds_before_the_ddim_pass(server):
    from edgerunner_tpu_torch.serve_engine import EngineOverloaded

    _, batcher = server
    engine = batcher.inner.engine
    runs = batcher.stats()["ddim_runs"]
    old = engine.max_queue
    engine.max_queue = 0
    try:
        with pytest.raises(EngineOverloaded):
            batcher.submit_image(np.zeros((32, 32, 3), np.float32), 8, 0)
    finally:
        engine.max_queue = old
    assert batcher.stats()["ddim_runs"] == runs

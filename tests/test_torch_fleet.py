"""The port's decode and serving fleets on the CPU at a tiny width, the
counterparts of tests/test_generate.py's fleet tests: `generate_tokens(...,
devices=[cpu, cpu])` (two replicas, two worker threads) against the
one-device decode and the JAX fleet in f32 on the same weights; per-row
generators give a row the same sampled stream wherever it is decoded; an
indivisible batch raises; `infer --dp_size 2` writes the files of
`--dp_size 1`; `FleetFrontend` sends a request to the least-loaded engine
and adds up its engines' stats, and `serve --dp_size 2` answers over HTTP
from both engines."""

import json
import os
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edgerunner_tpu.generate as JG
import edgerunner_tpu_torch.generate as TG
from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu_torch import infer, serve
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.config import parse_cli, validate
from edgerunner_tpu_torch.data import save_mesh_file
from edgerunner_tpu_torch.data._procgen import icosphere
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.utils import get_tokenizer
from edgerunner_tpu_torch.weights import load_state, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_POINTS = 40
BASE = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
            point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
            hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=512,
            use_num_face_cond=True, checkpointing=False, decode_bucket=64,
            generate_mode="greedy", point_num=N_POINTS, test_batch_size=2,
            test_num_face=(20,))
CPU2 = [torch.device("cpu")] * 2
TINY = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
        "--point_hidden_dim", "64", "--point_num_heads", "2", "--point_latent_size", "16",
        "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "64",
        "--max_seq_length", "256", "--decode_bucket", "64", "--test_num_face", "20"]


@pytest.fixture(scope="module")
def pair():
    """The JAX LMM with its params and the port's LMM on the same weights
    (widened so that the point clouds steer the streams)."""
    jm = JLMM(Options(**BASE))
    rng = jax.random.PRNGKey(3)
    tokens = jnp.array([[1, 6, 7, 8, 2]])
    labels = jnp.concatenate([jnp.full((1, 18), -100), tokens[:, 1:]], axis=1)
    params = jm.init({"params": rng, "nof": rng, "dropout": rng},
                     jnp.zeros((1, N_POINTS, 3)), tokens, labels, jnp.array([100]),
                     jnp.array([23], jnp.int32))
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0, params)
    tm = LMM(TOptions(**BASE))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm.eval()


def _points(rows=4, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, N_POINTS, 3)).astype(np.float32)


def test_greedy_fleet_equals_one_device_and_the_jax_fleet(pair):
    jm, params, tm = pair
    pts = _points()
    solo = TG.generate_tokens(tm, pts, num_faces=20)
    reps = TG.replicate_model(tm, CPU2)
    assert reps[0] is tm and reps[1] is not tm
    fleet = TG.generate_tokens(reps, pts, num_faces=20, devices=CPU2)
    np.testing.assert_array_equal(fleet, solo)
    jfleet = JG.generate_tokens(jm, params, pts, num_faces=20, devices=jax.devices()[:2])
    np.testing.assert_array_equal(fleet, jfleet)
    # a replica list without devices decodes on its first replica
    np.testing.assert_array_equal(TG.generate_tokens(reps, pts, num_faces=20), solo)
    assert len({tuple(r) for r in fleet.tolist()}) > 1, "rows should differ"


def test_per_row_generators_give_the_same_streams_placed_anywhere(pair):
    _, _, tm = pair
    model = LMM(TOptions(**dict(BASE, generate_mode="sample")))
    model.load_state_dict(tm.state_dict())
    pts = _points(seed=1)

    def gens(seeds):
        return [torch.Generator().manual_seed(s) for s in seeds]

    seeds = [11, 12, 13, 14]
    solo = TG.generate_tokens(model, pts, num_faces=20, generator=gens(seeds))
    fleet = TG.generate_tokens(model, pts, num_faces=20, generator=gens(seeds), devices=CPU2)
    np.testing.assert_array_equal(fleet, solo)
    flipped = TG.generate_tokens(model, pts[::-1].copy(), num_faces=20,
                                 generator=gens(seeds[::-1]), devices=CPU2)
    np.testing.assert_array_equal(flipped[::-1], solo)
    # one generator: each row's seed is drawn from it, whatever the fleet
    one = [TG.generate_tokens(model, pts, num_faces=20, devices=[torch.device("cpu")] * n,
                              generator=torch.Generator().manual_seed(5)) for n in (1, 2, 4)]
    for out in one[1:]:
        np.testing.assert_array_equal(out, one[0])


def test_an_indivisible_batch_raises(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="divide"):
        TG.generate_tokens(tm, _points(rows=3), num_faces=20, devices=CPU2)


def test_infer_dp_size_2_writes_the_files_of_one_device(tmp_path, monkeypatch):
    mesh = str(tmp_path / "sphere.obj")
    save_mesh_file(mesh, *icosphere(1))
    fleets = []
    fleet = TG.generate_fleet
    monkeypatch.setattr(TG, "generate_fleet",
                        lambda *a, **kw: fleets.append(len(a[2])) or fleet(*a, **kw))
    outs = []
    for dp in ("1", "2"):
        ws = str(tmp_path / f"dp{dp}")
        # 3 repeats in batches of 2: the trailing single row decodes on one device
        infer.main(["ArAE", "--device", "cpu", "--test_path", mesh, "--workspace", ws, *TINY,
                    "--generate_mode", "greedy", "--test_repeat", "3",
                    "--test_batch_size", "2", "--dp_size", dp])
        outs.append({name: open(os.path.join(ws, name), "rb").read()
                     for name in sorted(os.listdir(ws))})
    assert len(outs[0]) == 1 + 2 * 3 and outs[0] == outs[1]
    assert fleets == [2]  # the group of 2 on the fleet, the last row on one device
    with pytest.raises(ValueError, match="divide by --dp_size"):
        infer.main(["ArAE", "--device", "cpu", "--test_path", mesh, "--workspace",
                    str(tmp_path / "bad"), *TINY, "--test_batch_size", "3", "--dp_size", "2"])


def test_fleet_frontend_picks_the_least_loaded_engine_and_adds_up_stats(pair):
    _, _, tm = pair
    opt = TOptions(**BASE)
    tokenizer, _ = get_tokenizer(opt)
    fleet = serve.FleetFrontend(opt, TG.replicate_model(tm, CPU2), tokenizer, batch=2)
    try:
        fleet.frontends[0].engine.load = lambda: 3
        answer = fleet.submit(_points(1)[0], 20, 0)
        assert set(answer) == {"vertices", "faces", "tokens", "wall_s"}
        per = [fe.stats() for fe in fleet.frontends]
        assert per[0]["requests_done"] == 0 and per[1]["requests_done"] == 1
        stats = fleet.stats()
        assert [dict(e, uptime_s=0) for e in stats["engines"]] == [
            dict(e, uptime_s=0) for e in per]
        for key in ("requests_done", "queue_depth", "slots_busy", "slots_total", "tokens_out"):
            assert stats[key] == sum(s[key] for s in per), key
        assert stats["slots_total"] == 4 and stats["mean_wall_s"] == per[1]["mean_wall_s"]
    finally:
        fleet.shutdown()


def _http(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data), timeout=120) as r:
        return r.status, json.loads(r.read())


def test_serve_dp_size_2_answers_from_both_engines():
    opt = validate(parse_cli(["ArAE", *TINY, "--test_batch_size", "1", "--dp_size", "2"]))
    server, fleet = serve.build_server(opt, port=0, device="cpu", dtype=torch.float32)
    assert isinstance(fleet, serve.FleetFrontend) and len(fleet.frontends) == 2
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    answers = [None] * 4
    pts = np.random.default_rng(0).normal(size=(100, 3)).tolist()

    def send(i):
        answers[i] = _http(port, "/generate", {"points": pts, "num_faces": 10, "seed": i})

    try:
        threads = [threading.Thread(target=send, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        status, statz = _http(port, "/statz")
    finally:
        server.shutdown()
        server.server_close()
        fleet.shutdown()
    assert all(a is not None and a[0] == 200 for a in answers)
    assert status == 200 and statz["requests_done"] == 4 and len(statz["engines"]) == 2
    assert all(e["requests_done"] >= 1 for e in statz["engines"])


def test_launch_counts_and_the_scratch_cache_hold_under_threads(monkeypatch):
    """The decode fleet's threads share the wrappers' launch counts and the
    persistent kernels' scratch cache: 16 threads, a switch interval of a
    microsecond, each counting 2,000 launches and asking for one scratch
    entry; no count is lost and the entry is made once."""
    import sys

    from edgerunner_tpu_torch.ops import _build
    from edgerunner_tpu_torch.ops import decode_attention as DA

    monkeypatch.setattr(DA, "_SCRATCH", {})

    def wrapper():
        pass

    wrapper.launches = 0
    made = []

    def warps_of():
        # the library's answer comes through ctypes, which releases the lock
        time.sleep(1e-3)
        made.append(1)
        return 2

    def work():
        for _ in range(2000):
            _build.count_launch(wrapper)
        DA._scratch(("stress",), torch.device("cpu"), 0, 4, 8, warps_of)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 16 * 2000 and made == [1] and len(DA._SCRATCH) == 1

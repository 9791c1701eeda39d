"""--eval_mode generate of the port (eval.py, eval_mesh.py) against the JAX
package, on the CPU.

The metrics are host numpy and scipy copied with the same draws: equal to
the JAX functions exactly. `generate_eval` in f32 greedy decodes the JAX
tokens exactly (tests/test_torch_generate.py holds the streams), so its
stats, its written meshes and its padded last chunk equal the JAX eval's.
`eval_mesh`'s JSON lines equal tools/eval_mesh.py's. The decode takes the
run's compute dtype: a bf16 copy of f32 weights under --mixed_precision
bf16, the point basis still f32.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edgerunner_tpu.eval as JE
import edgerunner_tpu.generate as JG
import edgerunner_tpu_torch.eval as TE
import edgerunner_tpu_torch.generate as TG
from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.tokenizer import Engine as JEngine
from edgerunner_tpu_torch import eval_mesh
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.data import dataset as td
from edgerunner_tpu_torch.data import save_mesh_file
from edgerunner_tpu_torch.data._procgen import icosphere
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.tokenizer import Engine as TEngine
from edgerunner_tpu_torch.weights import load_state, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_POINTS = 40
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
          hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=512,
          use_num_face_cond=True, checkpointing=False, decode_bucket=64,
          generate_mode="greedy", point_num=N_POINTS, mixed_precision="no",
          eval_gen_samples=3, test_batch_size=2, test_num_face=(20,),
          synthetic_subdiv=1, batch_size=2)


def _meshes(seed):
    rng = np.random.default_rng(seed)
    v, f = icosphere(2)
    v2 = v * np.array([1.0, 0.7, 1.2]) + rng.normal(0, 0.02, v.shape)
    return (np.asarray(v, np.float64), np.asarray(f)), (v2, np.asarray(f[: len(f) // 2]))


@pytest.mark.parametrize("seed", range(3))
def test_metrics_equal_jax(seed):
    (gv, gf), (pv, pf) = _meshes(seed)
    for kw in (dict(n=500), dict(n=300, tau=0.05, seed=4)):
        assert TE.mesh_metrics(gv, gf, pv, pf, **kw) == JE.mesh_metrics(gv, gf, pv, pf, **kw)
    assert TE.mesh_metrics(gv, gf, pv, pf[:0]) == JE.mesh_metrics(gv, gf, pv, pf[:0])
    r = np.random.default_rng(seed)
    a, b = r.normal(size=(200, 3)), r.normal(size=(150, 3))
    assert TE.chamfer_l2(a, b) == JE.chamfer_l2(a, b)
    for tau in (0.01, 0.3):
        assert TE.fscore(a, b, tau) == JE.fscore(a, b, tau)
    na, nb = r.normal(size=(200, 3)), r.normal(size=(150, 3))
    assert TE.normal_consistency(a, na, b, nb) == JE.normal_consistency(a, na, b, nb)
    np.testing.assert_array_equal(TE.point_mesh_distance(a, pv, pf),
                                  JE.point_mesh_distance(a, pv, pf))


def test_identical_meshes_score_perfectly():
    (gv, gf), _ = _meshes(0)
    m = TE.mesh_metrics(gv, gf, gv, gf, n=400)
    assert m["chamfer_l2"] < 1e-12 and m["fscore"] == 1.0


@pytest.fixture(scope="module")
def pair():
    jm = JLMM(Options(**KW))
    rng = jax.random.PRNGKey(1)
    conds = jnp.zeros((1, N_POINTS, 3), jnp.float32)
    tokens = jnp.array([[1, 6, 7, 8, 2]])
    labels = jnp.concatenate([jnp.full((1, 18), -100), tokens[:, 1:]], axis=1)
    params = jm.init({"params": rng, "nof": rng, "dropout": rng}, conds, tokens,
                     labels, jnp.array([100]), jnp.array([23], jnp.int32))
    # widened random weights, so that the point clouds steer the streams
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0, params)
    tm = LMM(TOptions(**KW))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm


def _test_batches(opt, tokenizer):
    ds = td.SyntheticMeshDataset(opt, size=4, training=False, tokenizer=tokenizer)
    return list(td.DataLoader(ds, opt, opt.batch_size, shuffle=False, drop_last=False,
                              seed=opt.seed))


def test_generate_eval_equals_jax(pair, tmp_path, monkeypatch):
    jm, params, tm = pair
    topt, ttok = TOptions(**KW), TEngine(512, backend="LR_ABSCO")
    batches = _test_batches(topt, ttok)
    calls, tokens = [], []
    original = TG.generate_tokens

    def recorded(model, conds, **kw):
        calls.append(np.asarray(conds).shape)
        tokens.append(original(model, conds, **kw))
        return tokens[-1]

    monkeypatch.setattr(TG, "generate_tokens", recorded)
    jlog, tlog = [], []
    ws_j, ws_t = tmp_path / "jax", tmp_path / "torch"
    ws_j.mkdir()
    ws_t.mkdir()
    got = TE.generate_eval(tm, batches, topt, tokenizer=ttok, epoch=2, workspace=str(ws_t),
                           log=tlog.append)
    want = JE.generate_eval(jm, params, batches, Options(**KW),
                            tokenizer=JEngine(512, backend="LR_ABSCO"), epoch=2,
                            workspace=str(ws_j), log=jlog.append)
    # 3 samples in chunks of 2: the last chunk padded by repeating its row
    assert calls == [(2, N_POINTS, 3), (2, N_POINTS, 3)]
    conds = np.stack([c for batch in batches for c in batch["conds"]][:3])
    conds = np.concatenate([conds, conds[-1:]])
    jtokens = np.concatenate([JG.generate_tokens(jm, params, conds[i:i + 2], num_faces=20)
                              for i in (0, 2)])[:3]
    np.testing.assert_array_equal(np.concatenate(tokens)[:3], jtokens)
    assert got == want and [m[:24] for m in tlog] == [m[:24] for m in jlog]
    assert got["n"] + len(tlog) == 3 and got["n"] >= 1
    names = sorted(os.listdir(ws_t))
    assert names == sorted(os.listdir(ws_j))
    for name in names:
        assert name.startswith("testgen_ep2_")
        assert (ws_t / name).read_bytes() == (ws_j / name).read_bytes()


def test_decode_model_takes_the_compute_dtype(pair):
    _, _, tm = pair
    assert TE.decode_model(tm, TOptions(**KW)) is tm
    bf = TE.decode_model(tm, TOptions(**dict(KW, mixed_precision="bf16")))
    assert bf is not tm and bf.mesh_decoder.lm_head.weight.dtype == torch.bfloat16
    assert bf.point_encoder.point_embed.basis.dtype == torch.float32
    torch.testing.assert_close(bf.mesh_decoder.lm_head.weight,
                               tm.mesh_decoder.lm_head.weight.to(torch.bfloat16),
                               rtol=0, atol=0)
    assert TE.compute_dtype(TOptions(**dict(KW, mixed_precision="bf16"))) == torch.bfloat16


def test_eval_mesh_lines_equal_the_jax_tool(tmp_path, capsys):
    gt, pred = tmp_path / "gt", tmp_path / "pred"
    gt.mkdir()
    pred.mkdir()
    for seed, name in enumerate(("chair", "chair_arm")):
        (gv, gf), (pv, pf) = _meshes(seed)
        save_mesh_file(str(gt / f"{name}.obj"), gv, gf)
        save_mesh_file(str(pred / f"{name}_0_20f.obj"), pv, pf)
        save_mesh_file(str(pred / f"{name}_1.ply"), gv, gf)
    save_mesh_file(str(pred / "chair_2.obj"), np.eye(3), np.zeros((0, 3), np.int64))
    save_mesh_file(str(pred / "table_0.obj"), gv, gf)  # no ground truth: skipped
    args = ["--gt", str(gt), "--pred", str(pred), "--n", "400", "--bound", "0.9"]
    eval_mesh.main(args + ["--out", str(tmp_path / "port.json")])
    mine = capsys.readouterr().out.splitlines()
    theirs = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "eval_mesh.py"), *args, "--out",
         str(tmp_path / "jax.json")], capture_output=True, text=True, check=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout.splitlines()
    assert mine[:-1] == theirs[:-1] and len(mine) == 7
    assert json.loads(mine[-2])["aggregate"]["pairs"] == 5
    assert json.loads(mine[-2])["aggregate"]["degenerate"] == 1
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))

"""The port's checkpoint tools (`python -m edgerunner_tpu_torch.{spec_stats,
bench_spec,kv_quant_quality,make_manifest,visualize_traversal}`) against
the JAX package's scripts under tools/, on the CPU in f32 at --tiny's
widths.

Both sides take the same weights: the port's init at those widths with 2
draft heads (their zero-init weights drawn, so that the heads propose
something else than the next token), written once as a `.safetensors`
file for the port and handed to the JAX scripts, as a flax tree, in place
of their orbax restore. Both packages' ArAE preset is set to --tiny's widths for the
run, so that `bench_spec`, which has no --tiny, is as small; the JAX
scripts' bf16 casts are set to f32 (the port's tools run f32 on the
CPU), so that greedy streams are exact on both sides; the JAX
scripts' compilation cache is left off. Each JAX script runs once, each
port module once, and what they decode is recorded:

- spec_stats: the whole JSON equal (greedy f32 streams are identical, so
  the heads' match rates are);
- kv_quant_quality (`--mode both --kv_bits 4`: the int4 cache and int8
  weights): the exact streams equal, the quantised ones' mean match rate
  against the exact within QUANT_TOL of the JAX script's (the two
  quantise alike, but their f32 products round in another order, which
  may flip a near-tie of the quantised model);
- bench_spec (`--repeats 1`): both modes' streams equal, the JSON equal
  but for the times, and the tokens a verify pass accepted: the JAX loop's
  are read from the per-row positions of each of its verify passes;
- make_manifest: the manifest equal; visualize_traversal: the PLY equal
  byte for byte in both color modes;
- without a card every tool raises unless `--device cpu` is given.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.weights import (
    flax_from_state_dict,
    read_safetensors,
    reference_state_dict,
    write_safetensors,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("spec_stats", "bench_spec", "kv_quant_quality", "make_manifest",
         "visualize_traversal")
QUANT_TOL = 0.05
HEADS = 2
BATCH = 4
TIME_KEYS = ("meshes_per_min", "s_per_mesh")


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(mp, name: str, argv: list):
    mp.setattr(sys, "argv", [f"tools/{name}.py", *argv])
    jax_script(name).main()


def meshes(root: str) -> list:
    """Two procedural meshes (an .obj and, in a subfolder, a .ply)."""
    from edgerunner_tpu_torch.data._procgen import icosphere
    from edgerunner_tpu_torch.data.mesh_io import save_obj, save_ply

    v, f = icosphere(1)
    box_v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1],
                      [1, 1, 1], [0, 1, 1]], np.float32)
    box_f = np.array([[0, 1, 2], [0, 2, 3], [0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],
                      [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0], [4, 7, 6], [4, 6, 5]])
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    save_obj(os.path.join(root, "sphere.obj"), np.asarray(v, np.float32), f)
    save_ply(os.path.join(root, "sub", "box.ply"), box_v, box_f)
    return [os.path.join(root, "sphere.obj"), os.path.join(root, "sub", "box.ply")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every tool run on both sides; what each decoded, by tool and side."""
    import edgerunner_tpu.config as jconfig
    import edgerunner_tpu.generate as jgen
    import edgerunner_tpu.models.lmm as jlmm
    import edgerunner_tpu.train.checkpoint as jckpt
    import edgerunner_tpu.utils as jutils
    import edgerunner_tpu_torch.config as tconfig
    from edgerunner_tpu_torch import bench_spec, kv_quant_quality, spec_stats
    from edgerunner_tpu_torch.tool_common import TINY

    tmp = tmp_path_factory.mktemp("tools")
    jtiny = dataclasses.replace(jconfig.config_defaults["ArAE"], **TINY)
    ttiny = dataclasses.replace(tconfig.config_defaults["ArAE"], **TINY)
    model = init_weights(LMM(dataclasses.replace(ttiny, mtp_heads=HEADS)), 1)
    with torch.no_grad():
        for k, head in enumerate(model.mesh_decoder.mtp_proj):
            head.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(k))
    weights = str(tmp / "weights.safetensors")
    write_safetensors(weights, reference_state_dict(model))
    params = flax_from_state_dict(read_safetensors(weights))

    out = {"jax": {}, "torch": {}}
    decoded = {"jax": [], "torch": []}
    verify_idx = []  # the JAX spec loop's per-row positions of each verify pass

    def recording(fn, side):
        def call(*a, **kw):
            res = np.asarray(fn(*a, **kw))
            decoded[side].append(res)
            verify_idx.append(None)  # a call's boundary
            return res
        return call

    verify = jlmm.LMM.verify_step

    def verify_step(self, token_ids, k_cache, v_cache, index_vec):
        jax.debug.callback(lambda i: verify_idx.append(np.asarray(i)), index_vec)
        return verify(self, token_ids, k_cache, v_cache, index_vec)

    # the merge that follows an init takes every entry of these complete
    # weights, so the init is the weights themselves (the kv script's model
    # has no draft heads), and the f32 casts are plain conversions: no
    # compile for either
    no_heads = {"params": {k: v for k, v in params["params"].items()}}
    no_heads["params"]["mesh_decoder"] = {
        k: v for k, v in params["params"]["mesh_decoder"].items() if not k.startswith("mtp_")}

    def f32(tree, dtype):
        return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32)
                            if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)

    real_lmm = jlmm.LMM
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jconfig.config_defaults, "ArAE", jtiny)
        mp.setitem(tconfig.config_defaults, "ArAE", ttiny)
        mp.setattr(jutils, "enable_compilation_cache", lambda *a, **k: None)
        mp.setattr(jutils, "cast_params", f32)
        mp.setattr(jckpt, "init_lmm_params",
                   lambda model, opt, rng: f32(params if opt.mtp_heads else no_heads, None))
        mp.setattr(jlmm, "LMM", lambda opt, dtype=None, **kw: real_lmm(opt, dtype=jnp.float32,
                                                                       **kw))
        mp.setattr(real_lmm, "verify_step", verify_step)
        mp.setattr(jckpt, "restore_pytree", lambda path, target=None: params)
        mp.setattr(jgen, "generate_tokens", recording(jgen.generate_tokens, "jax"))
        for mod in (spec_stats, bench_spec, kv_quant_quality):
            mp.setattr(mod, "generate_tokens", recording(mod.generate_tokens, "torch"))

        common = {"spec_stats": ["--resume", weights, "--mtp_heads", str(HEADS), "--batch",
                                 str(BATCH), "--tiny"],
                  "kv_quant_quality": ["--resume", weights, "--mode", "both", "--kv_bits",
                                       "4", "--batch", str(BATCH), "--tiny"],
                  "bench_spec": ["--resume", weights, "--mtp_heads", str(HEADS), "--batch",
                                 str(BATCH), "--faces", "12", "--repeats", "1"]}
        for name, argv in common.items():
            for side in ("jax", "torch"):
                path = str(tmp / f"{name}_{side}.json")
                start = len(decoded[side])
                if side == "jax":
                    mark = len(verify_idx)
                    run_jax(mp, name, [*argv, "--out", path])
                    if name == "bench_spec":
                        out["jax_verify_idx"] = verify_idx[mark:]
                else:
                    mod = {"spec_stats": spec_stats, "bench_spec": bench_spec,
                           "kv_quant_quality": kv_quant_quality}[name]
                    mod.main([*argv, "--out", path, "--device", "cpu"])
                with open(path) as f:
                    out[side][name] = json.load(f)
                out[side][name + "/decoded"] = decoded[side][start:]

        root = tmp / "meshes"
        files = meshes(str(root))
        from edgerunner_tpu_torch import make_manifest, visualize_traversal

        run_jax(mp, "make_manifest", [str(root)])
        with open(root / "manifest.json") as f:
            out["jax"]["make_manifest"] = f.read()
        os.remove(root / "manifest.json")
        make_manifest.main([str(root), "--device", "cpu"])
        with open(root / "manifest.json") as f:
            out["torch"]["make_manifest"] = f.read()
        for mode in ("order", "type"):
            for side in ("jax", "torch"):
                ply = str(tmp / f"{mode}_{side}.ply")
                argv = [files[0], ply, "--mode", mode, "--steps", "50"]
                if side == "jax":
                    run_jax(mp, "visualize_traversal", argv)
                else:
                    visualize_traversal.main([*argv, "--device", "cpu"])
                with open(ply, "rb") as f:
                    out[side][f"visualize_traversal/{mode}"] = f.read()
    return out


def test_spec_stats_match_rates_equal_the_jax_script(runs):
    got, want = runs["torch"]["spec_stats"], runs["jax"]["spec_stats"]
    assert got == want
    assert len(got["head_match_rates"]) == HEADS and got["rows"][0]["n"] > 0
    np.testing.assert_array_equal(runs["torch"]["spec_stats/decoded"][0],
                                  runs["jax"]["spec_stats/decoded"][0])


def test_kv_quant_quality_exact_streams_equal_the_jax_script(runs):
    (got, _), (want, _) = runs["torch"]["kv_quant_quality/decoded"], \
        runs["jax"]["kv_quant_quality/decoded"]
    np.testing.assert_array_equal(got, want)
    assert (got >= 3).sum(1).min() > 9  # every row decodes a face or more


def test_kv_quant_quality_agreement_is_the_jax_scripts(runs):
    got, want = runs["torch"]["kv_quant_quality"], runs["jax"]["kv_quant_quality"]
    skip = ("weights", "backend", "mean_match_rate", "identical_streams", "rows")
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert set(got) == set(want) and got["backend"] == want["backend"] == "cpu"
    assert abs(got["mean_match_rate"] - want["mean_match_rate"]) <= QUANT_TOL
    assert [r["faces_exact"] for r in got["rows"]] == [r["faces_exact"] for r in want["rows"]]


def test_bench_spec_streams_equal_the_jax_script(runs):
    got, want = runs["torch"]["bench_spec/decoded"], runs["jax"]["bench_spec/decoded"]
    assert len(got) == len(want) == 4  # vanilla and spec, a warm-up and a repeat each
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    g, w = runs["torch"]["bench_spec"], runs["jax"]["bench_spec"]
    assert set(g) - set(w) == {"tokens_per_pass"} and not set(w) - set(g)
    for mode in ("vanilla", "spec"):
        assert set(g[mode]) == set(w[mode]) == set(TIME_KEYS)
    same = [k for k in w if k not in ("vanilla", "spec", "speedup")]
    assert {k: g[k] for k in same} == {k: w[k] for k in same}
    assert g["streams_identical"]


def test_bench_spec_tokens_per_pass_equal_the_jax_loops(runs):
    """The JAX spec warm-up call's verify passes (the third decode call):
    each pass's per-row advance, the last pass's up to the row's emitted
    count, averaged over the (row, pass) pairs that took tokens, as the
    port counts them."""
    idx = runs["jax_verify_idx"]
    calls, cur = [], []
    for x in idx:
        if x is None:
            calls.append(cur)
            cur = []
        else:
            cur.append(x)
    passes = np.stack(calls[2])                                    # [P, B]
    stream = runs["jax"]["bench_spec/decoded"][2]
    ends = [np.nonzero(r == 2)[0] for r in stream]
    n = np.array([e[0] + 1 if len(e) else stream.shape[1] for e in ends])
    steps = np.diff(np.concatenate([passes, (passes[0] + n)[None]]), axis=0)
    want = steps[steps > 0].mean()
    assert passes.shape[0] > 1
    got = runs["torch"]["bench_spec"]["tokens_per_pass"]
    np.testing.assert_allclose(got, round(float(want), 4), atol=1e-4)


def test_make_manifest_equals_the_jax_script(runs):
    got = json.loads(runs["torch"]["make_manifest"])
    assert got == json.loads(runs["jax"]["make_manifest"])
    assert got == {"sphere.obj": 80, os.path.join("sub", "box.ply"): 12}


@pytest.mark.parametrize("mode", ["order", "type"])
def test_visualize_traversal_ply_is_the_jax_scripts_byte_for_byte(runs, mode):
    got = runs["torch"][f"visualize_traversal/{mode}"]
    assert got == runs["jax"][f"visualize_traversal/{mode}"]
    assert got.startswith(b"ply\n") and len(got) > 80 * 16


@pytest.mark.parametrize("name", TOOLS)
def test_tool_without_a_card_or_device_cpu_raises(name):
    mod = importlib.import_module(f"edgerunner_tpu_torch.{name}")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    argv = {"spec_stats": ["--resume", "w.safetensors"],
            "bench_spec": ["--resume", "w.safetensors"],
            "kv_quant_quality": ["--random"], "make_manifest": ["."],
            "visualize_traversal": ["mesh.obj", "out.ply"]}[name]
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(argv)

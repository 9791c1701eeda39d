"""point_encoder_mode 'downsample' of the port against the JAX package, in
f32 on the CPU: farthest-point sampling (`ops/pointops.py`), the FPS point
encoder (`PointEncoderFPS`) and a downsample LMM's loss and gradients, with
the weights carried across through `state_dict_from_flax`; the weights'
round trip and an `export_lmm` export loaded with strict=True.

Tolerance: the FPS indices exactly (the squared distances are summed in the
JAX loop's order); the encoder's latent atol 1e-5, rtol 1e-5 (the repo's
module tolerance); the LMM's loss and gradients atol 1e-5, rtol 1e-4 (the
training parity's, tests/test_torch_train.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.models.point_encoder import PointEncoderFPS as JPointEncoderFPS
from edgerunner_tpu.ops.pointops import farthest_point_sample as jfps
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.models.point_encoder import PointEncoderFPS
from edgerunner_tpu_torch.ops.pointops import farthest_point_sample
from edgerunner_tpu_torch.weights import (
    _point_encoder,
    flax_from_state_dict,
    load_state,
    reference_state_dict,
    state_dict_from_flax,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-5, rtol=1e-4)
B, N_POINTS, L = 2, 48, 20
KW = dict(cond_mode="point", point_encoder_mode="downsample", point_latent_size=16,
          num_cond_tokens=17, point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
          hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=256,
          use_num_face_cond=True, checkpointing=True, point_num=N_POINTS)
KEYS = ("conds", "tokens", "labels", "num_faces", "lengths")


@pytest.mark.parametrize("seed", range(5))
def test_fps_indices_equal_jax(seed):
    r = np.random.default_rng(seed)
    pts = r.normal(size=(3, 300, 3)).astype(np.float32)
    pts[1, 150:] = pts[1, :150]  # duplicated points: equal distances, ties
    pts[2] *= 1e-3               # a small cloud
    got = farthest_point_sample(torch.tensor(pts), 64)
    want = np.asarray(jfps(jnp.asarray(pts), 64))
    assert got.dtype == torch.int64 and got.shape == (3, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0] == 0).all()


def test_fps_takes_the_first_of_equal_maxima():
    # every point of a square's corners is as far as the others' diagonal
    pts = torch.tensor([[[0., 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [1, 1, 0]]])
    np.testing.assert_array_equal(farthest_point_sample(pts, 4).numpy(), [[0, 3, 1, 2]])
    want = np.asarray(jfps(jnp.asarray(pts.numpy()), 4))
    np.testing.assert_array_equal(farthest_point_sample(pts, 4).numpy(), want)


def _jax_encoder():
    enc = JPointEncoderFPS(hidden_dim=64, num_heads=2, latent_size=16, latent_dim=8)
    pts = np.random.default_rng(7).normal(size=(B, N_POINTS, 3)).astype(np.float32)
    params = enc.init(jax.random.PRNGKey(3), jnp.asarray(pts))
    return enc, jax.tree.map(np.asarray, params), pts


def test_point_encoder_fps_matches_jax():
    enc, params, pts = _jax_encoder()
    sd = {}
    _point_encoder(sd, "enc", params["params"])
    assert not any(k.endswith("query_embed") for k in sd)
    port = PointEncoderFPS(64, 2, 16, 8)
    load_state(port, {k[len("enc."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.tensor(pts)).numpy()
    want = np.asarray(enc.apply(params, jnp.asarray(pts)))
    assert got.shape == (B, 16, 8)
    np.testing.assert_allclose(got, want, **MODULE_TOL)


def test_point_encoder_fps_samples_outside_the_checkpoint():
    """FPS takes no gradient and runs once under remat (it is outside the
    checkpointed block); the gradients equal those without remat."""
    _, params, pts = _jax_encoder()
    sd = {}
    _point_encoder(sd, "enc", params["params"])
    state = {k[len("enc."):]: v for k, v in sd.items()}
    grads = []
    for remat in (False, True):
        port = PointEncoderFPS(64, 2, 16, 8, remat=remat)
        load_state(port, state)
        x = torch.tensor(pts, requires_grad=True)
        out = port(x)
        grads.append(torch.autograd.grad(out.square().sum(), [x, *port.parameters()]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    C = KW["num_cond_tokens"]
    lens = [L, L - 6]
    tokens = np.zeros((B, L + 2), np.int32)
    labels = np.full((B, C + L + 2), -100, np.int32)
    for i, n in enumerate(lens):
        coords = r.integers(6, 300, n)
        tokens[i, :n + 2] = np.concatenate([[1], coords, [2]])
        labels[i, C + 1:C + n + 2] = np.concatenate([coords, [2]])
    return {"conds": r.normal(size=(B, N_POINTS, 3)).astype(np.float32),
            "tokens": tokens, "labels": labels,
            "num_faces": np.array([100, 3000], np.int32),
            "lengths": np.array([C + n + 2 for n in lens], np.int32)}


@pytest.fixture(scope="module")
def pair():
    jm = JLMM(Options(**KW))
    b = _batch()
    rng = jax.random.PRNGKey(0)
    params = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                              *(jnp.asarray(b[k]) for k in KEYS))
    params = jax.tree.map(np.asarray, params)
    tm = LMM(TOptions(**KW))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm


def test_downsample_lmm_loss_and_gradients_match_jax(pair):
    jm, params, tm = pair
    b = _batch(1)
    out = tm(*(torch.as_tensor(b[k]) for k in KEYS), train=False)
    names = dict(tm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(out["loss"], list(names.values()))))

    def loss_fn(p):
        o = jm.apply(p, *(jnp.asarray(b[k]) for k in KEYS), train=False)
        return o["loss"], o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    for k in ("loss", "loss_ce", "loss_kl"):
        np.testing.assert_allclose(out[k].item(), float(jout[k]), **TOL)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    assert "point_encoder.query_embed" not in want and len(grads) > 40
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n], **TOL, err_msg=n)


def test_downsample_weights_round_trip(pair):
    _, params, tm = pair
    sd = state_dict_from_flax(params)
    tree = flax_from_state_dict(sd)
    assert "query_embed" not in tree["params"]["point_encoder"]
    flat_in = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_out = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert set(flat_in) == set(flat_out)
    for k, v in flat_in.items():
        np.testing.assert_array_equal(flat_out[k], v, err_msg=str(k))
    # and from a seeded port model: its state dict, to flax and back
    seeded = init_weights(LMM(TOptions(**KW)), 5)
    ref = reference_state_dict(seeded)
    again = state_dict_from_flax(flax_from_state_dict(ref))
    assert set(again) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(again[k], ref[k], err_msg=k)


def test_export_lmm_of_a_downsample_lmm_loads_strictly(pair):
    _, params, _ = pair
    spec = importlib.util.spec_from_file_location(
        "export_reference_ckpt", os.path.join(ROOT, "tools", "export_reference_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    export = mod.export_lmm(params)
    model = load_state(LMM(TOptions(**KW)), export)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), export[k], err_msg=k)

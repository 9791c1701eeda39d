"""The port's DiT and MDiT against the JAX package's, on the CPU, in f32.

The same weights (a flax MDiT init converted through
`weights.mdit_state_dict_from_flax`) and the same inputs (numpy, from a
seed, the initial noise included) go through both, at the sizes of
tests/test_serve_pipeline.py. Tolerances, each stated where it is used:
single modules within atol/rtol 1e-5 (f32 sums in another order), the
image condition within 1e-4 (CLIP's two layers and flax's E[x^2] - E[x]^2
variance), DDIM loops within 1e-4 of the latents' scale (guidance 7.5
multiplies the difference of two DiT outputs every step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.config import Options
from edgerunner_tpu.diffusion import DiffusionSchedule, ddim_timesteps
from edgerunner_tpu.models import dit as JD
from edgerunner_tpu.models.mdit import MDiT as JMDiT
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models import dit as TD
from edgerunner_tpu_torch.models.mdit import MDiT, run_mdit
from edgerunner_tpu_torch.weights import (
    flax_from_mdit_state_dict,
    init_mdit_weights,
    load_state,
    mdit_state_dict_from_flax,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the sizes of tests/test_serve_pipeline.py:20-27
SMALL = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
             point_hidden_dim=32, point_num_heads=4, point_latent_dim=8,
             dit_hidden_dim=32, dit_num_heads=4, dit_num_layers=2,
             clip_image_size=32, clip_patch_size=8, clip_hidden_dim=32,
             clip_num_heads=4, clip_num_layers=2,
             hidden_dim=64, num_layers=2, num_heads=4, max_seq_length=256,
             use_num_face_cond=True, checkpointing=False, decode_bucket=64,
             generate_mode="greedy", point_num=64)
TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want, atol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def pair():
    """(jax MDiT, params, port MDiT) with the same weights."""
    opt = Options(**SMALL)
    jm = JMDiT(opt)
    rng = jax.random.PRNGKey(0)
    params = jm.init({"params": rng, "cfg": rng, "noise": rng, "time": rng},
                     jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 64, 3)), train=True)
    params = jax.tree.map(np.asarray, params)
    tm = MDiT(TOptions(**SMALL))
    load_state(tm, mdit_state_dict_from_flax(params))
    return jm, params, tm.eval()


def _images(n=1, seed=0, size=32):
    return np.random.default_rng(seed).uniform(size=(n, size, size, 3)).astype(np.float32)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_timestep_embedding_matches_jax():
    """atol 1e-4: an f32 angle near 999 is resolved to 6.1e-5, and the two
    frameworks' exp and sin round it differently."""
    t = np.array([0, 1, 37, 500, 999], np.int32)
    for dim in (256, 33):
        _close(TD.timestep_embedding(torch.tensor(t), dim),
               JD.timestep_embedding(jnp.asarray(t), dim), atol=1e-4)


def test_weights_round_trip(pair):
    _, params, tm = pair
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = flax_from_mdit_state_dict(sd)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    again = mdit_state_dict_from_flax(back)
    assert set(again) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(again[k], sd[k])


@torch.no_grad()
def test_dit_layer_matches_jax(pair):
    _, params, tm = pair
    x, c, ta = _rand(2, 16, 32, seed=1), _rand(2, 5, 32, seed=2), _rand(2, 6, 32, seed=3)
    want = JD.DiTLayer(32, 4).apply({"params": params["params"]["dit"]["layers_0"]},
                                    jnp.asarray(x), jnp.asarray(c), jnp.asarray(ta))
    got = tm.dit.layers[0](torch.tensor(x), torch.tensor(c), torch.tensor(ta))
    _close(got, want, **TOL)


@torch.no_grad()
def test_dit_matches_jax(pair):
    jm, params, tm = pair
    x, c = _rand(2, 16, 8, seed=4), _rand(2, 5, 32, seed=5)
    t = np.array([1, 901], np.int32)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(c), jnp.asarray(t),
                    method=lambda m, x, c, t: m.dit(x, c, t))
    got = tm.dit(torch.tensor(x), torch.tensor(c), torch.tensor(t))
    _close(got, want, **TOL)


@torch.no_grad()
@pytest.mark.parametrize("size", [32, 48])
def test_get_cond_and_prepare_cond_cfg_match_jax(pair, size):
    """At CLIP's size and at a larger one that get_cond resizes."""
    jm, params, tm = pair
    img = _images(2, seed=size, size=size)
    want = jm.apply(params, jnp.asarray(img), method=JMDiT.get_cond)
    _close(tm.get_cond(torch.tensor(img)), want, atol=1e-4, rtol=1e-4)
    want = jm.apply(params, jnp.asarray(img), method=JMDiT.prepare_cond_cfg)
    got = tm.prepare_cond_cfg(torch.tensor(img))
    assert got.shape == (4, 17, 32) and not got[:2].any()
    _close(got, want, atol=1e-4, rtol=1e-4)


@torch.no_grad()
@pytest.mark.parametrize("pred", ["v_prediction", "epsilon"])
def test_denoise_step_matches_jax(pair, pred):
    jm, params, tm = pair
    if pred != "v_prediction":
        jm = JMDiT(dataclasses.replace(jm.opt, noise_scheduler_predtype=pred))
        tm2 = MDiT(TOptions(**SMALL, noise_scheduler_predtype=pred))
        tm2.load_state_dict(tm.state_dict())
        tm = tm2.eval()
    lat = _rand(2, 16, 8, seed=6)
    cond_cat = _rand(4, 5, 32, seed=7)
    for t in (991, 11, 1):
        want = jm.apply(params, jnp.asarray(lat), jnp.asarray(cond_cat), t, 7.5, 100,
                        method=JMDiT.denoise_step)
        got = tm.denoise_step(torch.tensor(lat), torch.tensor(cond_cat), t, 7.5, 100)
        _close(got, want, atol=1e-4, rtol=1e-4)


def _jax_loop(jm, params, images, noise, steps, num_repeat, init_latents=None,
              strength=0.5):
    """The JAX sampler's loop (mdit.py:159-181), stepped through model.apply."""
    sched = DiffusionSchedule(prediction_type=jm.opt.noise_scheduler_predtype)
    ts = ddim_timesteps(sched, steps)
    cond_cat = jm.apply(params, jnp.asarray(images), method=JMDiT.prepare_cond_cfg)
    cond_cat = jnp.repeat(cond_cat, num_repeat, axis=0)
    lat, start = jnp.asarray(noise), 0
    if init_latents is not None:
        start = int(steps * strength)
        lat = sched.add_noise(jnp.asarray(init_latents), lat, ts[start])
    for i in range(start, steps):
        lat = jm.apply(params, lat, cond_cat, int(ts[i]), 7.5, steps,
                       method=JMDiT.denoise_step)
    return np.asarray(lat)


def test_run_mdit_matches_the_jax_loop(pair):
    """10 steps, 2 repeats of each of 2 images, from the same noise."""
    jm, params, tm = pair
    images, noise = _images(2, seed=8), _rand(4, 16, 8, seed=9)
    want = _jax_loop(jm, params, images, noise, 10, 2)
    got = run_mdit(tm, images, num_inference_steps=10, num_repeat=2, noise=noise).numpy()
    assert got.shape == (4, 16, 8) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_run_mdit_img2img_strength_matches_the_jax_loop(pair):
    jm, params, tm = pair
    images, noise = _images(1, seed=10), _rand(2, 16, 8, seed=11)
    init = _rand(2, 16, 8, seed=12)
    for strength in (0.3, 0.5):
        want = _jax_loop(jm, params, images, noise, 10, 2, init_latents=init,
                         strength=strength)
        got = run_mdit(tm, images, num_inference_steps=10, num_repeat=2,
                       latents=torch.tensor(init), strength=strength, noise=noise).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_run_mdit_draws_its_noise_from_the_generator(pair):
    *_, tm = pair
    images = _images(1, seed=13)
    a = run_mdit(tm, images, num_inference_steps=3,
                 generator=torch.Generator().manual_seed(5))
    b = run_mdit(tm, images, num_inference_steps=3,
                 generator=torch.Generator().manual_seed(5))
    c = run_mdit(tm, images, num_inference_steps=3,
                 generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_init_mdit_weights_scales():
    tm = init_mdit_weights(MDiT(TOptions(**SMALL)), seed=0)
    sd = tm.state_dict()
    assert abs(sd["dit.pos_embed"].std().item() - 32 ** -0.5) < 0.02
    assert abs(sd["dit.layers.0.attn1.qkv_proj.weight"].std().item() - 0.02) < 0.004
    fc1 = sd["image_encoder.vision_model.encoder.layers.0.mlp.fc1.weight"]
    assert abs(fc1.std().item() - 32 ** -0.5) < 0.03
    assert not sd["dit.proj_in.bias"].any()
    again = init_mdit_weights(MDiT(TOptions(**SMALL)), seed=0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)

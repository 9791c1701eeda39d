"""The port's diffusion schedule and DDIM step against edgerunner_tpu.diffusion,
on the CPU. Inputs are numpy arrays from a seed. Tolerance: the schedule's
table exactly (both build it in float64 numpy and cast to f32); every
elementwise result within atol and rtol 1e-6, a few f32 ulps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.diffusion import schedulers as J
from edgerunner_tpu_torch.diffusion import schedulers as T
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-6, rtol=1e-6)
PRED_TYPES = ("v_prediction", "epsilon")


def _pair(pred):
    return J.DiffusionSchedule(prediction_type=pred), T.DiffusionSchedule(prediction_type=pred)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(4, 16, 8)).astype(np.float32)
    noise = rng.normal(size=(4, 16, 8)).astype(np.float32)
    t = np.array([0, 1, 500, 999], np.int32)
    return x0, noise, t


def test_alphas_cumprod_is_the_float64_table_cast_to_f32():
    js, ts = _pair("v_prediction")
    a = ts.alphas_cumprod
    assert a.dtype == torch.float32 and a.shape == (1000,)
    np.testing.assert_array_equal(a.numpy(), np.asarray(js.alphas_cumprod))
    # an f32 linspace would give another table
    f32 = torch.cumprod(1 - torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2, 0)
    assert not torch.equal(f32, a)


@pytest.mark.parametrize("pred", PRED_TYPES)
@pytest.mark.parametrize("fn", ["add_noise", "get_velocity"])
def test_noising_matches_jax(pred, fn):
    js, ts = _pair(pred)
    x0, noise, t = _inputs()
    want = getattr(js, fn)(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = getattr(ts, fn)(torch.tensor(x0), torch.tensor(noise), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pred", PRED_TYPES)
def test_snr_and_min_snr_weight_match_jax(pred):
    js, ts = _pair(pred)
    t = np.array([0, 10, 250, 500, 999], np.int32)
    np.testing.assert_allclose(ts.snr(torch.tensor(t)).numpy(),
                               np.asarray(js.snr(jnp.asarray(t))), **TOL)
    np.testing.assert_allclose(ts.min_snr_weight(torch.tensor(t), 5.0).numpy(),
                               np.asarray(js.min_snr_weight(jnp.asarray(t), 5.0)), **TOL)


@pytest.mark.parametrize("steps", [1, 10, 50, 100, 1000])
def test_ddim_timesteps_match_jax(steps):
    js, ts = _pair("v_prediction")
    np.testing.assert_array_equal(T.ddim_timesteps(ts, steps), J.ddim_timesteps(js, steps))


@pytest.mark.parametrize("pred", PRED_TYPES)
def test_ddim_step_matches_jax_over_a_whole_schedule(pred):
    """Every timestep of a 10-step and a 100-step schedule, the last ones
    (prev_t < 0: set_alpha_to_one=False) included."""
    js, ts = _pair(pred)
    x0, noise, _ = _inputs(1)
    for steps in (10, 100):
        for t in J.ddim_timesteps(js, steps):
            want = J.ddim_step(js, jnp.asarray(noise), jnp.int32(t), jnp.asarray(x0), steps)
            got = T.ddim_step(ts, torch.tensor(noise), int(t), torch.tensor(x0), steps)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

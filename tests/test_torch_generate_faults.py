"""Two faults of the port's decode loop, fixed: it stops soon after every row
has emitted EOS (the JAX loop stops at once), and sampling without a
generator is seeded from `opt.seed` (the JAX package defaults to
PRNGKey(opt.seed))."""

import dataclasses

import numpy as np
import pytest
import torch

import edgerunner_tpu_torch.generate as TG
from edgerunner_tpu_torch.config import Options
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.ops.sampling import EOS_ID, PAD_ID
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

OPT = Options(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
              point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
              hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=512,
              use_num_face_cond=True, checkpointing=False, decode_bucket=64,
              generate_mode="greedy", point_num=40)
EOS_AFTER = (0, 40, 20)  # steps after which each row's EOS logit is raised


@pytest.fixture(scope="module")
def points():
    return np.random.default_rng(0).normal(size=(3, 40, 3)).astype(np.float32)


def _eos_model(calls):
    """A tiny model whose rows reach for EOS after EOS_AFTER[row] steps;
    counts its decode steps in `calls`."""
    model = init_weights(LMM(OPT), 0).eval()
    step = model.step

    def eos_step(token_ids, caches, index):
        calls.append(index)
        logits = step(token_ids, caches, index)
        i = len(calls)
        for row, after in enumerate(EOS_AFTER):
            if i >= after:
                logits[row, :, EOS_ID] += 1e4
        return logits

    model.step = eos_step
    return model


def test_decode_stops_within_32_steps_of_the_last_eos(points, monkeypatch):
    calls = []
    tokens = TG.generate_tokens(_eos_model(calls), points, max_new_tokens=512)
    ends = [int(np.nonzero(row == EOS_ID)[0][0]) for row in tokens]
    assert max(ends) >= 40
    steps = len(calls) + 1  # tokens chosen: one after the prefill, one per step
    assert steps < tokens.shape[1] and steps - 1 - max(ends) <= 2 * TG.DECODE_CHUNK == 32
    # the same tokens as a loop that never looks at the EOS flags
    monkeypatch.setattr(TG, "DECODE_CHUNK", 10 ** 6)
    full_calls = []
    full = TG.generate_tokens(_eos_model(full_calls), points, max_new_tokens=512)
    assert len(full_calls) + 1 == full.shape[1] == tokens.shape[1]
    assert np.array_equal(tokens, full)
    for row, end in zip(full, ends):
        assert (row[end + 1:] == PAD_ID).all()


def test_sampling_without_a_generator_is_seeded(points):
    opt = dataclasses.replace(OPT, generate_mode="sample", seed=7)
    model = init_weights(LMM(opt), 0).eval()
    runs = [TG.generate_tokens(model, points, max_new_tokens=64) for _ in range(2)]
    torch.manual_seed(123)  # the global generator does not enter
    runs.append(TG.generate_tokens(model, points, max_new_tokens=64))
    assert np.array_equal(runs[0], runs[1]) and np.array_equal(runs[0], runs[2])
    seeded = TG.generate_tokens(model, points, max_new_tokens=64,
                                generator=torch.Generator().manual_seed(7))
    assert np.array_equal(runs[0], seeded)

"""The port's weight mapping: a flax init converts to a state_dict with the
reference names of tools/export_reference_ckpt.py:export_lmm and loads with
strict=True; the .safetensors reader round-trips the tool's format."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.weights import load_state, read_safetensors, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=64, point_num_heads=2, point_latent_dim=8,
          hidden_dim=96, num_layers=2, num_heads=2, max_seq_length=128,
          use_num_face_cond=True, checkpointing=False, point_num=32)


def _export_lmm():
    spec = importlib.util.spec_from_file_location(
        "export_reference_ckpt", os.path.join(ROOT, "tools", "export_reference_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.export_lmm


@pytest.fixture(scope="module")
def flax_tree():
    jm = JLMM(Options(**KW))
    rng = jax.random.PRNGKey(0)
    tokens = jnp.array([[1, 6, 7, 8, 2]])
    labels = jnp.concatenate([jnp.full((1, 18), -100), tokens[:, 1:]], axis=1)
    params = jm.init({"params": rng, "nof": rng, "dropout": rng},
                     jnp.zeros((1, 32, 3)), tokens, labels, jnp.array([100]),
                     jnp.array([23], jnp.int32))
    return jax.tree.map(np.asarray, params)


def test_names_and_values_equal_export_lmm(flax_tree):
    ours = state_dict_from_flax(flax_tree)
    theirs = _export_lmm()(flax_tree)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_strict_load_matches_the_model(flax_tree):
    model = LMM(TOptions(**KW))
    sd = state_dict_from_flax(flax_tree)
    assert set(model.state_dict()) == set(sd)
    load_state(model, sd)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_missing_or_extra_names_are_refused(flax_tree):
    sd = state_dict_from_flax(flax_tree)
    model = LMM(TOptions(**KW))
    with pytest.raises(RuntimeError):
        load_state(model, {k: v for k, v in sd.items() if k != "mesh_decoder.lm_head.weight"})
    with pytest.raises(RuntimeError):
        load_state(model, {**sd, "extra.weight": np.zeros(3, np.float32)})


def test_bf16_model_keeps_the_basis_in_f32(flax_tree):
    model = LMM(TOptions(**KW), dtype=torch.bfloat16)
    load_state(model, state_dict_from_flax(flax_tree))
    assert model.point_encoder.point_embed.basis.dtype == torch.float32
    assert model.mesh_decoder.lm_head.weight.dtype == torch.bfloat16


def test_safetensors_round_trip_f32(flax_tree, tmp_path):
    from safetensors.numpy import save_file

    sd = {k: np.ascontiguousarray(v) for k, v in state_dict_from_flax(flax_tree).items()}
    path = str(tmp_path / "lmm.safetensors")
    save_file(sd, path)
    back = read_safetensors(path)
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    load_state(LMM(TOptions(**KW)), back)


def test_safetensors_bf16_and_ints(tmp_path):
    from safetensors.torch import save_file

    t = {"a": torch.randn(3, 5).bfloat16(), "b": torch.arange(7, dtype=torch.int64),
         "c": torch.randn(2, 2, 2)}
    path = str(tmp_path / "x.safetensors")
    save_file(t, path)
    back = read_safetensors(path)
    np.testing.assert_array_equal(back["a"], t["a"].float().numpy())
    np.testing.assert_array_equal(back["b"], t["b"].numpy())
    np.testing.assert_array_equal(back["c"], t["c"].numpy())


def test_init_weights_is_seeded_and_zeroes_the_pad_row():
    a = init_weights(LMM(TOptions(**KW)), seed=3).state_dict()
    b = init_weights(LMM(TOptions(**KW)), seed=3).state_dict()
    c = init_weights(LMM(TOptions(**KW)), seed=4).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["mesh_decoder.lm_head.weight"], c["mesh_decoder.lm_head.weight"])
    assert not a["mesh_decoder.model.embd.weight"][0].any()
    std = a["mesh_decoder.model.layers.0.fc1.weight"].std().item()
    assert 0.018 < std < 0.022

"""The port's CLIP vision tower against the JAX package's, on the CPU, in f32.

The same weights (a flax init converted through the port's weight mapping)
and the same pixels (numpy, from a seed) go through both. Tolerances: the
tower within atol and rtol 1e-4 (two layers of f32 sums in another order,
and flax's LayerNorm takes the variance as E[x^2] - E[x]^2); the resize
within 1e-5 (the same triangle filter); HuggingFace's CLIPVisionModel, whose
names the port's tower has, within 2e-4 as tests/test_clip_parity.py holds
the JAX tower to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgerunner_tpu.models import clip_vit as J
from edgerunner_tpu_torch.models import clip_vit as T
from edgerunner_tpu_torch.weights import clip_state_dict_from_flax, load_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(image_size=28, patch_size=14, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4)


@pytest.fixture(scope="module")
def towers():
    jt = J.CLIPVisionTower(J.CLIPVisionConfig(**SMALL))
    x = jnp.zeros((1, 28, 28, 3))
    params = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(3), x))
    tt = T.CLIPVisionTower(T.CLIPVisionConfig(**SMALL))
    load_state(tt, clip_state_dict_from_flax(params["params"]))
    return jt, params, tt.eval()


def test_tower_matches_jax(towers):
    jt, params, tt = towers
    x = np.random.default_rng(0).normal(size=(2, 28, 28, 3)).astype(np.float32)
    want = np.asarray(jt.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tt(torch.tensor(x)).numpy()
    assert got.shape == (2, 5, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_tower_names_are_huggingface_names(towers):
    *_, tt = towers
    names = set(tt.state_dict())
    assert "vision_model.embeddings.patch_embedding.weight" in names
    assert "vision_model.encoder.layers.1.mlp.fc2.bias" in names
    assert "vision_model.pre_layrnorm.weight" in names
    assert tt.vision_model.embeddings.patch_embedding.bias is None
    assert all(ln.eps == 1e-5 for ln in tt.modules() if isinstance(ln, torch.nn.LayerNorm))


@pytest.mark.parametrize("src,size", [(56, 28), (512, 224), (224, 224)])
def test_preprocess_images_matches_jax(src, size):
    """Downscaling antialiases, as jax.image.resize's bilinear does."""
    x = np.random.default_rng(src).uniform(size=(2, src, src, 3)).astype(np.float32)
    want = np.asarray(J.preprocess_images(jnp.asarray(x), size=size))
    got = T.preprocess_images(torch.tensor(x), size=size).numpy()
    assert got.shape == (2, size, size, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_huggingface_state_dict_loads_strictly_and_matches():
    """A HuggingFace CLIPVisionModel state_dict loads into the port's tower
    (strict, after dropping HF_UNUSED) and gives HF's last_hidden_state; the
    JAX package's converter reads the same weights."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPVisionConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        image_size=28, patch_size=14, hidden_act="gelu", layer_norm_eps=1e-5)
    torch.manual_seed(0)
    hf = transformers.CLIPVisionModel(cfg).eval()
    tt = T.CLIPVisionTower(T.CLIPVisionConfig(**SMALL))
    tt.load_state_dict(T.clip_state_from_hf(hf.state_dict()), strict=True)
    x = np.random.default_rng(1).normal(size=(2, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.tensor(x).permute(0, 3, 1, 2)).last_hidden_state.numpy()
        got = tt(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    # the same weights through the JAX converter and back through the port's
    # mapping give the HF names and values again
    tree = J.convert_hf_clip_params(hf.state_dict())
    back = clip_state_dict_from_flax(tree)
    ours = {k: v.numpy() for k, v in tt.state_dict().items()}
    assert set(back) == set(ours)
    for k in ours:
        np.testing.assert_array_equal(back[k], ours[k])

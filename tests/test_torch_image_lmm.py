"""The port's image-conditioned LMM (cond_mode 'image', the default preset)
against the JAX package's, in f32 on the CPU, at a tiny width: a CLIP tower
of 28-pixel images in 14-pixel patches (5 tokens), 32 wide, 2 layers of 4
heads; a decoder 64 wide, 2 layers of 2 heads.

The same weights (a flax init carried across through `state_dict_from_flax`)
and the same inputs (numpy, from a seed) go through both: `encode_cond` of
64 x 64 images (resized inside, antialiased as jax.image.resize does), the
forward's loss and logits, one step's gradients with the tower frozen and
trained, and greedy token streams. Tolerance: atol 1e-5, rtol 1e-4 in f32
(the two frameworks sum the same products in another order, and flax's
LayerNorm takes the variance as E[x^2] - E[x]^2). Then the weight
conversion's round trip with the tower, and the `--resume2` overlay of a
tower in HuggingFace's naming.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edgerunner_tpu.generate as JG
import edgerunner_tpu_torch.generate as TG
from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.config import validate
from edgerunner_tpu_torch.models.clip_vit import HF_UNUSED
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.weights import (
    flax_from_state_dict,
    load_state,
    overlay_checkpoint,
    reference_state_dict,
    state_dict_from_flax,
    write_safetensors,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
B, L, SRC = 2, 12, 64
CLIP = dict(clip_image_size=28, clip_patch_size=14, clip_hidden_dim=32,
            clip_intermediate_dim=64, clip_num_layers=2, clip_num_heads=4)
KW = dict(cond_mode="image", **CLIP, hidden_dim=64, num_layers=2, num_heads=2,
          max_seq_length=256, checkpointing=False, decode_bucket=64, generate_mode="greedy")


def _kw(nf_cond: bool, **over) -> dict:
    # 4 patches + the class token, + the num-face token
    return dict(KW, use_num_face_cond=nf_cond, num_cond_tokens=5 + nf_cond, **over)


def _images(seed=0, n=B):
    return np.random.default_rng(seed).uniform(size=(n, SRC, SRC, 3)).astype(np.float32)


def _batch(C: int, seed=0) -> dict:
    r = np.random.default_rng(seed + 1)
    lens = [L, L - 5]
    tokens = np.zeros((B, L + 2), np.int32)
    labels = np.full((B, C + L + 2), -100, np.int32)
    for i, n in enumerate(lens):
        coords = r.integers(6, 300, n)
        tokens[i, :n + 2] = np.concatenate([[1], coords, [2]])
        labels[i, C + 1:C + n + 2] = np.concatenate([coords, [2]])
    return {"conds": _images(seed), "tokens": tokens, "labels": labels,
            "num_faces": np.array([100, 3000], np.int32),
            "lengths": np.array([C + n + 2 for n in lens], np.int32)}


ARGS = ("conds", "tokens", "labels", "num_faces", "lengths")


@functools.lru_cache(maxsize=None)
def _pair(nf_cond: bool, scale: float = 1.0, freeze: bool = True):
    """(jax model, flax params as numpy, port model) with the same weights."""
    kw = _kw(nf_cond, freeze_encoder=freeze)
    jm = JLMM(Options(**kw))
    b = _batch(kw["num_cond_tokens"])
    rng = jax.random.PRNGKey(0)
    params = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                              *(jnp.asarray(b[k]) for k in ARGS))
    params = jax.tree.map(lambda x: np.asarray(x) * scale, params)
    tm = LMM(TOptions(**kw))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm


@pytest.fixture(scope="module", params=[False, True], ids=["no_nf", "nf"])
def pair(request):
    return (request.param, *_pair(request.param))


def test_validate_takes_the_default_preset_and_counts_clip_tokens():
    from edgerunner_tpu_torch.config import config_defaults

    opt = validate(dataclasses.replace(config_defaults["default"]))
    assert opt.cond_mode == "image" and opt.num_cond_tokens == 257
    validate(dataclasses.replace(opt, use_num_face_cond=True, num_cond_tokens=258))
    # point_encoder_mode is not read in image mode
    validate(dataclasses.replace(opt, point_encoder_mode="downsample"))
    for bad in (dict(num_cond_tokens=258), dict(use_num_face_cond=True),
                dict(clip_image_size=448)):
        with pytest.raises(ValueError, match="num_cond_tokens"):
            validate(dataclasses.replace(opt, **bad))


def test_encode_cond_loss_and_logits_match_jax(pair):
    nf_cond, jm, params, tm = pair
    b = _batch(5 + nf_cond)
    jemb, _ = jax.jit(functools.partial(jm.apply, method=jm.encode_cond))(
        params, jnp.asarray(b["conds"]), jnp.asarray(b["num_faces"]))
    jout = jax.jit(functools.partial(jm.apply, train=False))(
        params, *(jnp.asarray(b[k]) for k in ARGS))
    with torch.no_grad():
        emb, kl = tm.encode_cond(torch.as_tensor(b["conds"]), torch.as_tensor(b["num_faces"]))
        out = tm(*(torch.as_tensor(b[k]) for k in ARGS))
    assert emb.shape == (B, 5 + nf_cond, 64) and kl.item() == 0.0
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), **TOL)
    for k in ("loss", "loss_ce"):
        np.testing.assert_allclose(out[k].item(), float(jout[k]), **TOL)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]), **TOL)
    assert "loss_kl" not in out


def _jax_grads(jm, params, b):
    def loss_fn(p):
        return jm.apply(p, *(jnp.asarray(b[k]) for k in ARGS), train=False)["loss"]

    return state_dict_from_flax(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params)))


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "trained"])
def test_gradients_match_jax(freeze):
    """One step's gradients of every parameter against jax.grad. Frozen, the
    tower takes no gradient (JAX's stop_gradient gives it zeros) and stays
    out of the optimizer; trained, its gradients match JAX's too."""
    jm, params, tm = _pair(True, freeze=freeze)
    b = _batch(6)
    out = tm(*(torch.as_tensor(b[k]) for k in ARGS))
    named = dict(tm.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(out["loss"], list(named.values()),
                                                allow_unused=True)))
    want = _jax_grads(jm, params, b)
    tower = [n for n in named if n.startswith("image_encoder.")]
    assert len(tower) > 20 and len(grads) - len(tower) > 30
    for n, g in grads.items():
        if freeze and n in tower:
            assert g is None, n
            assert not np.any(want[n]), n
            continue
        np.testing.assert_allclose(g.numpy(), want[n], **TOL, err_msg=n)
    opt = TOptions(**_kw(True, freeze_encoder=freeze, lr=1e-3, warmup_ratio=0.0))
    trainer = Trainer(tm, opt, total_steps=10)
    assert (not any(n.startswith("image_encoder.") for n in trainer.params)) == freeze
    assert all(named[n].requires_grad != freeze for n in tower)


@pytest.mark.parametrize("num_faces", [20, 30])
def test_greedy_tokens_equal_jax_generate(num_faces, monkeypatch):
    """The same images give identical greedy streams through both packages'
    generate_tokens, across decode segments."""
    monkeypatch.setattr(JG, "DECODE_CHUNK", 64)
    monkeypatch.setattr(TG, "DECODE_CHUNK", 64)
    # widened weights, so that the images steer the streams
    jm, params, tm = _pair(True, scale=4.0)
    imgs = _images(num_faces, n=3)
    ref = JG.generate_tokens(jm, params, imgs, num_faces=num_faces)
    out = TG.generate_tokens(tm, imgs, num_faces=num_faces)
    assert out.shape == ref.shape and out.shape[1] > 64
    np.testing.assert_array_equal(out, ref)
    assert len({tuple(r) for r in out.tolist()}) > 1, "rows should differ"


def test_weights_round_trip_with_the_tower(pair):
    _, _, params, tm = pair
    sd = state_dict_from_flax(params)
    assert sum(k.startswith("image_encoder.vision_model.") for k in sd) > 20
    assert sd.keys() == set(tm.state_dict())
    back = state_dict_from_flax(flax_from_state_dict(sd))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    flat = jax.tree_util.tree_flatten_with_path(flax_from_state_dict(sd)["params"])[0]
    ref = dict(jax.tree_util.tree_flatten_with_path(params["params"])[0])
    assert len(flat) == len(ref)
    for path, leaf in flat:
        np.testing.assert_array_equal(leaf, ref[path])


def test_init_weights_draws_the_tower_at_flax_scales():
    opt = TOptions(**_kw(False, clip_hidden_dim=256, clip_intermediate_dim=512))
    sd = init_weights(LMM(opt), seed=0).state_dict()
    fc1 = sd["image_encoder.vision_model.encoder.layers.0.mlp.fc1.weight"]
    assert abs(fc1.std().item() - 256 ** -0.5) < 0.005
    pos = sd["image_encoder.vision_model.embeddings.position_embedding.weight"]
    assert abs(sd["image_encoder.vision_model.embeddings.class_embedding"].std().item()
               - 0.02) < 0.005 and abs(pos.std().item() - 0.02) < 0.005
    assert abs(sd["proj_cond.weight"].std().item() - 0.02) < 0.002
    again = init_weights(LMM(opt), seed=0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_resume2_overlays_a_huggingface_tower_and_nothing_else(tmp_path):
    """A random tower written in HuggingFace CLIPVisionModel's naming (with
    the entries the tower never reads, and one more that nothing has) lands
    exactly on `image_encoder.*`; every other weight keeps its value; the
    log names the unexpected entry and the decoder's missing ones."""
    opt = TOptions(**_kw(True))
    model = init_weights(LMM(opt), seed=1)
    before = reference_state_dict(model)
    r = np.random.default_rng(2)
    tower = {k[len("image_encoder."):]: r.normal(size=v.shape).astype(np.float32)
             for k, v in before.items() if k.startswith("image_encoder.")}
    extra = {HF_UNUSED[0]: np.ones(32, np.float32), HF_UNUSED[1]: np.zeros(32, np.float32),
             HF_UNUSED[2]: np.arange(5, dtype=np.int64)[None], "logit_scale": np.ones(1, np.float32)}
    path = str(tmp_path / "clip.safetensors")
    write_safetensors(path, {**tower, **extra})
    lines = []
    overlay_checkpoint(model, path, log=lines.append)
    after = reference_state_dict(model)
    for k, v in after.items():
        want = tower[k[len("image_encoder."):]] if k.startswith("image_encoder.") else before[k]
        np.testing.assert_array_equal(v, want, err_msg=k)
    assert any("unexpected param logit_scale" in m for m in lines)
    assert not any("post_layernorm" in m or "position_ids" in m for m in lines)
    missing = [m for m in lines if "missing param" in m]
    assert len(missing) == sum(not k.startswith("image_encoder.") for k in before)

"""The port's point_latent ArAE and its image-to-mesh CLI on the CPU.

The point_latent condition and greedy decoding from given latents against
the JAX package in f32 (the same weights through `state_dict_from_flax`,
the same numpy latents): the condition within atol/rtol 1e-5, the token
streams identical. Then `python -m edgerunner_tpu_torch.infer_dit` end to end
at a tiny width, the loading rules of `--resume` and `--resume2`, and what
`validate` and `main` accept.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edgerunner_tpu.generate as JG
import edgerunner_tpu_torch.generate as TG
from edgerunner_tpu.config import Options
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu_torch import infer_dit
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.config import config_defaults, parse_cli, validate
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.weights import load_state, state_dict_from_flax, write_safetensors
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, L, D = 3, 16, 8
BASE = dict(cond_mode="point_latent", point_latent_size=L, num_cond_tokens=L + 1,
            point_hidden_dim=32, point_num_heads=4, point_latent_dim=D,
            hidden_dim=64, num_layers=2, num_heads=2, max_seq_length=512,
            use_num_face_cond=True, checkpointing=False, decode_bucket=64,
            generate_mode="greedy", point_num=64)
TINY = ["--hidden_dim", "64", "--num_layers", "2", "--num_heads", "2",
        "--point_hidden_dim", "32", "--point_num_heads", "4", "--point_latent_size", "16",
        "--point_latent_dim", "8", "--num_cond_tokens", "17", "--point_num", "64",
        "--dit_hidden_dim", "32", "--dit_num_heads", "4", "--dit_num_layers", "2",
        "--clip_image_size", "32", "--clip_patch_size", "8", "--clip_hidden_dim", "32",
        "--clip_num_heads", "4", "--clip_num_layers", "2", "--clip_intermediate_dim", "64",
        "--max_seq_length", "256", "--decode_bucket", "64", "--generate_mode", "greedy",
        "--test_num_face", "20", "--test_repeat", "2", "--test_batch_size", "2"]


@pytest.fixture(scope="module")
def pair():
    jm = JLMM(Options(**BASE))
    rng = jax.random.PRNGKey(1)
    tokens = jnp.array([[1, 6, 7, 8, 2]])
    labels = jnp.concatenate([jnp.full((1, L + 2), -100), tokens[:, 1:]], axis=1)
    params = jm.init({"params": rng, "nof": rng, "dropout": rng}, jnp.zeros((1, L, D)),
                     tokens, labels, jnp.array([100]), jnp.array([L + 7], jnp.int32))
    # widen the random weights so that the latents steer the streams
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0, params)
    tm = LMM(TOptions(**BASE))
    load_state(tm, state_dict_from_flax(params))
    return jm, params, tm.eval()


def _latents(seed=0):
    return np.random.default_rng(seed).normal(size=(B, L, D)).astype(np.float32)


def test_point_latent_encode_cond_matches_jax(pair):
    jm, params, tm = pair
    assert not hasattr(tm, "point_encoder")
    lat, nf = _latents(), np.array([10, 1500, -1])
    want, _ = jm.apply(params, jnp.asarray(lat), jnp.asarray(nf), method=JLMM.encode_cond)
    with torch.no_grad():
        got, kl = tm.encode_cond(torch.tensor(lat), torch.tensor(nf))
    assert got.shape == (B, L + 1, 64) and kl.item() == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("num_faces", [12, 25])
def test_greedy_tokens_from_latents_identical_to_jax(pair, num_faces):
    jm, params, tm = pair
    lat = _latents(num_faces)
    ref = JG.generate_tokens(jm, params, lat, num_faces=num_faces)
    out = TG.generate_tokens(tm, lat, num_faces=num_faces)
    np.testing.assert_array_equal(out, ref)
    assert len({tuple(r) for r in out.tolist()}) > 1, "rows should differ"


def _image(path):
    from PIL import Image

    img = np.full((64, 64, 3), 255, np.uint8)
    img[16:48, 20:44] = (200, 40, 40)
    Image.fromarray(img).save(path)


def test_infer_dit_cli_writes_meshes(tmp_path):
    img = str(tmp_path / "chair.png")
    _image(img)
    ws = str(tmp_path / "out")
    infer_dit.main(["ArAE", "--device", "cpu", "--test_path", img, "--workspace", ws, *TINY])
    assert sorted(os.listdir(ws)) == ["chair_0_20f.obj", "chair_0_20f_tokens.npy",
                                      "chair_1_20f.obj", "chair_1_20f_tokens.npy"]
    tokens = np.load(os.path.join(ws, "chair_0_20f_tokens.npy"))
    assert tokens.size > 0 and tokens.min() >= 0


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "rgb_keep_bg"])
def test_image_io_matches_jax(tmp_path, kind):
    """load_image_cond (background removal, recentring, white background,
    resize), the foreground mask and the point render: the same arrays as
    the JAX package's, to the bit (the same numpy, scipy and PIL calls)."""
    from PIL import Image

    from edgerunner_tpu.data import image_io as JI
    from edgerunner_tpu.data import matting as JM
    from edgerunner_tpu_torch.data import image_io as TI
    from edgerunner_tpu_torch.data import matting as TM

    rng = np.random.default_rng(len(kind))
    rgb = np.full((80, 96, 3), 240, np.uint8) + rng.integers(0, 10, (80, 96, 3), np.uint8)
    rgb[20:70, 30:60] = (40, 120, 200)
    arr = {"rgb": rgb, "rgb_keep_bg": rgb, "gray": rgb[..., 0],
           "rgba": np.concatenate([rgb, np.where(rgb[..., :1] < 100, 255, 0).astype(np.uint8)],
                                  axis=-1)}[kind]
    path = str(tmp_path / f"{kind}.png")
    Image.fromarray(arr).save(path)
    remove_bg = kind != "rgb_keep_bg"
    want = JI.load_image_cond(path, size=64, remove_bg=remove_bg)
    got = TI.load_image_cond(path, size=64, remove_bg=remove_bg)
    assert got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, want)
    img = rgb.astype(np.float32) / 255
    np.testing.assert_array_equal(TM.classical_foreground(img), JM.classical_foreground(img))
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    np.testing.assert_array_equal(TI.render_points_image(pts, 48),
                                  JI.render_points_image(pts, 48))


def test_resume_drops_the_point_encoder_and_nothing_else(tmp_path, capsys):
    """An ArAE checkpoint trained in 'point' mode loads into the point_latent
    LMM without its point encoder, whose entries are dropped unlogged; any
    other stray or missing entry is merged as the JAX package merges it
    (tolerant_merge): logged, the stray one ignored, the missing one kept
    from the seed."""
    from edgerunner_tpu_torch.models.lmm import init_weights

    point_opt = parse_cli(["ArAE", *TINY])
    arae = LMM(point_opt)
    state = {k: v.detach().numpy() for k, v in arae.state_dict().items()}
    assert any(k.startswith("point_encoder.") for k in state)
    ckpt = str(tmp_path / "arae.safetensors")
    write_safetensors(ckpt, state)
    opt = validate(dataclasses.replace(point_opt, cond_mode="point_latent", resume=ckpt))
    model, _ = infer_dit.load_models(opt, torch.device("cpu"))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    assert "[ckpt]" not in capsys.readouterr().out
    seeded = init_weights(LMM(opt), opt.seed).state_dict()
    for bad, line in (({**state, "mesh_decoder.extra.weight": np.zeros(3, np.float32)},
                       "[ckpt] unexpected param mesh_decoder.extra.weight"),
                      ({k: v for k, v in state.items() if k != "proj_cond.bias"},
                       "[ckpt] missing param proj_cond.bias: keeping init")):
        write_safetensors(ckpt, bad)
        model, _ = infer_dit.load_models(opt, torch.device("cpu"))
        log = capsys.readouterr().out
        assert line in log and log.count("[ckpt]") == 1
        for k, v in model.state_dict().items():
            want = seeded[k].numpy() if k not in bad else state[k]
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)


def test_resume2_loads_an_mdit_strictly(tmp_path):
    from edgerunner_tpu_torch.models.mdit import MDiT
    from edgerunner_tpu_torch.weights import init_mdit_weights, load_mdit

    opt = parse_cli(["ArAE", *TINY])
    src = init_mdit_weights(MDiT(opt), seed=3)
    state = {k: v.numpy() for k, v in src.state_dict().items()}
    ckpt = str(tmp_path / "dit.safetensors")
    write_safetensors(ckpt, state)
    opt = dataclasses.replace(opt, resume2=ckpt)
    got = load_mdit(MDiT(opt), opt).state_dict()
    assert all(np.array_equal(got[k].numpy(), state[k]) for k in state)
    write_safetensors(ckpt, {k: v for k, v in state.items() if not k.startswith("dit.layers.1")})
    with pytest.raises(RuntimeError):
        load_mdit(MDiT(opt), opt)


def test_validate_accepts_point_latent_and_main_accepts_resume2_and_refuses_latents(tmp_path):
    """main refuses cond_mode 'point_latent'. `--resume2`, refused by main
    until the image-conditioned ArAE was ported, is now main's overlay of a
    second file: main reads it (a file that is not there raises)."""
    from edgerunner_tpu_torch import main

    validate(dataclasses.replace(config_defaults["ArAE"], cond_mode="point_latent"))
    validate(dataclasses.replace(config_defaults["DiT"], cond_mode="point_latent",
                                 resume2="dit.safetensors"))
    assert config_defaults["DiT"].dit_num_layers == 24
    with pytest.raises(ValueError, match="num_cond_tokens"):
        validate(dataclasses.replace(config_defaults["ArAE"], cond_mode="point_latent",
                                     num_cond_tokens=257))
    validate(dataclasses.replace(config_defaults["ArAE"], resume2="dit.safetensors"))
    # the ArAE preset's 2049 condition tokens are not CLIP's 257
    with pytest.raises(ValueError, match="num_cond_tokens"):
        validate(dataclasses.replace(config_defaults["ArAE"], cond_mode="image"))
    argv = ["ArAE", "--device", "cpu", "--data_root", "/nonexistent", "--workspace",
            str(tmp_path / "ws")]
    absent = str(tmp_path / "absent.safetensors")
    with pytest.raises(FileNotFoundError, match="absent.safetensors"):
        main.main([*argv, *TINY, "--resume2", absent])
    with pytest.raises(ValueError, match="point_latent"):
        main.main([*argv, "--cond_mode", "point_latent"])


def test_infer_dit_without_a_card_or_device_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer_dit.main(["ArAE", "--test_path", "img.png"])

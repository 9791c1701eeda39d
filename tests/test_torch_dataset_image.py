"""The image branches of the port's ArAE datasets (cond_mode 'image')
against the JAX package's: host numpy code with the same draws in the same
order, so one seed, epoch and index must give bit-equal samples and
batches, for a folder of meshes with render views beside them (RGBA views,
an RGB view whose background is removed) and without (a point-splat render
of the turned mesh), in training and in eval, and for synthetic meshes."""

import os

import numpy as np
import pytest

from edgerunner_tpu.config import Options
from edgerunner_tpu.data import dataset as jd
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.data import dataset as td
from edgerunner_tpu_torch.data import save_mesh_file
from edgerunner_tpu_torch.data._procgen import icosphere
from edgerunner_tpu_torch.utils import get_tokenizer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(cond_mode="image", clip_image_size=48, num_cond_tokens=10, point_num=256,
          testset_size=2, num_workers=2, seed=3, synthetic_size=6, max_seq_length=4096)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _png(path, rgba: bool, seed: int):
    """A 64 x 48 image: a dark ellipse on white, with alpha marking it."""
    from PIL import Image

    yy, xx = np.mgrid[:48, :64]
    inside = ((xx - 30) / 20.0) ** 2 + ((yy - 26) / 14.0) ** 2 < 1
    img = np.full((48, 64, 4), 255, np.uint8)
    img[inside, :3] = np.random.default_rng(seed).integers(0, 120, (int(inside.sum()), 3))
    img[..., 3] = np.where(inside, 255, 0)
    Image.fromarray(img if rgba else img[..., :3]).save(path)


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    """Five meshes: one with RGBA views at 0, 90 and 200 degrees, one with an
    RGB 0-degree view, three without renders."""
    root = tmp_path_factory.mktemp("image_meshes")
    v, f = icosphere(2)
    meshes = {"a_views.obj": v * [1.0, 0.7, 0.5], "b_rgb.obj": v,
              "c_plain.obj": v * [0.5, 1.0, 1.0], "d_plain.obj": v * [1.0, 0.5, 0.8],
              "e_plain.obj": v * [0.6, 0.6, 1.0]}
    for name, verts in meshes.items():
        save_mesh_file(str(root / name), np.asarray(verts, np.float32), np.asarray(f))
    for i, deg in enumerate(("", "_90", "_200")):
        _png(str(root / f"a_views{deg}.png"), rgba=True, seed=i)
    _png(str(root / "b_rgb.png"), rgba=False, seed=3)
    return root


@pytest.fixture(scope="module")
def tokenizers():
    from edgerunner_tpu.utils import get_tokenizer as j_get_tokenizer

    return j_get_tokenizer(Options(**KW))[0], get_tokenizer(TOptions(**KW))[0]


@pytest.mark.parametrize("training", [True, False])
def test_folder_items_are_bit_equal(mesh_dir, tokenizers, training):
    """Every mesh of the folder, with its render views and without, in
    training (view and azimuth drawn, decimation on) and in eval (view 0)."""
    jt, tt = tokenizers
    kw = dict(KW, data_root=str(mesh_dir))
    jds = jd.MeshFolderDataset(Options(**kw), training=training, tokenizer=jt)
    tds = td.MeshFolderDataset(TOptions(**kw), training=training, tokenizer=tt)
    items = sorted(str(mesh_dir / n) for n in os.listdir(mesh_dir) if n.endswith(".obj"))
    jds.items, tds.items = list(items), list(items)
    azimuths = set()
    for epoch in (0, 1, 2):
        jds.epoch = tds.epoch = epoch
        for i, path in enumerate(items):
            got = tds[i]
            _same(got, jds[i])
            assert got["path"] == path and got["cond"].shape == (48, 48, 3)
            assert got["cond"].dtype == np.float32
            azimuths.add((i, got["azimuth"]))
    if training:  # the views' azimuths and the drawn ones
        assert {a for i, a in azimuths if i == 0} <= {0.0, 90.0, 200.0}
        assert len({a for i, a in azimuths if i > 1}) > 1
    else:
        assert {a for _, a in azimuths} == {0.0}


@pytest.mark.parametrize("training", [True, False])
def test_synthetic_items_are_bit_equal(tokenizers, training):
    jt, tt = tokenizers
    jds = jd.SyntheticMeshDataset(Options(**KW), size=4, training=training, tokenizer=jt)
    tds = td.SyntheticMeshDataset(TOptions(**KW), size=4, training=training, tokenizer=tt)
    for epoch in (0, 1):
        jds.epoch = tds.epoch = epoch
        for i in range(4):
            got = tds[i]
            assert got["cond"].shape == (48, 48, 3)
            _same(got, jds[i])


def test_collate_stacks_images_as_the_jax_package_does(tokenizers):
    jt, tt = tokenizers
    jopt, topt = Options(**KW), TOptions(**KW)
    jl = jd.DataLoader(jd.SyntheticMeshDataset(jopt, size=6, tokenizer=jt), jopt, 2,
                       shuffle=True, seed=3)
    tl = td.DataLoader(td.SyntheticMeshDataset(topt, size=6, tokenizer=tt), topt, 2,
                       shuffle=True, seed=3)
    batches = list(zip(tl, jl, strict=True))
    assert len(batches) == 3
    for got, want in batches:
        assert got["conds"].shape == (2, 48, 48, 3) and got["conds"].dtype == np.float32
        _same(got, want)

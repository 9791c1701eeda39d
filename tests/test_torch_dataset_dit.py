"""The port's DiT dataset and collate against the JAX package's: host numpy
code with the same draws in the same order, so one seed must give bit-equal
images, points and batches, for synthetic meshes and for a folder of meshes
with render views beside them (RGBA views, an RGB view whose background is
removed, and no view), in training and in eval."""

import os

import numpy as np
import pytest

from edgerunner_tpu.config import Options
from edgerunner_tpu.data import dataset_dit as jd
from edgerunner_tpu.data.image_io import find_render_views as j_find_render_views
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.data import dataset_dit as td
from edgerunner_tpu_torch.data import save_mesh_file
from edgerunner_tpu_torch.data._procgen import icosphere
from edgerunner_tpu_torch.data.dataset import DataLoader, _box_mesh
from edgerunner_tpu_torch.data.image_io import find_render_views
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(cond_mode="point", point_num=128, num_cond_tokens=17, point_latent_size=16,
          testset_size=2, num_workers=2, seed=5, synthetic_size=6)


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
    """Four meshes: one with RGBA views at 0, 90 and 200 degrees (and files
    that are not views), one with an RGB 0-degree view and a .jpg at 30
    degrees, two without renders."""
    root = tmp_path_factory.mktemp("dit_meshes")
    v, f = icosphere(2)
    meshes = {"views.obj": (v * [1.0, 0.7, 0.5], f), "rgb.obj": (v, f),
              "plain.obj": _box_mesh(), "plain2.obj": (v * [0.5, 1.0, 1.0], f)}
    for name, (v, f) in meshes.items():
        save_mesh_file(str(root / name), np.asarray(v, np.float32), np.asarray(f))
    for i, deg in enumerate(("", "_90", "_200")):
        _png(str(root / f"views{deg}.png"), rgba=True, seed=i)
    _png(str(root / "views_front.png"), rgba=True, seed=9)   # not a view
    _png(str(root / "views_90x.png"), rgba=True, seed=9)     # not a view
    _png(str(root / "rgb.png"), rgba=False, seed=3)
    _png(str(root / "rgb_30.jpg"), rgba=False, seed=4)
    return root


def test_find_render_views_matches_jax(mesh_dir):
    for stem in ("views", "rgb", "plain", "missing"):
        path = str(mesh_dir / f"{stem}.obj")
        assert find_render_views(path) == j_find_render_views(path)
    views = find_render_views(str(mesh_dir / "views.obj"))
    assert [deg for deg, _ in views] == [0.0, 90.0, 200.0]
    assert [deg for deg, _ in find_render_views(str(mesh_dir / "rgb.obj"))] == [0.0, 30.0]


@pytest.mark.parametrize("training", [True, False])
def test_synthetic_items_are_bit_equal(training):
    jds = jd.DiTMeshDataset(Options(**KW), training=training)
    tds = td.DiTMeshDataset(TOptions(**KW), training=training)
    assert len(jds) == len(tds) == (6 if training else 4)
    for epoch in (0, 1):
        jds.epoch = tds.epoch = epoch
        for i in range(len(tds)):
            got = tds[i]
            assert got["image"].shape == (224, 224, 3) and got["points"].shape == (128, 3)
            _same(got, jds[i])


@pytest.mark.parametrize("training", [True, False])
def test_folder_items_are_bit_equal(mesh_dir, training):
    kw = dict(KW, data_root=str(mesh_dir))
    jds = jd.DiTMeshDataset(Options(**kw), training=training, image_size=64)
    tds = td.DiTMeshDataset(TOptions(**kw), training=training, image_size=64)
    assert tds.items == jds.items and len(tds) == 2
    for epoch in (0, 1, 2):
        jds.epoch = tds.epoch = epoch
        for i in range(len(tds)):
            _same(tds[i], jds[i])
    # every mesh of the folder, with its views, in training and in eval: each
    # loads without a resample (a resample would return another path)
    items = sorted(str(mesh_dir / n) for n in os.listdir(mesh_dir) if n.endswith(".obj"))
    jds.items, tds.items = list(items), list(items)
    for i, path in enumerate(items):
        got = tds[i]
        _same(got, jds[i])
        assert got["path"] == path and got["image"].shape == (64, 64, 3)


def test_collate_and_loader_are_bit_equal():
    from edgerunner_tpu.data.dataset import DataLoader as JDataLoader

    jopt, topt = Options(**KW), TOptions(**KW)
    jl = JDataLoader(jd.DiTMeshDataset(jopt), jopt, 2, shuffle=True, seed=5,
                     collate_fn=jd.collate_dit)
    tl = DataLoader(td.DiTMeshDataset(topt), topt, 2, shuffle=True, seed=5,
                    collate_fn=td.collate_dit)
    for _ in range(2):  # two epochs
        batches = list(zip(tl, jl, strict=True))
        assert len(batches) == 3
        for got, want in batches:
            assert got["images"].shape == (2, 224, 224, 3)
            _same(got, want)

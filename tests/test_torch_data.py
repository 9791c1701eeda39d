"""The port's datasets, collate and loader against the JAX package's: host
numpy code with the same draws in the same order, so one seed must give
bit-equal samples and batches. Also the port's decimation wrapper against
the JAX package's (the same C++ source)."""

import json
import os

import numpy as np
import pytest

from edgerunner_tpu.config import Options
from edgerunner_tpu.data import dataset as jd
from edgerunner_tpu.tokenizer import Engine as JEngine
from edgerunner_tpu.tokenizer import decimate as j_decimate
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.data import dataset as td
from edgerunner_tpu_torch.data import save_mesh_file
from edgerunner_tpu_torch.data._procgen import icosphere
from edgerunner_tpu_torch.tokenizer import Engine as TEngine
from edgerunner_tpu_torch.tokenizer import decimate
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(cond_mode="point", point_num=64, max_seq_length=4096, num_cond_tokens=17,
          point_latent_size=16, collate_bucket=64, testset_size=2, num_workers=2, seed=3)


def _pair(**over):
    kw = dict(KW, **over)
    return (Options(**kw), JEngine(512, backend="LR_ABSCO"),
            TOptions(**kw), TEngine(512, backend="LR_ABSCO"))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    """Procedural meshes on disk: icospheres of 320 and 1280 faces (the
    decimation augmentation applies from 200 faces), a box and a fan."""
    root = tmp_path_factory.mktemp("meshes")
    rng = np.random.default_rng(0)
    meshes = {"sphere2.obj": icosphere(2), "sphere3.obj": icosphere(3),
              "box.obj": td._box_mesh(), "fan.obj": td._fan_mesh(rng, 12)}
    for i in range(4):
        v, f = icosphere(2)
        meshes[f"bumpy{i}.obj"] = (v + rng.normal(0, 0.03, v.shape), f)
    for name, (v, f) in meshes.items():
        save_mesh_file(str(root / name), np.asarray(v, np.float32), np.asarray(f))
    return root


def test_synthetic_samples_are_bit_equal():
    jopt, jtok, topt, ttok = _pair(synthetic_subdiv=3)
    for training in (True, False):
        jds = jd.SyntheticMeshDataset(jopt, size=6, training=training, tokenizer=jtok)
        tds = td.SyntheticMeshDataset(topt, size=6, training=training, tokenizer=ttok)
        for epoch in (0, 2):
            jds.epoch = tds.epoch = epoch
            for i in range(6):
                _same(jds[i], tds[i])


@pytest.mark.parametrize("manifest", [False, True])
def test_mesh_folder_samples_are_bit_equal(mesh_dir, tmp_path, manifest):
    root = str(mesh_dir)
    if manifest:
        # a manifest at the root lists the items (and drops the box by its face count)
        root = str(tmp_path)
        items = {os.path.join(str(mesh_dir), n): (5000 if n == "box.obj" else 100)
                 for n in sorted(os.listdir(mesh_dir))}
        with open(os.path.join(root, "manifest.json"), "w") as f:
            json.dump(items, f)
    jopt, jtok, topt, ttok = _pair(data_root=root, max_face_length=4000)
    for training in (True, False):
        jds = jd.MeshFolderDataset(jopt, training=training, tokenizer=jtok)
        tds = td.MeshFolderDataset(topt, training=training, tokenizer=ttok)
        assert jds.items == tds.items and len(tds) > 0
        for epoch in (0, 1):
            jds.epoch = tds.epoch = epoch
            samples = [tds[i] for i in range(len(tds))]
            for i, sample in enumerate(samples):
                _same(jds[i], sample)
        if training:  # the decimation augmentation ran on some of them
            assert {s["num_faces"] for s in samples} - {12, 320, 1280}


def test_collate_and_loader_order_and_resume_are_bit_equal():
    jopt, jtok, topt, ttok = _pair()
    jds = jd.SyntheticMeshDataset(jopt, size=10, tokenizer=jtok)
    tds = td.SyntheticMeshDataset(topt, size=10, tokenizer=ttok)
    jl = jd.DataLoader(jds, jopt, 3, seed=5)
    tl = td.DataLoader(tds, topt, 3, seed=5)
    try:
        for _ in range(2):  # two epochs: the order changes with the epoch
            jb, tb = list(jl), list(tl)
            assert len(tb) == len(tl) == 3
            for a, b in zip(jb, tb):
                _same(a, b)
        assert jl.state() == tl.state() == {"epoch": 2, "batch_in_epoch": 0}

        # stop after one batch of epoch 2, resume a fresh loader from its state
        it = iter(tl)
        first = next(it)
        state = tl.state()
        assert state == {"epoch": 2, "batch_in_epoch": 1}
        it.close()
        resumed = td.DataLoader(tds, topt, 3, seed=5)
        resumed.restore_state(state)
        rest = list(resumed)
        full = list(jl)
        _same(full[0], first)
        assert len(rest) == 2
        for a, b in zip(full[1:], rest):
            _same(a, b)
        # the eval loader keeps its partial last batch
        assert len(td.DataLoader(tds, topt, 3, shuffle=False, drop_last=False)) == 4
    finally:
        jl.shutdown()


def test_decimate_matches_the_jax_wrapper():
    v, f = icosphere(3)
    v = v + np.random.default_rng(1).normal(0, 0.02, v.shape)
    for target in (300, 1000):
        got, want = decimate(v, f, target), j_decimate(v, f, target)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert len(got[1]) <= target
    for fn in (td.decimate_qem, td.decimate_vertex_cluster):
        jfn = getattr(jd, fn.__name__)
        for a, b in zip(fn(v, f, 400), jfn(v, f, 400)):
            assert np.array_equal(a, b)

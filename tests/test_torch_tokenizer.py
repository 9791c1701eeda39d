"""The port's copy of the metok codec against the golden token streams of
the reference engines (tests/golden/*.json): exact tokens and geometry."""

import glob
import json
import os

import numpy as np
import pytest

from edgerunner_tpu_torch.tokenizer import Engine

GOLDEN_FILES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden", "*.json")))
BACKENDS = {"LR_ABSCO": "lr_absco", "LR": "lr", "CLERS": "clers"}


@pytest.fixture(scope="module")
def goldens():
    out = []
    for path in GOLDEN_FILES:
        with open(path) as f:
            out.append((os.path.basename(path), json.load(f)))
    return out


def test_the_code_is_a_copy_of_the_jax_package_s():
    """Every line but the comments is the JAX package's metok.cpp."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def code(*parts):
        with open(os.path.join(here, *parts, "tokenizer", "src", "metok.cpp")) as f:
            return [ln for ln in f if not ln.lstrip().startswith("//")]

    assert code("edgerunner_tpu") == code("edgerunner_tpu_torch")


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_golden_encode_parity(goldens, backend):
    key = BACKENDS[backend]
    assert len(goldens) > 10
    for name, g in goldens:
        eng = Engine(discrete_bins=g["bins"], backend=backend)
        tokens, face_order, face_type = eng.encode(np.array(g["verts"], np.float32),
                                                   np.array(g["faces"], np.int64))
        assert tokens.tolist() == g[f"{key}_tokens"], name
        assert face_order.tolist() == g[f"{key}_face_order"], name
        assert face_type.tolist() == g[f"{key}_face_type"], name


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_golden_decode_parity(goldens, backend):
    key = BACKENDS[backend]
    for name, g in goldens:
        eng = Engine(discrete_bins=g["bins"], backend=backend)
        verts, faces, face_type = eng.decode(np.array(g[f"{key}_tokens"], np.int64))
        np.testing.assert_array_equal(
            verts, np.array(g[f"{key}_dec_verts"], np.float32).reshape(-1, 3), err_msg=name)
        np.testing.assert_array_equal(
            faces, np.array(g[f"{key}_dec_faces"], np.int64).reshape(-1, 3), err_msg=name)
        assert face_type.tolist() == g[f"{key}_dec_face_type"], name


def test_bad_shapes_are_refused():
    with pytest.raises(ValueError):
        Engine(512).encode(np.zeros((3, 2), np.float32), np.zeros((1, 3), np.int64))
    with pytest.raises(ValueError):
        Engine(512, backend="XYZ")

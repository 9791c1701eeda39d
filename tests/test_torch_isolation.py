"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points run on the card unless asked for the CPU."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "edgerunner_tpu")


def _port_files():
    files = sorted(glob.glob(os.path.join(ROOT, "edgerunner_tpu_torch", "**", "*.py"),
                             recursive=True))
    return files + [os.path.join(ROOT, "chip_smoke.py")]


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15 and os.path.exists(files[-1])
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imported_roots(p)
           if m in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import edgerunner_tpu_torch.infer, edgerunner_tpu_torch.generate, "
            "edgerunner_tpu_torch.weights, edgerunner_tpu_torch.ops.decode_attention; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_infer_without_a_card_or_device_cpu_raises():
    from edgerunner_tpu_torch import infer

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer.main(["ArAE", "--test_path", "mesh.obj"])
    with pytest.raises(RuntimeError):
        infer.resolve_device("cuda")
    assert infer.resolve_device("cpu").type == "cpu"


def test_validate_refuses_options_the_port_does_not_run():
    from edgerunner_tpu_torch.config import config_defaults, validate

    import dataclasses

    for change in (dict(kv_quant=True), dict(spec_decode=True), dict(cond_mode="image"),
                   dict(point_encoder_mode="downsample"), dict(num_cond_tokens=7)):
        with pytest.raises(ValueError):
            validate(dataclasses.replace(config_defaults["ArAE"], **change))
    validate(dataclasses.replace(config_defaults["ArAE"]))

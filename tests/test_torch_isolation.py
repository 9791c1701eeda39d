"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points run on the card unless asked for the CPU."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "edgerunner_tpu")


def _port_files():
    """The port's package, its scripts under tools/ (tools/torch_*.py) and
    chip_smoke.py, last."""
    files = sorted(glob.glob(os.path.join(ROOT, "edgerunner_tpu_torch", "**", "*.py"),
                             recursive=True))
    files += sorted(glob.glob(os.path.join(ROOT, "tools", "torch_*.py")))
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
            "edgerunner_tpu_torch.weights, edgerunner_tpu_torch.ops.decode_attention, "
            "edgerunner_tpu_torch.main, edgerunner_tpu_torch.serve, "
            "edgerunner_tpu_torch.serve_engine, edgerunner_tpu_torch.ops.w_quant; "
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

    # what the JAX package asserts against (kv_quant.py:145-148): more than 64
    # group scales (1536 / 12 = 128), a group that does not divide hidden
    for change in (dict(kv_quant=True, kv_bits=4, kv_group=12),
                   dict(kv_quant=True, kv_bits=4, kv_group=100),
                   dict(kv_quant=True, kv_bits=3), dict(cond_mode="image"),
                   dict(num_cond_tokens=7)):
        with pytest.raises(ValueError):
            validate(dataclasses.replace(config_defaults["ArAE"], **change))
    validate(dataclasses.replace(config_defaults["ArAE"]))
    # the FPS point encoder is ported
    validate(dataclasses.replace(config_defaults["ArAE"], point_encoder_mode="downsample"))
    # the int8 and int4 KV caches (grouped, rotated), int8 weights, the draft
    # heads and speculative decoding are ported; spec_decode outside greedy
    # mode warns and decodes vanilla, as in the JAX package
    for ok in (dict(kv_quant=True), dict(w_quant=True), dict(kv_quant=True, w_quant=True),
               dict(kv_quant=True, kv_bits=4), dict(kv_quant=True, kv_rotate=True),
               dict(kv_quant=True, kv_bits=4, kv_group=96), dict(mtp_heads=2),
               dict(spec_decode=True), dict(mtp_heads=2, spec_decode=True,
                                            generate_mode="sample")):
        validate(dataclasses.replace(config_defaults["ArAE"], **ok))


def test_validate_accepts_dp_size_and_refuses_the_training_options_not_ported_yet():
    from edgerunner_tpu_torch.config import config_defaults, validate

    import dataclasses

    # the JAX package's asserts (config.py:428-452, trainer.py:125-145) are
    # ValueErrors: sp with tp or pp, layers or a batch that do not divide
    # into the stages or microbatches
    for change in (dict(dp_size=0), dict(dp_size=-2), dict(tp_size=0), dict(pp_size=0),
                   dict(sp_size=2, tp_size=2), dict(sp_size=2, pp_size=2),
                   dict(pp_size=5), dict(pp_size=2, batch_size=3),
                   dict(pp_size=2, pp_microbatches=4, batch_size=2),
                   dict(moe_experts=2, moe_top_k=3), dict(ep_size=2),
                   dict(moe_experts=3, ep_size=2), dict(lora_rank=8, w_quant=True),
                   dict(lora_rank=8, moe_experts=4), dict(lora_rank=-1)):
        with pytest.raises(ValueError):
            validate(dataclasses.replace(config_defaults["ArAE"], **change))
    # tp, pp with the stacked layout, MoE under sp and under dp x pp are
    # ported; pp sets scan_layers, as the JAX validate does (config.py:435)
    for ok in (dict(pp_size=2, moe_experts=4, dp_size=2),
               dict(tp_size=2), dict(tp_size=2, dp_size=2), dict(pp_size=2),
               dict(pp_size=2, pp_microbatches=2, batch_size=4), dict(pp_size=2, tp_size=2),
               dict(scan_layers=True), dict(moe_experts=4, sp_size=2),
               dict(moe_experts=4, sp_size=2, dp_size=2), dict(moe_experts=4, pp_size=2),
               dict(moe_experts=4, pp_size=2, ep_size=2, dp_size=1)):
        validate(dataclasses.replace(config_defaults["ArAE"], **ok))
    assert validate(dataclasses.replace(config_defaults["ArAE"], pp_size=2)).scan_layers
    # the weight EMA is ported: main and main_dit keep one; --resume2 is
    # ported: main and infer overlay it on the ArAE (a pretrained CLIP tower);
    # dp is ported: main and main_dit train under torchrun, infer and serve
    # decode on a fleet; the training extras are ported: the generate eval,
    # async checkpoints, wandb, remote roots and mixed local roots; the MoE
    # decoder, its expert parallelism and LoRA are ported
    for ok in (dict(moe_experts=4), dict(moe_experts=4, moe_top_k=1, moe_capacity_factor=0.5,
                                         moe_aux_weight=0.1),
               dict(moe_experts=4, ep_size=2), dict(moe_experts=4, ep_size=4, dp_size=2),
               dict(lora_rank=8), dict(lora_rank=8, lora_alpha=32.0),
               dict(moe_experts=4, w_quant=True), dict(dp_size=-1), dict(dp_size=1), dict(dp_size=2),
               dict(dp_size=2, sp_size=2), dict(data_root="./data"),
               dict(ema_decay=0.999), dict(resume2="clip.safetensors"),
               dict(eval_mode="generate"), dict(async_checkpointing=True),
               dict(use_wandb=True), dict(data_root="https://example.com/meshes"),
               dict(data_root="http://127.0.0.1:8000/set"),
               dict(data_root="s3://bucket/meshes"), dict(data_root="dir_a:dir_b"),
               dict(data_root="dir_a:dir_b", dataset="objxl")):
        validate(dataclasses.replace(config_defaults["ArAE"], **ok))


def test_validate_refuses_remat_policy_attn_and_accepts_prevent_cse():
    """The name is older than 'attn' in the port: 'attn' is now accepted
    (models/shape_opt.py keeps each layer's attention output), and a policy
    other than 'full' or 'attn', which the JAX package would silently train
    with full recompute, is refused; remat_prevent_cse is an XLA option that
    the port's recompute needs no counterpart of."""
    from edgerunner_tpu_torch.config import config_defaults, validate

    import dataclasses

    for bad in ("dots", "none", ""):
        with pytest.raises(ValueError, match="remat_policy"):
            validate(dataclasses.replace(config_defaults["ArAE"], remat_policy=bad))
    for ok in (dict(remat_policy="full"), dict(remat_policy="attn"),
               dict(remat_prevent_cse=True)):
        validate(dataclasses.replace(config_defaults["ArAE"], **ok))


def test_sp_modules_load_no_jax():
    """parallel/ and the ring are covered by the import scan above, and
    importing them loads no JAX."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("edgerunner_tpu_torch/parallel/__init__.py",
                "edgerunner_tpu_torch/parallel/mesh.py",
                "edgerunner_tpu_torch/parallel/collectives.py",
                "edgerunner_tpu_torch/ops/ring_attention.py"):
        assert rel in files, rel
    code = ("import sys; import edgerunner_tpu_torch.parallel, "
            "edgerunner_tpu_torch.ops.ring_attention, edgerunner_tpu_torch.train.trainer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_validate_accepts_sp_size_and_dp_size_and_refuses_tp_pp_and_dp_0():
    from edgerunner_tpu_torch.config import config_defaults, validate

    import dataclasses

    for ok in (dict(sp_size=1), dict(sp_size=2), dict(sp_size=4), dict(dp_size=2),
               dict(sp_size=2, dp_size=2)):
        validate(dataclasses.replace(config_defaults["ArAE"], **ok))
    for change in (dict(sp_size=0), dict(sp_size=2, pp_size=2), dict(dp_size=0),
                   dict(sp_size=2, tp_size=2), dict(sp_size=2, dp_size=0)):
        with pytest.raises(ValueError):
            validate(dataclasses.replace(config_defaults["ArAE"], **change))
    with pytest.raises(ValueError, match="--dp_size is -1"):
        validate(dataclasses.replace(config_defaults["ArAE"], dp_size=0))


def test_main_sp_size_outside_a_matching_world_raises(monkeypatch):
    """--sp_size N needs a torchrun world of dp × N ranks: it never trains
    unsharded, and a world of another size is refused too (--dp_size -1,
    the default, takes world / sp, so the refused worlds here fix dp 1)."""
    from edgerunner_tpu_torch import main

    argv = ["ArAE", "--device", "cpu", "--data_root", "/nonexistent", "--workspace",
            "/nonexistent/ws"]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        main.main([*argv, "--sp_size", "2"])
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="this world has 4"):
        main.main([*argv, "--sp_size", "2", "--dp_size", "1"])
    with pytest.raises(RuntimeError, match="this world has 4"):
        main.main([*argv, "--dp_size", "1"])


def test_image_pipeline_modules_load_no_jax():
    """The image pipeline's modules are covered by the import scan above, and
    importing them loads no JAX (nor PIL, which only reading, resizing or
    writing an image file needs)."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    mods = ("diffusion.schedulers", "models.clip_vit", "models.dit", "models.mdit",
            "data.image_io", "data.matting", "infer_dit")
    for mod in mods:
        assert f"edgerunner_tpu_torch/{mod.replace('.', '/')}.py" in files, mod
    code = ("import sys; " + "; ".join(f"import edgerunner_tpu_torch.{m}" for m in mods)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('PIL',)!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_pipeline_server_without_a_card_or_device_cpu_raises():
    from edgerunner_tpu_torch import serve

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["ArAE", "--resume2", "dit.safetensors"])


def test_checkpoint_tools_load_no_jax():
    """The tools' modules and the trained-checkpoint script are covered by
    the import scan above, and importing the modules loads no JAX."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    mods = ("spec_stats", "bench_spec", "kv_quant_quality", "make_manifest",
            "visualize_traversal", "tool_common")
    for mod in mods:
        assert f"edgerunner_tpu_torch/{mod}.py" in files, mod
    assert "tools/torch_trained_tools.py" in files and "tools/torch_dp_cards.py" in files
    code = ("import sys; " + "; ".join(f"import edgerunner_tpu_torch.{m}" for m in mods)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

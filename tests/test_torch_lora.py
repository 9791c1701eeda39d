"""LoRA fine-tuning of the port against the JAX package, in f32 on the CPU
at the JAX LoRA tests' size (2 layers, hidden 64, 4 heads; rank 4,
tests/test_lora.py:29-37).

- Fresh adapters are a no-op on a dense checkpoint: merged in tolerantly
  (the adapters logged as missing), the logits equal the dense model's.
- Two training steps equal the JAX step's (its optax chain: clip by the
  global norm of every gradient, then AdamW masked to the adapters,
  train/state.py:112-141): the loss, the grad norm over all gradients (the
  base weights' included, trap of a norm over the adapters only), the
  adapters after each update; the base weights bit-unchanged. Clipping is
  active: the norm is far above gradient_clip.
- `merge_lora_state` and `python -m edgerunner_tpu_torch.merge_lora` equal
  `merge_lora_tree` of the same parameters, and the command warns when
  nothing is merged.
- The adapted model, the merged one and the JAX package's adapted model
  give the same greedy streams.
- `--w_quant` and `--moe_experts` with LoRA are refused.

Tolerance: atol 1e-5, rtol 1e-4 in f32, as tests/test_torch_train.py; the
merge to 1e-6 (one f32 product of rank 4 per weight).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import edgerunner_tpu.generate as JG
import edgerunner_tpu_torch.generate as TG
from edgerunner_tpu.config import Options
from edgerunner_tpu.models.layers import merge_lora_tree
from edgerunner_tpu.models.lmm import LMM as JLMM
from edgerunner_tpu.train import state as jstate
from edgerunner_tpu_torch import merge_lora
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.config import validate
from edgerunner_tpu_torch.models.layers import LoRALinear, merge_lora_state
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.weights import (
    flax_from_state_dict,
    load_state,
    merge_checkpoint,
    read_safetensors,
    reference_state_dict,
    state_dict_from_flax,
    write_safetensors,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=1e-5, rtol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_POINTS = 64
BASE = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
            point_hidden_dim=32, point_num_heads=4, point_latent_dim=8,
            hidden_dim=64, num_layers=2, num_heads=4, max_seq_length=256,
            use_num_face_cond=True, checkpointing=False, point_num=N_POINTS,
            nof_dropout_ratio=0.0, decode_bucket=64, generate_mode="greedy",
            lr=1e-3, warmup_ratio=0.0, gradient_clip=0.5, mixed_precision="no")
KW = dict(BASE, lora_rank=4, lora_alpha=8.0)
FIELDS = ("conds", "tokens", "labels", "num_faces", "lengths")
ADAPTED = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


def _batch(seed=0, B=4, L=20):
    r = np.random.default_rng(seed)
    C = KW["num_cond_tokens"]
    lens = [L - 3 * i for i in range(B)]
    tokens = np.zeros((B, L + 2), np.int32)
    labels = np.full((B, C + L + 2), -100, np.int32)
    for i, n in enumerate(lens):
        coords = r.integers(6, 300, n)
        tokens[i, :n + 2] = np.concatenate([[1], coords, [2]])
        labels[i, C + 1:C + n + 2] = np.concatenate([coords, [2]])
    return {"conds": r.normal(size=(B, N_POINTS, 3)).astype(np.float32),
            "tokens": tokens, "labels": labels,
            "num_faces": np.array([100, 3000, 500, 800][:B], np.int32),
            "lengths": np.array([C + n + 2 for n in lens], np.int32)}


@functools.lru_cache(maxsize=None)
def _params(lora: bool = True):
    """JAX params (numpy) of the LoRA LMM, widened fourfold so that the
    point clouds steer the streams, with random non-zero lora_b (zeros
    would leave lora_a without gradient and the adapters without effect);
    or of the dense LMM."""
    jm = JLMM(Options(**(KW if lora else BASE)))
    b = _batch()
    rng = jax.random.PRNGKey(0)
    params = jax.jit(jm.init)({"params": rng, "nof": rng, "dropout": rng},
                              *(jnp.asarray(b[k]) for k in FIELDS))
    params = jax.tree.map(lambda x: np.asarray(x) * 4.0, {"params": params["params"]})
    r = np.random.default_rng(5)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: ((r.normal(size=x.shape) * 0.1).astype(np.float32)
                      if getattr(p[-1], "key", None) == "lora_b" else x), params)


def _port(params, kw=KW):
    tm = LMM(TOptions(**kw))
    load_state(tm, state_dict_from_flax(params))
    for layer in tm.mesh_decoder.model.layers:
        layer.dropout = 0.0  # the JAX loss is taken with train=False
    return tm


def test_fresh_adapters_are_a_noop_on_a_dense_checkpoint():
    dense = _params(lora=False)
    base = _port(dense, BASE).eval()
    model = init_weights(LMM(TOptions(**KW)), seed=3)
    logs = []
    merge_checkpoint(model, state_dict_from_flax(dense), log=logs.append)
    missing = [ln for ln in logs if ln.startswith("[ckpt] missing param")]
    assert len(missing) == len(logs) == 2 * 2 * len(ADAPTED), logs
    assert all(ln.split()[3].rstrip(":").endswith((".lora_a", ".lora_b")) for ln in missing)
    layer = model.mesh_decoder.model.layers[1]
    assert isinstance(layer.fc1, LoRALinear) and not layer.fc1.lora_b.any()
    assert layer.fc1.lora_a.abs().max() > 0
    b = _batch(1)
    with torch.no_grad():
        got = model.eval()(*(torch.as_tensor(b[k]) for k in FIELDS))["logits"]
        want = base(*(torch.as_tensor(b[k]) for k in FIELDS))["logits"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _jax_steps(params, batches):
    """The JAX LoRA chain (not fused) over the batches: per step the loss,
    the global norm of every gradient and of the adapters' alone, and the
    params after the update."""
    jm = JLMM(Options(**KW))
    tx, _ = jstate.make_optimizer(Options(**KW), total_steps=10)
    state = tx.init(params)

    def loss_fn(p, b):
        return jm.apply(p, *(b[k] for k in FIELDS), train=False)["loss"]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    update = jax.jit(tx.update)
    out = []
    for b in batches:
        loss, grads = grad_fn(params, {k: jnp.asarray(v) for k, v in b.items()})
        adapters = [g for p, g in jax.tree_util.tree_leaves_with_path(grads)
                    if p[-1].key in ("lora_a", "lora_b")]
        upd, state = update(grads, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, upd))
        out.append((float(loss), float(optax.global_norm(grads)),
                    float(optax.global_norm(adapters)), params))
    return out


def test_two_lora_steps_match_the_jax_step():
    params = _params()
    batches = [_batch(1), _batch(2)]
    want = _jax_steps(params, batches)
    tm = _port(params)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    trainer = Trainer(tm.train(), TOptions(**KW), total_steps=10)
    trainer.init_state()
    adapters = {n for n in before if n.endswith((".lora_a", ".lora_b"))}
    assert set(trainer.optimizer.updated) == adapters == set(trainer.optimizer.mu)
    assert len(adapters) == 2 * 2 * len(ADAPTED)
    for b, (loss, gnorm, adapter_norm, jparams) in zip(batches, want):
        m = trainer.train_step(b)
        np.testing.assert_allclose(m["loss"], loss, **TOL)
        # the norm of every gradient, far from the adapters' own, and clipped
        np.testing.assert_allclose(m["grad_norm"], gnorm, **TOL)
        assert gnorm > 1.5 * adapter_norm and gnorm > 2 * KW["gradient_clip"]
        sd = state_dict_from_flax(jparams)
        for n in adapters:
            np.testing.assert_allclose(tm.state_dict()[n].numpy(), sd[n], **TOL, err_msg=n)
    for n, p in tm.named_parameters():
        if n in adapters:
            assert not torch.equal(p, before[n]), n
        else:
            torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0, msg=n)
            np.testing.assert_array_equal(before[n].numpy(),
                                          state_dict_from_flax(want[-1][3])[n], err_msg=n)


def test_merge_lora_state_and_the_command_equal_merge_lora_tree(tmp_path, capsys):
    params = _params()
    alpha = KW["lora_alpha"]
    want = state_dict_from_flax(jax.tree.map(np.asarray, merge_lora_tree(params, alpha)))
    lora = state_dict_from_flax(params)
    got = merge_lora_state(lora, alpha)
    assert set(got) == set(want) == set(reference_state_dict(_port(_params(False), BASE)))
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=1e-6, err_msg=n)
    src = str(tmp_path / "lora.safetensors")
    write_safetensors(src, lora)
    out = merge_lora.main(["--ckpt", src, "--out", str(tmp_path / "merged"),
                           "--lora_alpha", str(alpha)])
    assert "merged 12 adapters" in capsys.readouterr().out
    written = read_safetensors(out)
    for n in want:
        np.testing.assert_array_equal(written[n], got[n])
    # the command as users run it, on a file without adapters
    r = subprocess.run([sys.executable, "-m", "edgerunner_tpu_torch.merge_lora", "--ckpt", out,
                        "--out", str(tmp_path / "again.safetensors")], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "[WARN] no lora_a/lora_b leaves found" in r.stdout
    assert read_safetensors(str(tmp_path / "again.safetensors")).keys() == written.keys()


def test_adapted_and_merged_models_give_the_jax_greedy_stream():
    params = _params()
    pts = np.random.default_rng(11).normal(size=(3, N_POINTS, 3)).astype(np.float32)
    ref = JG.generate_tokens(JLMM(Options(**KW)), params, pts, num_faces=20,
                             bench_no_eos=True)
    adapted = _port(params).eval()
    merged = LMM(TOptions(**BASE))
    load_state(merged, merge_lora_state(state_dict_from_flax(params), KW["lora_alpha"]))
    with torch.no_grad():
        outs = [TG.generate_tokens(m, pts, num_faces=20, bench_no_eos=True)
                for m in (adapted, merged.eval())]
    assert outs[0].shape == ref.shape and ref.shape[1] > 64
    for out in outs:
        np.testing.assert_array_equal(out, np.asarray(ref))
    assert len({tuple(r) for r in outs[0].tolist()}) > 1


def test_lora_weights_round_trip():
    params = _params()
    sd = state_dict_from_flax(params)
    assert sd["mesh_decoder.model.layers.0.fc1.lora_a"].shape == (64, 4)
    assert sd["mesh_decoder.model.layers.0.fc1.lora_b"].shape == (4, 256)
    back = flax_from_state_dict(sd)["params"]["mesh_decoder"]["model"]["layers_1"]
    ref = params["params"]["mesh_decoder"]["model"]["layers_1"]
    for leaf in ("lora_a", "lora_b", "kernel", "bias"):
        np.testing.assert_array_equal(back["self_attn"]["q_proj"][leaf],
                                      ref["self_attn"]["q_proj"][leaf])
        np.testing.assert_array_equal(back["fc2"][leaf], ref["fc2"][leaf])
    with pytest.raises(RuntimeError):  # strict: a dense file has no adapters
        load_state(LMM(TOptions(**KW)), state_dict_from_flax(_params(False)))


def test_lora_with_w_quant_or_moe_is_refused():
    for change in (dict(w_quant=True), dict(moe_experts=4)):
        with pytest.raises(ValueError, match="lora_rank"):
            validate(TOptions(**dict(KW, **change)))
    validate(TOptions(**KW))
    validate(dataclasses.replace(TOptions(**BASE), w_quant=True))

"""The port's tolerant checkpoint merge and weight EMA against the JAX
package's.

`tolerant_merge` over {name: array} entries against JAX's over the same
entries as a flat tree: the merged values and dtypes equal, the log lines
equal in the JAX package's words (its key paths `['name']` read as the
names). The EMA that the trainer keeps against JAX's update formula
(edgerunner_tpu/train/trainer.py:190-192) over 3 steps, within 2^-22 of
each tensor's largest value (two f32 steps at its scale: XLA fuses the
multiply and the add that PyTorch rounds apart); its file
written beside a checkpoint, found by `sibling_ema_path` and restored; and
the eval of the EMA's weights against the model holding them.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from edgerunner_tpu.train.checkpoint import tolerant_merge as j_tolerant_merge
from edgerunner_tpu_torch.config import Options as TOptions
from edgerunner_tpu_torch.models.lmm import LMM, init_weights
from edgerunner_tpu_torch.train.checkpoint import CheckpointManager, sibling_ema_path
from edgerunner_tpu_torch.train.trainer import Trainer
from edgerunner_tpu_torch.weights import read_safetensors, tolerant_merge
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

POS = "mesh_decoder.model.decoder.embed_positions.weight"
KW = dict(cond_mode="point", point_latent_size=16, num_cond_tokens=17,
          point_hidden_dim=32, point_num_heads=2, point_latent_dim=8,
          hidden_dim=32, num_layers=1, num_heads=2, max_seq_length=64,
          use_num_face_cond=True, checkpointing=False, point_num=32, lr=1e-2,
          warmup_ratio=0.0, ema_decay=0.9)


def _entries(model_pos: int, ckpt_pos: int):
    r = np.random.default_rng(model_pos * 7 + ckpt_pos)

    def arr(*shape, dtype=np.float32):
        return r.normal(size=shape).astype(dtype)

    model = {"same.weight": arr(4, 3), "half.weight": arr(5, dtype=np.float16),
             "missing.bias": arr(3), "mismatch.weight": arr(4, 2), POS: arr(model_pos, 6),
             "pos_wrong_width.embed_positions.weight": arr(model_pos, 6)}
    ckpt = {"same.weight": arr(4, 3), "half.weight": arr(5), "mismatch.weight": arr(2, 4),
            POS: arr(ckpt_pos, 6), "pos_wrong_width.embed_positions.weight": arr(ckpt_pos, 5),
            "unexpected.weight": arr(2)}
    return model, ckpt


@pytest.mark.parametrize("align", ["left", "right"])
@pytest.mark.parametrize("sizes", [(10, 7), (7, 10), (8, 8)])
def test_tolerant_merge_matches_jax(align, sizes):
    model, ckpt = _entries(*sizes)
    got_log, want_log = [], []
    got = tolerant_merge(model, ckpt, align_posemb=align, log=got_log.append)
    want = j_tolerant_merge(model, ckpt, align_posemb=align, log=want_log.append)
    assert got.keys() == model.keys()
    for k in model:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype == model[k].dtype and np.array_equal(got[k], w), k
    # the same lines; JAX logs in its sorted key order, the port in the model's
    assert sorted(got_log) == sorted(x.replace("['", "").replace("']", "") for x in want_log)
    assert any("missing param missing.bias" in x for x in got_log)
    assert any("unexpected param unexpected.weight" in x for x in got_log)
    assert any("shape mismatch for mismatch.weight" in x for x in got_log)
    assert any("shape mismatch for pos_wrong_width" in x for x in got_log)
    assert np.array_equal(got["same.weight"], ckpt["same.weight"])
    if sizes[0] != sizes[1]:
        assert any("realigning position embeddings" in x for x in got_log)
        assert not np.array_equal(got[POS], model[POS])


def _model(seed=0):
    return init_weights(LMM(TOptions(**KW)), seed)


def test_ema_follows_jax_formula_over_three_steps():
    model = _model()
    trainer = Trainer(model, model.opt, total_steps=10)
    trainer.init_state()
    decay = trainer.ema_decay
    # the formula of edgerunner_tpu/train/trainer.py:190-192
    step = jax.jit(lambda e, p: jax.tree.map(
        lambda a, b: a * decay + b.astype(a.dtype) * (1.0 - decay), e, p))
    want = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    r = np.random.default_rng(1)
    with torch.no_grad():
        for _ in range(3):
            for p in model.parameters():
                p.add_(torch.tensor(r.normal(size=p.shape).astype(np.float32)))
            trainer.update_ema()
            want = jax.tree.map(np.asarray, step(
                want, {n: p.numpy() for n, p in model.named_parameters()}))
    for n, e in trainer.ema.items():
        assert e.dtype == torch.float32
        np.testing.assert_allclose(e.numpy(), want[n], rtol=0,
                                   atol=2.0 ** -22 * np.abs(want[n]).max(), err_msg=n)
        assert not np.array_equal(e.numpy(), model.state_dict()[n].numpy())


def test_ema_file_is_saved_found_and_restored(tmp_path):
    model = _model()
    trainer = Trainer(model, model.opt, total_steps=10)
    trainer.init_state()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    trainer.update_ema()
    ws = str(tmp_path / "ws")
    CheckpointManager(ws).save_epoch(0, model, ema=trainer.ema, log=lambda _: None)
    path = sibling_ema_path(os.path.join(ws, "model.safetensors"))
    assert path == os.path.join(ws, "ema.safetensors")
    assert os.path.realpath(path) == os.path.join(ws, "ep0000", "ema.safetensors")
    assert sibling_ema_path(os.path.join(ws, "ep0000", "model.safetensors")) is not None
    saved = read_safetensors(path)
    assert saved.keys() == model.state_dict().keys()  # a whole model file
    other = _model(seed=3)
    again = Trainer(other, other.opt, total_steps=10)
    again.init_state(ema_path=path)
    for n, e in trainer.ema.items():
        assert torch.equal(again.ema[n], e), n
    # without --ema_decay no EMA is kept, and its eval is refused
    plain = Trainer(_model(), dataclasses.replace(model.opt, ema_decay=0.0), total_steps=10)
    plain.init_state(ema_path=path)
    assert plain.ema is None
    with pytest.raises(ValueError, match="ema_decay"):
        plain.eval_epoch([], 0, use_ema=True)
    assert sibling_ema_path(str(tmp_path / "nowhere" / "model.safetensors")) is None


def test_eval_of_the_ema_is_the_model_holding_it():
    model = _model()
    trainer = Trainer(model, model.opt, total_steps=10)
    trainer.init_state()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05)
    trainer.update_ema()
    r = np.random.default_rng(4)
    batch = {"conds": r.normal(size=(2, 32, 3)).astype(np.float32),
             "tokens": np.array([[1, 7, 8, 9, 2], [1, 10, 11, 2, 0]], np.int32),
             "labels": np.concatenate([np.full((2, 18), -100), [[7, 8, 9, 2], [10, 11, 2, -100]]],
                                      axis=1).astype(np.int32),
             "num_faces": np.array([10, 20], np.int32), "lengths": np.array([22, 21], np.int32)}
    ema_loss = trainer.eval_loss(batch, use_ema=True)
    live = trainer.eval_loss(batch)
    holder = _model()
    holder.load_state_dict({**holder.state_dict(), **trainer.ema})
    held = Trainer(holder, dataclasses.replace(model.opt, ema_decay=0.0), total_steps=10)
    assert ema_loss == held.eval_loss(batch) and ema_loss != live

"""dp 2 × pp 2 × tp 2 in the port: all three axes of a data-, pipeline- and
tensor-parallel mesh at once, 8 ranks, held to the JAX package and to the
port's one process in f32 on the CPU.

One `Trainer.train_step` over 8 gloo CPU processes (tests/
torch_layout_workers.py; rank = ((d · pp + p) · tp + t)), each holding its
tp share of its stage's 2 layers and its dp group's rows of the 4-row
batch in 2 microbatches, against the JAX objective on one device
(tests/layout_parity.py): dense layers give one device's result on any
mesh (tests/test_torch_pp.py). It holds:

- the loss and the global norm on every rank, and in one process;
- every gradient the optimizer takes, each stage's layers gathered over pp
  and each tp shard joined, whole on rank 0;
- after the step the whole (replicated) weights bit-equal on all 8 ranks.

Tolerance: atol 1e-5, rtol 1e-4 (`layout_parity.TOL`).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import pytest

from layout_parity import (
    KW,
    check_grads,
    check_metrics,
    check_same_replicated,
    jax_objective,
    make_batch,
    state,
)
from torch_layout_workers import _trainer, layout_runs, layout_step
from torch_sp_workers import spawn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAME = "dp2xpp2xtp2"
CASE = dict(KW, pp_microbatches=2)
SIZES = {"dp": 2, "pp": 2, "tp": 2}


@functools.lru_cache(maxsize=None)
def objective():
    """(loss, grads by port name, global norm) of the JAX step on one device."""
    loss, _, grads, norm = jax_objective(KW, make_batch(), {})
    return loss, grads, norm


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 8 ranks' results; the JAX objective is taken while they run."""
    run = (NAME, CASE, state(CASE), make_batch(), SIZES, "arae")
    with ThreadPoolExecutor(1) as pool:
        out = pool.submit(spawn, layout_runs, 8, tmp_path_factory.mktemp("eight"), [run])
        objective()
        return out.result()


@pytest.fixture(scope="module")
def single():
    """The step in this process, nothing split."""
    return layout_step(_trainer(CASE, state(CASE), {}), make_batch(), NAME)


@pytest.mark.parametrize("where", ["ranks", "one_process"])
def test_loss_and_grad_norm_match_jax(ranks, single, where):
    loss, _, norm = objective()
    for res in (ranks if where == "ranks" else [single]):
        check_metrics(res, NAME, loss, norm=norm)
    assert norm > KW["gradient_clip"]  # clipping is active
    assert len(ranks) == 8


@pytest.mark.parametrize("where", ["ranks", "one_process"])
def test_gradients_gathered_whole_match_jax(ranks, single, where):
    _, grads, _ = objective()
    res = ranks[0] if where == "ranks" else single
    assert check_grads(res, NAME, grads) > 40
    if where == "ranks":
        layers = {k.split(".")[3] for k in res
                  if k.startswith(f"{NAME}/grad/mesh_decoder.model.layers.")}
        assert layers == {"0", "1"}  # both stages, each joined over tp
        q = res[f"{NAME}/grad/mesh_decoder.model.layers.1.self_attn.q_proj.weight"]
        assert q.shape == (KW["hidden_dim"], KW["hidden_dim"])


def test_every_rank_holds_the_same_whole_weights_after_the_step(ranks):
    assert check_same_replicated(ranks, NAME) > 10

"""The MoE decoder under sequence parallelism (`--moe_experts` with
`--sp_size`), and with expert and tensor parallelism beside it, against
the JAX package's meshes on the conftest's virtual CPU devices and the
port's one process, in f32 on the CPU, with capacity factor 0.5 so that
tokens are dropped (MoE under pp: tests/test_torch_moe_pp.py).

GSPMD routes the whole sequence in the JAX package (only the attention
is shard_mapped), so an sp rank's tokens take their queue positions among
every rank's: the port gathers each rank's (row, k, expert) counts over
the ranks that hold the batch's other rows and positions (models/moe.py
`route`). One `Trainer.train_step` over gloo CPU processes (tests/
torch_layout_workers.py), held to the JAX objective (tests/
layout_parity.py):

- sp 2 on ragged rows, against the JAX sp mesh: the suffix padding is
  routed too, and the ring, like JAX's, leaves rows past a length
  unmasked, so that only full rows route as one device does;
- on full rows, sp 2, dp 2 × sp 2 and sp 2 × ep 2, and tp 2 × ep 2 (the
  MoE whole on every tp rank) on ragged rows, against one device (their
  JAX meshes route as it does) and the port's one process;
- the loss, loss_moe, the gradients the optimizer takes (gathered whole),
  the global norm, and every rank's whole weights bit-equal after the
  step; gradient checkpointing on under sp, whose replay routes again.

Tolerance: atol 1e-5, rtol 1e-4.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from edgerunner_tpu_torch.models import moe as M
from layout_parity import (
    KW,
    MOE,
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

MOE_KW = dict(KW, **MOE)
SP_KW = dict(MOE_KW, checkpointing=True)
RAGGED, FULL = make_batch(), make_batch(L=25, ragged=False)  # 43 and 44 positions
# name -> (options, layout, batch, the JAX mesh it is held to: its own, or on
# full rows, where every layout routes as one device does, one device; then
# the port's one process too)
CASES = {"sp2": (SP_KW, {"sp": 2}, RAGGED, "mesh"),
         "sp2_full": (SP_KW, {"sp": 2}, FULL, "one"),
         "dp2xsp2": (SP_KW, {"dp": 2, "sp": 2}, FULL, "one"),
         "sp2xep2": (SP_KW, {"sp": 2, "ep": 2}, FULL, "one"),
         "tp2xep2": (MOE_KW, {"tp": 2, "ep": 2}, RAGGED, "one")}
SOLO = [n for n, case in CASES.items() if case[3] == "one"]


@functools.lru_cache(maxsize=None)
def _objective(kw_items: tuple, batch: str, sizes: tuple):
    return jax_objective(dict(kw_items), {"ragged": RAGGED, "full": FULL}[batch], dict(sizes))


def objective(name: str):
    kw, sizes, batch, held = CASES[name]
    return _objective(tuple(sorted(kw.items())), "full" if batch is FULL else "ragged",
                      tuple(sorted(sizes.items())) if held == "mesh" else ())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's ranks, spawned once per world size; the JAX objectives
    are taken while they run."""
    tmp = tmp_path_factory.mktemp("moe_sp")
    cases = {n: (n, kw, state(kw), batch, sizes, "arae")
             for n, (kw, sizes, batch, _) in CASES.items()}
    two = [c for n, c in cases.items() if len(CASES[n][1]) == 1]
    four = [c for n, c in cases.items() if len(CASES[n][1]) == 2]
    with ThreadPoolExecutor(2) as pool:
        ranks2 = pool.submit(spawn, layout_runs, 2, tmp / "two", two)
        ranks4 = pool.submit(spawn, layout_runs, 4, tmp / "four", four)
        for name in CASES:
            objective(name)
        ranks2, ranks4 = ranks2.result(), ranks4.result()
    return {n: ranks2 if len(sizes) == 1 else ranks4 for n, (_, sizes, _, _) in CASES.items()}


@pytest.fixture(scope="module")
def single():
    """The cases whose routing one process shares, in this process."""
    return {n: layout_step(_trainer(CASES[n][0], state(CASES[n][0]), {}), CASES[n][2], n)
            for n in SOLO}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_loss_moe_and_grad_norm_match_jax(runs, name):
    loss, moe, _, norm = objective(name)
    for res in runs[name]:
        check_metrics(res, name, loss, moe, norm)
    assert norm > KW["gradient_clip"]  # clipping is active


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_gathered_whole_match_jax(runs, name):
    _, _, grads, _ = objective(name)
    assert check_grads(runs[name][0], name, grads) > 40


@pytest.mark.parametrize("name", SOLO)
def test_where_the_routing_is_the_same_one_process_matches(runs, single, name):
    loss, moe, grads, norm = objective(name)
    check_metrics(single[name], name, loss, moe, norm)
    check_grads(single[name], name, grads)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_the_same_whole_weights_after_the_step(runs, name):
    assert check_same_replicated(runs[name], name) > 10


def test_the_capacity_drops_tokens_and_a_shard_routed_alone_would_not_match():
    """Capacity factor 0.5 drops assignments, so routing each sp shard by
    itself (its own capacity and queues) moves them: the sp runs' equality
    with the JAX step above is the whole sequence's routing."""
    x = torch.tensor(np.random.default_rng(1).normal(size=(4, 44, 4)).astype(np.float32))
    whole = M.route(x.reshape(-1, 4), 2, 0.5, rows=4)
    assert not whole["keep"].all()
    alone = [M.route(x[:, s * 22:(s + 1) * 22].reshape(-1, 4), 2, 0.5, rows=4)["keep"]
             .view(4, 22, 2) for s in range(2)]
    assert not torch.equal(torch.cat(alone, 1), whole["keep"].view(4, 44, 2))

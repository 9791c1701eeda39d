"""The MoE decoder under pipeline parallelism (`--moe_experts` with
`--pp_size`, and `--ep_size` beside it) against the JAX pipeline on the
conftest's virtual CPU devices, in f32 on the CPU, with capacity factor
0.5 so that tokens are dropped (tests/test_moe.py:275-340).

Each microbatch is routed on its own, and loss_moe is the mean of the
per-(layer, microbatch) aux over the pipeline's real work (JAX
pipeline.py:62-69, :125-128, :156): so with 2 microbatches the drops
differ from one device's, and with 1 they are one device's. One
`Trainer.train_step` over gloo CPU processes (tests/torch_layout_workers.py):
pp 2 and pp 2 × ep 2 with 2 microbatches against the JAX pipeline on
their meshes, pp 2 with 1 microbatch against one device and the port's
one process (tests/layout_parity.py); dp 2 × pp 2 with 2 microbatches
against the JAX pipeline on its mesh, whose microbatch m is rows [m ·
B/M, (m + 1) · B/M) of the global batch: the whole of dp group 0's rows
for m = 0, so the groups trade rows before the step
(`jax_microbatch_rows`), and `make_batch`'s ragged rows give the groups
other label counts after the trade as before it:

- the loss, loss_moe, the gradients the optimizer takes (gathered whole)
  and the global norm;
- every rank's whole weights (the embeddings, the condition encoder,
  lm_head) bit-equal after the step;
- under dp 2 × pp 2 the held-out loss of the whole batch (`eval_epoch`,
  every dp group on every row, no rows traded) against the JAX
  objective's loss without its aux term.

Tolerance: atol 1e-5, rtol 1e-4.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from layout_parity import (
    KW,
    MOE,
    TOL,
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
CASES = {"pp2": (dict(MOE_KW, pp_microbatches=2), {"pp": 2}),
         "pp2_m1": (dict(MOE_KW, pp_microbatches=1), {"pp": 2}),
         "pp2xep2": (dict(MOE_KW, pp_microbatches=2), {"pp": 2, "ep": 2}),
         "dp2xpp2": (dict(MOE_KW, pp_microbatches=2), {"dp": 2, "pp": 2})}


@functools.lru_cache(maxsize=None)
def objective(name: str):
    """The JAX pipeline on the case's mesh; with one microbatch, one device."""
    kw, sizes = CASES[name]
    M = kw["pp_microbatches"]
    return jax_objective(kw, make_batch(), sizes if M > 1 else {}, M)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's ranks, spawned once per world size; the JAX objectives
    are taken while they run."""
    tmp = tmp_path_factory.mktemp("moe_pp")
    cases = {n: (n, kw, state(kw), make_batch(), sizes, "arae")
             for n, (kw, sizes) in CASES.items()}
    two = [c for n, c in cases.items() if len(CASES[n][1]) == 1]
    four = [c for n, c in cases.items() if len(CASES[n][1]) == 2]
    with ThreadPoolExecutor(2) as pool:
        ranks2 = pool.submit(spawn, layout_runs, 2, tmp / "two", two)
        ranks4 = pool.submit(spawn, layout_runs, 4, tmp / "four", four)
        for name in CASES:
            objective(name)
        ranks2, ranks4 = ranks2.result(), ranks4.result()
    return {n: ranks2 if len(sizes) == 1 else ranks4 for n, (_, sizes) in CASES.items()}


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


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_the_same_whole_weights_after_the_step(runs, name):
    assert check_same_replicated(runs[name], name) > 10


def test_one_microbatch_routes_as_one_process(runs):
    kw, _ = CASES["pp2_m1"]
    one = layout_step(_trainer(kw, state(kw), {}), make_batch(), "pp2_m1")
    loss, moe, grads, norm = objective("pp2_m1")
    check_metrics(one, "pp2_m1", loss, moe, norm)
    check_grads(one, "pp2_m1", grads)


def test_two_microbatches_route_otherwise():
    """The drops of 2 microbatches are not one device's: the pipeline's
    equality above is the per-microbatch routing's."""
    whole, split = objective("pp2_m1"), objective("pp2")
    assert abs(whole[0] - split[0]) > 5 * (TOL["atol"] + TOL["rtol"] * abs(whole[0]))


def test_dp2xpp2_eval_loss_routes_the_jax_microbatches(runs):
    """Before the step every rank's eval of the whole batch is the JAX
    pipeline's loss on the dp 2 × pp 2 mesh without the aux term (the eval
    step leaves loss_moe out)."""
    from edgerunner_tpu.config import Options

    kw, _ = CASES["dp2xpp2"]
    loss, moe, _, _ = objective("dp2xpp2")
    want = loss - Options(**kw).moe_aux_weight * moe
    for res in runs["dp2xpp2"]:
        np.testing.assert_allclose(float(res["dp2xpp2/eval"]), want, **TOL)

"""The port's choice of collective backend (`parallel/mesh.py
choose_backend`), decided by the ranks on each machine: torchrun's
LOCAL_WORLD_SIZE, or the world when it is unset (ranks spawned from one
process), against the cards that machine has. The card count is
monkeypatched, so these run on the CPU; `init_distributed` is held to the
choice and to failing when the process group fails, and `gather_list` to
handing NCCL device memory when a save gathers a part joined on the host.
"""

import pytest
import torch
import torch.distributed as dist

from edgerunner_tpu_torch.parallel import choose_backend, init_distributed
from edgerunner_tpu_torch.parallel import mesh
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CUDA = torch.device("cuda", 0)


@pytest.fixture
def machine(monkeypatch):
    """`machine(cards, local=None, world=None)` sets the card count and
    torchrun's variables (unset where None)."""

    def setup(cards: int, local=None, world=None):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        for name, value in (("LOCAL_WORLD_SIZE", local), ("WORLD_SIZE", world)):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, str(value))

    return setup


@pytest.mark.parametrize("cards, local, world, want", [
    (8, 8, 16, "nccl"),    # torchrun --nnodes 2 --nproc_per_node 8, 8 cards a node
    (2, 2, 4, "nccl"),     # --nnodes 2 --nproc_per_node 2 on 2 cards each
    (4, 4, 4, "nccl"),     # --standalone on 4 cards
    (2, 4, 4, "gloo"),     # 4 ranks on 2 cards: ranks share a card
    (1, 2, 2, "gloo"),     # 2 ranks on one card
    (8, 16, 16, "gloo"),   # 16 ranks on one machine of 8 cards
], ids=["2_nodes_x_8_cards", "2_nodes_x_2_cards", "4_ranks_4_cards", "4_ranks_2_cards",
        "2_ranks_1_card", "16_ranks_8_cards"])
def test_backend_is_decided_by_the_ranks_on_this_machine(machine, cards, local, world, want):
    machine(cards, local, world)
    assert choose_backend(CUDA, world) == want


@pytest.mark.parametrize("cards, world, want", [(4, 2, "nccl"), (4, 4, "nccl"),
                                                (4, 8, "gloo"), (1, 2, "gloo")])
def test_without_local_world_size_the_world_decides(machine, cards, world, want):
    """Ranks spawned from one process (chip_smoke.py, the tests): no
    LOCAL_WORLD_SIZE, every rank on this machine."""
    machine(cards, local=None, world=world)
    assert mesh.local_world_size(world) == world
    assert choose_backend(CUDA, world) == want


@pytest.mark.parametrize("local, world", [(None, 2), (8, 16), (1, 1)])
def test_the_cpu_takes_gloo(machine, local, world):
    machine(8, local, world)
    assert choose_backend(torch.device("cpu"), world) == "gloo"


def test_init_distributed_joins_with_the_choice_and_the_card(machine, monkeypatch):
    """Two nodes of 2 cards, this rank 3 of 4: NCCL bound to its card
    (eager initialisation, `device_id`), the card set first."""
    machine(2, local=2, world=4)
    calls, devices = [], []
    monkeypatch.setattr(torch.cuda, "set_device", devices.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    dev = torch.device("cuda", 1)
    assert init_distributed(dev, rank=3, world_size=4, init_method="tcp://h:1") == "nccl"
    assert devices == [dev]
    assert calls == [("nccl", dict(init_method="tcp://h:1", rank=3, world_size=4,
                                   device_id=dev))]


def test_an_nccl_failure_fails_the_run(machine, monkeypatch):
    """No fallback: the process group's error reaches the caller, and gloo
    is never tried."""
    machine(4, local=4, world=4)
    tried = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)

    def fail(backend, **kw):
        tried.append(backend)
        raise RuntimeError("NCCL error: unhandled system error")

    monkeypatch.setattr(dist, "init_process_group", fail)
    with pytest.raises(RuntimeError, match="NCCL error"):
        init_distributed(CUDA, rank=0, world_size=4, init_method="tcp://h:1")
    assert tried == ["nccl"]


@pytest.mark.parametrize("backend, moved", [("nccl", True), ("gloo", False)])
def test_gather_list_hands_nccl_a_host_part_on_the_card(monkeypatch, backend, moved):
    """Under pp × tp a save joins each tp split on the host and gathers it
    over pp next: NCCL takes no host tensor, so it goes to the card first;
    gloo takes it as it is."""
    from edgerunner_tpu_torch.parallel import collectives

    to_card, sent = [], []

    def cuda(self, *args, **kw):
        to_card.append(self)
        return self

    monkeypatch.setattr(torch.Tensor, "cuda", cuda)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(dist, "get_global_rank", lambda group, rank: rank)
    monkeypatch.setattr(dist, "gather", lambda buf, outs, dst, group: sent.append(buf))
    part = torch.arange(6.0).view(2, 3)
    assert collectives.gather_list(part, mesh.Group(None, 1, 2, False)) is None
    assert len(sent) == 1 and torch.equal(sent[0], part)
    assert [t.data_ptr() for t in to_card] == ([sent[0].data_ptr()] if moved else [])

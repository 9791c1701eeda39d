"""Process groups, data, sequence and expert parallelism of the port
(edgerunner_tpu/parallel/)."""

from edgerunner_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_,
    assert_same_on_every_rank,
    broadcast_,
    dp_total,
    ep_sum,
    ep_sum_grad,
    gather_to_first,
    ring_shift,
)
from edgerunner_tpu_torch.parallel.mesh import (
    DataParallel,
    ExpertParallel,
    SequenceParallel,
    active_data_parallel,
    active_sequence_parallel,
    choose_backend,
    data_parallel,
    dp_for_world,
    init_distributed,
    make_ep_layout,
    make_layout,
    rank_device,
    sequence_parallel,
)

__all__ = ["DataParallel", "ExpertParallel", "SequenceParallel", "active_data_parallel",
           "active_sequence_parallel", "all_gather", "all_reduce_",
           "assert_same_on_every_rank", "broadcast_", "choose_backend", "data_parallel",
           "dp_for_world", "dp_total", "ep_sum", "ep_sum_grad", "gather_to_first",
           "init_distributed", "make_ep_layout", "make_layout", "rank_device", "ring_shift",
           "sequence_parallel"]

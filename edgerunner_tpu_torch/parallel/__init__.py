"""Process groups, data and sequence parallelism of the port
(edgerunner_tpu/parallel/)."""

from edgerunner_tpu_torch.parallel.collectives import (
    all_reduce_,
    assert_same_on_every_rank,
    broadcast_,
    dp_total,
    ring_shift,
)
from edgerunner_tpu_torch.parallel.mesh import (
    DataParallel,
    SequenceParallel,
    active_data_parallel,
    active_sequence_parallel,
    choose_backend,
    data_parallel,
    dp_for_world,
    init_distributed,
    make_layout,
    rank_device,
    sequence_parallel,
)

__all__ = ["DataParallel", "SequenceParallel", "active_data_parallel",
           "active_sequence_parallel", "all_reduce_", "assert_same_on_every_rank",
           "broadcast_", "choose_backend", "data_parallel", "dp_for_world", "dp_total",
           "init_distributed", "make_layout", "rank_device", "ring_shift",
           "sequence_parallel"]

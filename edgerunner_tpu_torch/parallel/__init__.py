"""Process groups and sequence parallelism of the port
(edgerunner_tpu/parallel/)."""

from edgerunner_tpu_torch.parallel.collectives import (
    all_reduce_,
    assert_same_on_every_rank,
    broadcast_,
    ring_shift,
)
from edgerunner_tpu_torch.parallel.mesh import (
    SequenceParallel,
    active_sequence_parallel,
    choose_backend,
    init_distributed,
    rank_device,
    sequence_parallel,
)

__all__ = ["SequenceParallel", "active_sequence_parallel", "all_reduce_",
           "assert_same_on_every_rank", "broadcast_", "choose_backend",
           "init_distributed", "rank_device", "ring_shift", "sequence_parallel"]

"""Process groups and the data, pipeline, sequence, tensor and expert
parallelism of the port (edgerunner_tpu/parallel/)."""

from edgerunner_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_,
    assert_same_on_every_rank,
    broadcast_,
    copy_to_tp,
    dp_total,
    ep_sum,
    ep_sum_grad,
    gather_from_tp,
    gather_list,
    gather_to_first,
    reduce_from_tp,
    ring_shift,
)
from edgerunner_tpu_torch.parallel.mesh import (
    AXES,
    DataParallel,
    ExpertParallel,
    Group,
    Layout,
    PipelineParallel,
    SequenceParallel,
    TensorParallel,
    active_data_parallel,
    active_sequence_parallel,
    choose_backend,
    data_parallel,
    dp_for_world,
    init_distributed,
    make_layout,
    rank_device,
    sequence_parallel,
    tp_join,
    tp_slice,
)

__all__ = ["AXES", "DataParallel", "ExpertParallel", "Group", "Layout", "PipelineParallel",
           "SequenceParallel", "TensorParallel", "active_data_parallel",
           "active_sequence_parallel", "all_gather", "all_reduce_",
           "assert_same_on_every_rank", "broadcast_", "choose_backend", "copy_to_tp",
           "data_parallel", "dp_for_world", "dp_total", "ep_sum", "ep_sum_grad",
           "gather_from_tp", "gather_list", "gather_to_first", "init_distributed",
           "make_layout", "rank_device", "reduce_from_tp", "ring_shift", "sequence_parallel",
           "tp_join", "tp_slice"]

"""Data-parallel training on ``torch.distributed``: the int8
error-feedback gradient codec, fault policies, tree placement and the
process group (``group``: backend choice, spawning ranks)."""
from repro_torch.distributed.compression import (ErrorFeedbackCompressor,
                                                 compress_int8,
                                                 decompress_int8)
from repro_torch.distributed.elastic import reshard_tree, replicate_tree
from repro_torch.distributed.fault import (HeartbeatTracker, RestartPolicy,
                                           StragglerMonitor)
from repro_torch.distributed.group import (DPGroup, GroupPlan, launch,
                                           parse_mesh_spec, plan_group)

__all__ = [
    "DPGroup", "ErrorFeedbackCompressor", "GroupPlan", "HeartbeatTracker",
    "RestartPolicy", "StragglerMonitor", "compress_int8", "decompress_int8",
    "launch", "parse_mesh_spec", "plan_group", "replicate_tree",
    "reshard_tree",
]

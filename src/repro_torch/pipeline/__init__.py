"""Partitioning (the minibatch pipeline is still to be ported)."""
from repro_torch.pipeline.partition import contiguous_block_partition

__all__ = ["contiguous_block_partition"]

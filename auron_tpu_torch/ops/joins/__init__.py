"""Joins: broadcast hash join, shuffled hash join, sort-merge join
(counterpart of auron_tpu/ops/joins).

The build side is a device-sorted table of 64-bit key hashes; probes
find their match ranges by searchsorted, expand them to (probe, build)
index pairs in fixed-size chunks and verify true key equality, which
removes hash collisions (ops/joins/kernel.py).
"""

from auron_tpu_torch.ops.joins.exec import (
    BroadcastJoinBuildHashMapExec, BroadcastJoinExec, HashJoinExec,
    SortMergeJoinExec,
)

__all__ = ["BroadcastJoinExec", "BroadcastJoinBuildHashMapExec",
           "HashJoinExec", "SortMergeJoinExec"]

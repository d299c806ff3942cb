"""Physical planner: plan IR -> operator tree (counterpart of
auron_tpu/runtime/planner.py), one arm per plan-node kind of this slice.
"""

from __future__ import annotations

from typing import Callable, Dict

from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ops.agg.exec import AggExec
from auron_tpu_torch.ops.base import Operator
from auron_tpu_torch.ops.basic import (
    CoalesceBatchesExec, DebugExec, EmptyPartitionsExec, ExpandExec,
    FilterExec, LimitExec, ProjectExec, RenameColumnsExec, UnionExec,
)
from auron_tpu_torch.ops.joins import (
    BroadcastJoinBuildHashMapExec, BroadcastJoinExec, HashJoinExec,
    SortMergeJoinExec,
)
from auron_tpu_torch.ops.scan.ipc import FFIReaderExec, IpcReaderExec
from auron_tpu_torch.ops.shuffle.writer import RssShuffleWriterExec
from auron_tpu_torch.ops.sort import SortExec
from auron_tpu_torch.ops.window.exec import WindowExec


class PhysicalPlanner:
    def __init__(self) -> None:
        self._arms: Dict[str, Callable[..., Operator]] = {
            "ffi_reader": lambda n: FFIReaderExec(n.schema, n.resource_id),
            "ipc_reader": lambda n: IpcReaderExec(n.schema, n.resource_id),
            "empty_partitions": lambda n: EmptyPartitionsExec(
                n.schema, n.num_partitions),
            "projection": self._projection,
            "filter": lambda n: FilterExec(self.create_plan(n.child),
                                           n.predicates),
            "limit": lambda n: LimitExec(self.create_plan(n.child),
                                         n.limit, n.offset),
            "agg": lambda n: AggExec(
                self.create_plan(n.child), n.exec_mode, n.grouping,
                n.grouping_names, n.aggs, n.agg_names,
                n.supports_partial_skipping),
            "expand": lambda n: ExpandExec(
                self.create_plan(n.child), n.projections, n.names, n.types),
            "window": lambda n: WindowExec(
                self.create_plan(n.child), n.window_funcs, n.partition_by,
                n.order_by, n.group_limit, n.output_window_cols),
            "debug": lambda n: DebugExec(self.create_plan(n.child),
                                         n.debug_id),
            "rename_columns": lambda n: RenameColumnsExec(
                self.create_plan(n.child), n.names),
            "coalesce_batches": lambda n: CoalesceBatchesExec(
                self.create_plan(n.child), n.target_batch_size),
            "union": lambda n: UnionExec(
                [self.create_plan(i.child) for i in n.inputs], n.schema,
                [(i.out_partition, i.partition) for i in n.inputs]),
            "sort": lambda n: SortExec(
                self.create_plan(n.child), n.sort_exprs, n.fetch_limit,
                n.fetch_offset),
            "rss_shuffle_writer": lambda n: RssShuffleWriterExec(
                self.create_plan(n.child), n.partitioning,
                n.rss_resource_id),
            "sort_merge_join": lambda n: SortMergeJoinExec(
                self.create_plan(n.left), self.create_plan(n.right), n.on,
                n.join_type, n.sort_options, n.existence_output_name),
            "hash_join": lambda n: HashJoinExec(
                self.create_plan(n.left), self.create_plan(n.right), n.on,
                n.join_type, n.build_side, n.existence_output_name),
            "broadcast_join": lambda n: BroadcastJoinExec(
                self.create_plan(n.left), self.create_plan(n.right), n.on,
                n.join_type, n.broadcast_side, n.cached_build_hash_map_id,
                n.existence_output_name),
            "broadcast_join_build_hash_map": lambda n:
                BroadcastJoinBuildHashMapExec(self.create_plan(n.child),
                                              n.keys, n.cache_id),
        }

    def _projection(self, n: P.Projection) -> Operator:
        # a projection over a filter fuses into it, as in the JAX package
        if n.child.kind == "filter":
            return FilterExec(self.create_plan(n.child.child),
                              n.child.predicates, exprs=n.exprs,
                              names=n.names)
        return ProjectExec(self.create_plan(n.child), n.exprs, n.names)

    def create_plan(self, node: P.PlanNode) -> Operator:
        if node.kind in ("parquet_scan", "orc_scan"):
            raise NotImplementedError(P.SCANS_NOT_PORTED)
        arm = self._arms.get(node.kind)
        if arm is None:
            raise NotImplementedError(
                f"plan node {node.kind!r} is not in auron_tpu_torch yet")
        return arm(node)

"""Physical plan IR nodes (counterpart of auron_tpu/ir/plan.py).

The nodes of the port's stages: the FFI and IPC readers, empty
partitions, projection, filter, limit, aggregation, expand, the window
(its function calls and group limit), rename, coalesce batches, debug,
sort, the joins (sort-merge, shuffled hash, broadcast and its build-map
stage), the union, the RSS shuffle writer with its partitioning, and
the `TaskDefinition` a front end ships.  Fields and `kind` tags are the
JAX package's, so their JSON is the same.

The file scans (`ParquetScan`, `OrcScan` and their `FileGroup`s) are
data only, so that a converted plan equals the JAX package's: the port
reads no file (`SCANS_NOT_PORTED`), and the planner and the session
raise on them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, ClassVar, Optional, Tuple

from auron_tpu_torch.ir.expr import AggExpr, Expr, SortExpr
from auron_tpu_torch.ir.node import Node, register
from auron_tpu_torch.ir.schema import DataType, Schema


@dataclass(frozen=True)
class PlanNode(Node):
    kind: ClassVar[str] = "plan"


@register
@dataclass(frozen=True)
class Partitioning(Node):
    """mode in {hash, round_robin, single, range}; the port runs hash,
    range and single."""
    kind: ClassVar[str] = "partitioning"
    mode: str = "single"
    num_partitions: int = 1
    expressions: Tuple[Expr, ...] = ()          # hash keys
    sort_orders: Tuple[SortExpr, ...] = ()      # range partitioning orders
    range_bounds: Tuple[Any, ...] = ()          # sampled bound rows (tuples)


SCANS_NOT_PORTED = ("the parquet and ORC scans are not in auron_tpu_torch "
                    "yet (ROADMAP Queue 1 item 13); register a convert "
                    "provider that claims the scan and a foreign engine "
                    "that reads it")


@register
@dataclass(frozen=True)
class FileGroup(Node):
    kind: ClassVar[str] = "file_group"
    paths: Tuple[str, ...] = ()
    # per-file (offset, length) splits; empty = whole file
    ranges: Tuple[Tuple[int, int], ...] = ()


@register
@dataclass(frozen=True)
class ParquetScan(PlanNode):
    kind: ClassVar[str] = "parquet_scan"
    schema: Schema = None  # type: ignore[assignment]
    file_groups: Tuple[FileGroup, ...] = ()       # one group per partition
    projection: Tuple[int, ...] = ()              # column indices ( () = all )
    predicate: Optional[Expr] = None              # pushed-down filter
    partition_schema: Optional[Schema] = None     # hive partition columns
    partition_values: Tuple[Tuple[Any, ...], ...] = ()


@register
@dataclass(frozen=True)
class OrcScan(PlanNode):
    kind: ClassVar[str] = "orc_scan"
    schema: Schema = None  # type: ignore[assignment]
    file_groups: Tuple[FileGroup, ...] = ()
    projection: Tuple[int, ...] = ()
    predicate: Optional[Expr] = None
    positional_evolution: bool = False


def scan_output_schema(n) -> Schema:
    """A file scan's output: its projected columns, then the partition
    columns (the JAX package's scan operators' schema)."""
    out = n.schema.select(tuple(n.projection) or range(len(n.schema)))
    part = getattr(n, "partition_schema", None)
    return out.concat(part) if part else out


@register
@dataclass(frozen=True)
class IpcReader(PlanNode):
    """Reads shuffle blocks from a resource (shuffle read)."""
    kind: ClassVar[str] = "ipc_reader"
    schema: Schema = None  # type: ignore[assignment]
    resource_id: str = ""


@register
@dataclass(frozen=True)
class FFIReader(PlanNode):
    """Imports batches produced by the front end (the Arrow C-Data
    import's counterpart)."""
    kind: ClassVar[str] = "ffi_reader"
    schema: Schema = None  # type: ignore[assignment]
    resource_id: str = ""


@register
@dataclass(frozen=True)
class EmptyPartitions(PlanNode):
    kind: ClassVar[str] = "empty_partitions"
    schema: Schema = None  # type: ignore[assignment]
    num_partitions: int = 1


@register
@dataclass(frozen=True)
class Projection(PlanNode):
    kind: ClassVar[str] = "projection"
    child: PlanNode = None  # type: ignore[assignment]
    exprs: Tuple[Expr, ...] = ()
    names: Tuple[str, ...] = ()


@register
@dataclass(frozen=True)
class Filter(PlanNode):
    kind: ClassVar[str] = "filter"
    child: PlanNode = None  # type: ignore[assignment]
    predicates: Tuple[Expr, ...] = ()   # conjunctive


@register
@dataclass(frozen=True)
class Limit(PlanNode):
    kind: ClassVar[str] = "limit"
    child: PlanNode = None  # type: ignore[assignment]
    limit: int = 0
    offset: int = 0


@register
@dataclass(frozen=True)
class Agg(PlanNode):
    """Two-phase aggregation; exec_mode: partial | final | single."""
    kind: ClassVar[str] = "agg"
    child: PlanNode = None  # type: ignore[assignment]
    exec_mode: str = "single"
    grouping: Tuple[Expr, ...] = ()
    grouping_names: Tuple[str, ...] = ()
    aggs: Tuple[AggExpr, ...] = ()
    agg_names: Tuple[str, ...] = ()
    supports_partial_skipping: bool = False


@register
@dataclass(frozen=True)
class Expand(PlanNode):
    """Grouping-sets projections: one copy of each input row per
    projection list."""
    kind: ClassVar[str] = "expand"
    child: PlanNode = None  # type: ignore[assignment]
    projections: Tuple[Tuple[Expr, ...], ...] = ()
    names: Tuple[str, ...] = ()
    types: Tuple[DataType, ...] = ()


@register
@dataclass(frozen=True)
class WindowGroupLimit(Node):
    """Top-k rows per window partition by a rank function."""
    kind: ClassVar[str] = "window_group_limit"
    k: int = 0
    rank_fn: str = "row_number"   # row_number | rank | dense_rank


@register
@dataclass(frozen=True)
class WindowFuncCall(Node):
    kind: ClassVar[str] = "window_func_call"
    fn: str = "row_number"                 # WindowFunction value
    args: Tuple[Expr, ...] = ()
    agg: Optional[AggExpr] = None          # for fn == "agg"
    return_type: DataType = None  # type: ignore[assignment]
    name: str = ""


@register
@dataclass(frozen=True)
class Window(PlanNode):
    kind: ClassVar[str] = "window"
    child: PlanNode = None  # type: ignore[assignment]
    window_funcs: Tuple[WindowFuncCall, ...] = ()
    partition_by: Tuple[Expr, ...] = ()
    order_by: Tuple[SortExpr, ...] = ()
    group_limit: Optional[WindowGroupLimit] = None
    output_window_cols: bool = True


@register
@dataclass(frozen=True)
class RenameColumns(PlanNode):
    kind: ClassVar[str] = "rename_columns"
    child: PlanNode = None  # type: ignore[assignment]
    names: Tuple[str, ...] = ()


@register
@dataclass(frozen=True)
class CoalesceBatches(PlanNode):
    kind: ClassVar[str] = "coalesce_batches"
    child: PlanNode = None  # type: ignore[assignment]
    target_batch_size: int = 0    # 0 = use config default


@register
@dataclass(frozen=True)
class Debug(PlanNode):
    """Pass-through that logs the batches it streams."""
    kind: ClassVar[str] = "debug"
    child: PlanNode = None  # type: ignore[assignment]
    debug_id: str = ""


@register
@dataclass(frozen=True)
class Sort(PlanNode):
    """In-memory sort with an optional fetch limit and offset."""
    kind: ClassVar[str] = "sort"
    child: PlanNode = None  # type: ignore[assignment]
    sort_exprs: Tuple[SortExpr, ...] = ()
    fetch_limit: Optional[int] = None
    fetch_offset: int = 0


@register
@dataclass(frozen=True)
class JoinOn(Node):
    kind: ClassVar[str] = "join_on"
    left_keys: Tuple[Expr, ...] = ()
    right_keys: Tuple[Expr, ...] = ()


@register
@dataclass(frozen=True)
class SortMergeJoin(PlanNode):
    kind: ClassVar[str] = "sort_merge_join"
    left: PlanNode = None  # type: ignore[assignment]
    right: PlanNode = None  # type: ignore[assignment]
    on: JoinOn = None  # type: ignore[assignment]
    join_type: str = "inner"
    sort_options: Tuple[Tuple[bool, bool], ...] = ()   # (asc, nulls_first) per key
    existence_output_name: str = "exists"


@register
@dataclass(frozen=True)
class HashJoin(PlanNode):
    """Shuffled hash join (both sides partitioned by key)."""
    kind: ClassVar[str] = "hash_join"
    left: PlanNode = None  # type: ignore[assignment]
    right: PlanNode = None  # type: ignore[assignment]
    on: JoinOn = None  # type: ignore[assignment]
    join_type: str = "inner"
    build_side: str = "right"
    existence_output_name: str = "exists"


@register
@dataclass(frozen=True)
class BroadcastJoinBuildHashMap(PlanNode):
    """Builds the broadcast hash map once per device from the broadcast
    batches."""
    kind: ClassVar[str] = "broadcast_join_build_hash_map"
    child: PlanNode = None  # type: ignore[assignment]
    keys: Tuple[Expr, ...] = ()
    cache_id: str = ""


@register
@dataclass(frozen=True)
class BroadcastJoin(PlanNode):
    kind: ClassVar[str] = "broadcast_join"
    left: PlanNode = None  # type: ignore[assignment]
    right: PlanNode = None  # type: ignore[assignment]
    on: JoinOn = None  # type: ignore[assignment]
    join_type: str = "inner"
    broadcast_side: str = "right"
    cached_build_hash_map_id: str = ""
    existence_output_name: str = "exists"


@register
@dataclass(frozen=True)
class UnionInput(Node):
    """Partition `partition` of `child` feeds partition `out_partition`
    of the union."""
    kind: ClassVar[str] = "union_input"
    child: PlanNode = None  # type: ignore[assignment]
    partition: int = 0
    out_partition: int = 0


@register
@dataclass(frozen=True)
class Union(PlanNode):
    kind: ClassVar[str] = "union"
    inputs: Tuple[UnionInput, ...] = ()
    schema: Schema = None  # type: ignore[assignment]
    num_partitions: int = 1
    cur_partition: int = 0


@register
@dataclass(frozen=True)
class RssShuffleWriter(PlanNode):
    """Pushes the child's rows, grouped by partition, to a writer
    registered under `rss_resource_id`."""
    kind: ClassVar[str] = "rss_shuffle_writer"
    child: PlanNode = None  # type: ignore[assignment]
    partitioning: Partitioning = None  # type: ignore[assignment]
    rss_resource_id: str = ""


@register
@dataclass(frozen=True)
class TaskDefinition(Node):
    """The unit shipped from a front end to the runtime."""
    kind: ClassVar[str] = "task_definition"
    plan: PlanNode = None  # type: ignore[assignment]
    stage_id: int = 0
    partition_id: int = 0
    num_partitions: int = 1
    host_threads: int = 0     # 0 = config default

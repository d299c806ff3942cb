"""The session entry (counterpart of auron_tpu/frontend/session.py).

`AuronSession.execute(plan)` runs a foreign plan (frontend/foreign.py),
as the JAX package's `execute` does: it tags the plan
(frontend/strategy.py), converts what the tags mark native
(frontend/converters.py), checks the converted root against the stage
executor's kind-level rules (`precheck_plan`) before any source is
made, builds each source, and runs the query through
`execute_converted`.  With `auron.enable` off, the foreign engine runs
the whole plan; a root the strategy left foreign runs on the foreign
engine over its children's tables.

Sources.  A child-less `LocalTableScanExec` becomes a `SourceTable` of
its rows (`SourceTable.from_rows`).  Any other source (a section the
strategy left foreign, or a scan a convert provider claimed) runs on the
session's `ForeignEngine`, children first: a native child runs on the
serial path and reaches the engine as a `SourceTable`.  Without an
engine where one is needed, the session raises.  The port reads no
file: a converted `ParquetScan` or `OrcScan` (no provider claimed it)
raises `NotImplementedError` before anything runs.

`AuronSession.execute_converted` runs an already converted query (its
root plan, a `ConvertContext` of the exchanges, broadcasts and sources
behind its readers, and the sources' tables).  While
`auron.spmd.singleDevice.enable` is on, the query goes first to the
stage executor (parallel/stage.py), one whole-table evaluation on the
device.  Where that raises `SpmdUnsupported`, the session runs the
serial path instead, counts one fallback and keeps the reason: every
stage in dependency order, its tasks in partition order through
`runtime/executor.py::execute_plan`, an exchange's map tasks writing
into the session's `InProcessShuffleService` and its reduce side read
back as `PartitionedBlocks`, a broadcast's rows collected once and read
by every task of the stage that reads it.  Each exchange and broadcast
is materialized once per execute, and every exchange's blocks are
dropped when the query ends.

`SessionResult.all_native()` is true when no section of the plan runs
on the foreign engine, counted as the JAX package counts them: a local
table's rows are data, not a section, and every other source is one,
a scan that a convert provider hands to the engine
(`converters.ScanSourceProvider`) included.

Not in the port: query ids, tracing spans and query records, query
statistics and plan signatures, adaptive execution, the durable
shuffle side-car and result streaming.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple

import numpy as np

from auron_tpu_torch import resolve_device
from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend import converters, strategy
from auron_tpu_torch.frontend.converters import (
    ConvertContext, ConvertedT, ForeignSource, ForeignWrap, stage_nodes,
)
from auron_tpu_torch.frontend.foreign import ForeignNode
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.schema import Schema
from auron_tpu_torch.ops.scan.ipc import SourceTable
from auron_tpu_torch.ops.shuffle.writer import (
    InProcessShuffleService, PartitionedBlocks,
)
from auron_tpu_torch.parallel.stage import (
    SpmdUnsupported, execute_plan_stage, precheck_plan,
)
from auron_tpu_torch.runtime.executor import ExecutionResult, execute_plan
from auron_tpu_torch.runtime.planner import PhysicalPlanner
from auron_tpu_torch.runtime.resources import ResourceRegistry


class ForeignEngine(Protocol):
    """The host engine that runs the plan sections left foreign (Spark's
    role in Auron): a node and its children's tables in, its table out,
    each a `SourceTable` (one item list a partition)."""

    def execute(self, node: ForeignNode, child_tables: List[SourceTable]
                ) -> SourceTable:
        ...


@dataclass
class SessionResult:
    """A query's result columns on the host ({name: (data, validity)}, a
    string column as an object array), which path ran it, and why the
    stage executor declined it.  `metrics`: num_fallbacks; on the stage
    path host_syncs, bytes_uploaded, source_cache_hits, gathered_rows;
    on the serial path serial_tasks.  Through `execute`: the converted
    tree, the strategy's tags, the `ConvertContext`, the count of
    foreign sections and the host seconds that tagging and conversion
    took (`convert_s`)."""
    schema: Schema
    columns: Dict[str, Tuple[np.ndarray, np.ndarray]]
    spmd: bool = False
    spmd_rejection: Optional[str] = None
    metrics: Dict[str, int] = field(default_factory=dict)
    wall_s: float = 0.0
    converted: Optional[ConvertedT] = None
    tags: Optional[strategy.Tags] = None
    ctx: Optional[ConvertContext] = None
    foreign_sections: int = 0
    convert_s: float = 0.0

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values()))[0])

    def all_native(self) -> bool:
        """True when no section ran on the foreign engine.  A
        foreign-only run (`auron.enable` off) has no converted tree and
        is never all native."""
        return self.converted is not None and \
            not isinstance(self.converted, ForeignWrap) and \
            self.foreign_sections == 0


class _Sources:
    """The tables behind a converted query's FFI readers, each made on
    first use (`AuronSession._source_table`) and kept for the execute."""

    def __init__(self, session: "AuronSession", ctx: ConvertContext, dev):
        self._session, self._ctx, self._dev = session, ctx, dev
        self._made: Dict[str, SourceTable] = {}

    def __contains__(self, rid) -> bool:
        return rid in self._ctx.sources

    def __getitem__(self, rid: str) -> SourceTable:
        if rid not in self._made:
            self._made[rid] = self._session._source_table(
                self._ctx.sources[rid], self._ctx, self, self._dev)
        return self._made[rid]


class AuronSession:
    def __init__(self, foreign_engine: Optional[ForeignEngine] = None,
                 shuffle_service=None):
        self.foreign_engine = foreign_engine
        self.shuffle_service = shuffle_service if shuffle_service \
            is not None else InProcessShuffleService()
        # per execute on the serial path: the exchanges and broadcasts
        # materialized so far, and the tasks run
        self._done: Dict[str, object] = {}
        self._tasks = 0

    # -- a foreign plan -------------------------------------------------------

    def execute(self, plan: ForeignNode, device=None) -> SessionResult:
        """Run a foreign plan on `device` (the card unless the caller asks
        for the CPU)."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        if not conf.get("auron.enable"):
            table = self._run_foreign_only(plan)
            return self._table_result(plan.output, table, {}, t0)
        tags = strategy.apply(plan)
        ctx = ConvertContext()
        converted = converters.convert_recursively(plan, tags, ctx)
        convert_s = time.perf_counter() - t0
        _refuse_file_scans(converted, ctx)
        sources = _Sources(self, ctx, dev)
        if isinstance(converted, P.PlanNode):
            res = self._execute(converted, ctx, sources, dev, t0)
        else:
            self._done, self._tasks = {}, 0
            try:
                table = self._run_converted(converted, ctx, sources, dev)
            finally:
                self._clear(ctx)
            res = self._table_result(plan.output, table,
                                     {"num_fallbacks": 0,
                                      "serial_tasks": self._tasks}, t0)
        res.converted, res.tags, res.ctx = converted, tags, ctx
        res.convert_s = convert_s
        res.foreign_sections = sum(
            1 for s in ctx.sources.values()
            if s.node.children or s.node.node.op != "LocalTableScanExec")
        return res

    def _run_foreign_only(self, node: ForeignNode) -> SourceTable:
        engine = self._require_engine()
        return engine.execute(node, [self._run_foreign_only(c)
                                     for c in node.children])

    def _require_engine(self) -> ForeignEngine:
        if self.foreign_engine is None:
            raise RuntimeError(
                "plan has non-native sections but no foreign engine is "
                "attached to this AuronSession")
        return self.foreign_engine

    def _run_converted(self, c: ConvertedT, ctx: ConvertContext, sources,
                       dev) -> SourceTable:
        """A converted subtree's table: a foreign section on the engine
        over its children's tables, a native one on the serial path."""
        if isinstance(c, ForeignWrap):
            engine = self._require_engine()
            child_tables = [self._run_converted(ch, ctx, sources, dev)
                            for ch in c.children]
            return engine.execute(c.node, child_tables)
        out = self._run_native(c, ctx, sources, dev)
        cols = out.to_numpy()
        names = [f.name for f in out.schema]
        return SourceTable.from_columns([cols[n][0] for n in names],
                                        [cols[n][1] for n in names])

    def _source_table(self, src: ForeignSource, ctx: ConvertContext,
                      sources, dev) -> SourceTable:
        if src.node is None:
            raise KeyError(f"no table for the source {src.rid!r}")
        node = src.node.node
        if not src.node.children and node.op == "LocalTableScanExec":
            return SourceTable.from_rows(node.attrs.get("rows", []),
                                         node.output)
        return self._run_converted(src.node, ctx, sources, dev)

    @staticmethod
    def _table_result(schema: Schema, table: SourceTable, metrics,
                      t0: float) -> SessionResult:
        arrays, validities = table.columns(len(schema))
        cols = {f.name: (np.asarray(a), np.ones(len(a), bool) if v is None
                         else np.asarray(v, bool))
                for f, a, v in zip(schema.fields, arrays, validities)}
        return SessionResult(schema, cols, False, None, metrics,
                             time.perf_counter() - t0)

    # -- a converted query ----------------------------------------------------

    def execute_converted(self, plan: P.PlanNode, ctx: ConvertContext,
                          sources: Dict[str, object],
                          device=None) -> SessionResult:
        """Run a converted query on `device` (the card unless the caller
        asks for the CPU).  `sources` maps each FFI reader's resource id
        to its table, an `ops.scan.ipc.SourceTable`."""
        dev = resolve_device(device)
        return self._execute(plan, ctx, sources, dev, time.perf_counter())

    def _execute(self, plan: P.PlanNode, ctx: ConvertContext, sources,
                 dev, t0: float) -> SessionResult:
        metrics = {"num_fallbacks": 0}
        rejection = None
        stage = bool(conf.get("auron.spmd.singleDevice.enable"))
        self._done, self._tasks = {}, 0
        try:
            if stage:
                try:
                    # the kind-level check comes before any source is made
                    precheck_plan(plan, ctx)
                    out = execute_plan_stage(plan, ctx, sources, dev)
                    metrics.update(out.metrics)
                    return self._result(out, True, None, metrics, t0)
                except SpmdUnsupported as e:
                    # the serial path below is the recovery
                    metrics["num_fallbacks"] = 1
                    rejection = str(e)
            out = self._run_native(plan, ctx, sources, dev)
        finally:
            self._clear(ctx)
        metrics["serial_tasks"] = self._tasks
        return self._result(out, False, rejection, metrics, t0)

    def _clear(self, ctx: ConvertContext) -> None:
        for rid in ctx.exchanges:
            self.shuffle_service.clear(rid)
        self._done = {}

    @staticmethod
    def _result(out: ExecutionResult, spmd: bool, rejection, metrics,
                t0: float) -> SessionResult:
        cols = out.to_numpy()
        return SessionResult(out.schema, cols, spmd, rejection, metrics,
                             time.perf_counter() - t0)

    # -- the serial path ------------------------------------------------------

    def _run_native(self, plan: P.PlanNode, ctx: ConvertContext,
                    sources, dev) -> ExecutionResult:
        """Every task of one stage, in partition order, over its
        materialized dependencies (one registry the tasks share)."""
        resources = self._materialize_deps(plan, ctx, sources, dev)
        n_parts = ctx.parts(plan)
        batches = []
        schema = None
        for pid in range(n_parts):
            res = execute_plan(plan, partition_id=pid,
                               num_partitions=n_parts, resources=resources,
                               device=dev)
            self._tasks += 1
            batches.extend(res.batches)
            schema = res.schema
        if schema is None:
            schema = PhysicalPlanner().create_plan(plan).schema
        return ExecutionResult(batches, schema)

    def _materialize_deps(self, plan: P.PlanNode, ctx: ConvertContext,
                          sources, dev) -> ResourceRegistry:
        resources = ResourceRegistry()
        rids = [n.resource_id for n in stage_nodes(plan)
                if n.kind in ("ipc_reader", "ffi_reader")]
        for rid in dict.fromkeys(rids):
            if rid in ctx.broadcasts or rid in ctx.exchanges:
                if rid not in self._done:
                    self._done[rid] = self._broadcast(
                        ctx.broadcasts[rid], ctx, sources, dev) \
                        if rid in ctx.broadcasts else self._exchange(
                            ctx.exchanges[rid], ctx, sources, dev)
                resources.put(rid, self._done[rid])
            elif rid in sources:
                resources.put(rid, sources[rid])
        return resources

    def _broadcast(self, job, ctx: ConvertContext, sources, dev) -> list:
        """Every partition of the build side, its batches in order."""
        return self._run_native(job.child, ctx, sources, dev).batches

    def _exchange(self, job, ctx: ConvertContext, sources,
                  dev) -> PartitionedBlocks:
        """The map side through RssShuffleWriter into the shuffle
        service, then the reduce side's blocks per partition."""
        svc = self.shuffle_service
        map_deps = self._materialize_deps(job.child, ctx, sources, dev)
        map_parts = ctx.parts(job.child)
        for map_pid in range(map_parts):
            writer_rid = f"{job.rid}:writer:{map_pid}"
            map_deps.put(writer_rid, svc.rss_writer(job.rid, map_pid))
            writer = P.RssShuffleWriter(child=job.child,
                                        partitioning=job.partitioning,
                                        rss_resource_id=writer_rid)
            execute_plan(writer, partition_id=map_pid,
                         num_partitions=map_parts, resources=map_deps,
                         device=dev)
            self._tasks += 1
        blocks: List[list] = [svc.reduce_blocks(job.rid, p) for p in
                              range(job.partitioning.num_partitions)]
        return PartitionedBlocks(blocks)


def _refuse_file_scans(converted: ConvertedT, ctx: ConvertContext) -> None:
    """Raise, before anything runs, where a converted stage holds a file
    scan: the port reads no file."""
    roots, wraps = [], [converted]
    wraps += [s.node for s in ctx.sources.values() if s.node is not None]
    while wraps:
        c = wraps.pop()
        if isinstance(c, ForeignWrap):
            wraps.extend(c.children)
        else:
            roots.append(c)
    roots += [j.child for j in ctx.exchanges.values()]
    roots += [j.child for j in ctx.broadcasts.values()]
    for root in roots:
        for n in stage_nodes(root):
            if n.kind in ("parquet_scan", "orc_scan"):
                raise NotImplementedError(P.SCANS_NOT_PORTED)

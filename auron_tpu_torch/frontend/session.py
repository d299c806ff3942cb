"""The session entry (counterpart of auron_tpu/frontend/session.py, the
part of `AuronSession._execute_impl` that follows conversion).

`AuronSession.execute_converted` runs a converted query (its root plan,
a `ConvertContext` of the exchanges, broadcasts and sources behind its
readers, and the sources' tables).  While
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

Not in the port: adaptive execution, the durable shuffle side-car,
query statistics and records, result streaming and the foreign engine
(the JAX package's `execute` of a foreign plan, whose converter the
port does not have yet).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from auron_tpu_torch import resolve_device
from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend.converters import ConvertContext, stage_nodes
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.schema import Schema
from auron_tpu_torch.ops.shuffle.writer import (
    InProcessShuffleService, PartitionedBlocks,
)
from auron_tpu_torch.parallel.stage import (
    SpmdUnsupported, execute_plan_stage, precheck_plan,
)
from auron_tpu_torch.runtime.executor import ExecutionResult, execute_plan
from auron_tpu_torch.runtime.planner import PhysicalPlanner
from auron_tpu_torch.runtime.resources import ResourceRegistry


@dataclass
class SessionResult:
    """A query's result columns on the host ({name: (data, validity)}, a
    string column as an object array), which path ran it, and why the
    stage executor declined it.  `metrics`: num_fallbacks; on the stage
    path host_syncs, bytes_uploaded, source_cache_hits, gathered_rows;
    on the serial path serial_tasks."""
    schema: Schema
    columns: Dict[str, Tuple[np.ndarray, np.ndarray]]
    spmd: bool = False
    spmd_rejection: Optional[str] = None
    metrics: Dict[str, int] = field(default_factory=dict)
    wall_s: float = 0.0

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values()))[0])


class AuronSession:
    def __init__(self, shuffle_service=None):
        self.shuffle_service = shuffle_service if shuffle_service \
            is not None else InProcessShuffleService()
        # per execute on the serial path: the exchanges and broadcasts
        # materialized so far, and the tasks run
        self._done: Dict[str, object] = {}
        self._tasks = 0

    def execute_converted(self, plan: P.PlanNode, ctx: ConvertContext,
                          sources: Dict[str, object],
                          device=None) -> SessionResult:
        """Run a converted query on `device` (the card unless the caller
        asks for the CPU).  `sources` maps each FFI reader's resource id
        to its table, an `ops.scan.ipc.SourceTable`."""
        dev = resolve_device(device)
        t0 = time.perf_counter()
        metrics = {"num_fallbacks": 0}
        rejection = None
        if bool(conf.get("auron.spmd.singleDevice.enable")):
            try:
                precheck_plan(plan, ctx)
                out = execute_plan_stage(plan, ctx, sources, dev)
                metrics.update(out.metrics)
                return self._result(out, True, None, metrics, t0)
            except SpmdUnsupported as e:
                # the serial path below is the recovery
                metrics["num_fallbacks"] = 1
                rejection = str(e)
        self._done, self._tasks = {}, 0
        try:
            out = self._run_native(plan, ctx, sources, dev)
        finally:
            for rid in ctx.exchanges:
                self.shuffle_service.clear(rid)
            self._done = {}
        metrics["serial_tasks"] = self._tasks
        return self._result(out, False, rejection, metrics, t0)

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

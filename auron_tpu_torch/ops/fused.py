"""FusedFragmentExec: one operator running a fused row-local chain
(counterpart of auron_tpu/ops/fused.py).

The planner lowers a FusedFragment plan node (runtime/fusion.py) to this
operator.  Where the JAX package traces a fragment into one jitted
program, this one makes one pass over each batch, stage by stage, with
no intermediate Batch and one compaction at the end:

- a bool live mask is carried; each filter ANDs its predicate into it;
- projections and expand lanes evaluate over every row of the input
  batch, the dead ones included (the expression kernels neither raise,
  nor read the device back, nor count on a row's value: a division by
  zero is null, a cast out of range saturates or is null), which is
  value-identical on the rows that survive;
- `limit` takes its per-batch window from the mask's running rank, with
  the skip and remaining counters on the host (one read of two counts a
  batch where a filter came before it; none where none did);
- `rename_columns` changes only the schema, `coalesce_batches` becomes
  the output staging (CoalesceBatchesExec's rule);
- the expand lanes are concatenated (ExpandExec's one batch an input
  batch), then one terminal compaction (`compact_indices`, the one host
  read) and one gather per output column.  A fragment with no filter and
  no limit compacts nothing and reads nothing back.  A batch that keeps
  no row is dropped, as FilterExec drops it.

Two consumers splice into a fragment (the JAX package's compositions):
- pid fusion: a shuffle writer over the fragment calls
  `enable_pid_fusion`; the fragment then computes the partition ids of
  its output rows through the port's `PartitionIdComputer` (so a single
  int64, timestamp or decimal key launches the hash-pid kernel, fused or
  not) before the terminal compaction, and the one gather carries the
  `PID_FIELD` column too; the writer pops it;
- the partial-aggregation prologue: AggExec takes a composable fragment
  (one lane, no limit) apart with `apply_stages` and groups the
  fragment's uncompacted columns under its live mask, so the fragment's
  own compaction goes away.

The metrics carry the JAX package's names: `ops_fused`, `fused_batches`
(a batch out, or a batch in under the prologue), `pid_fused_batches`
and, on a fragment spliced into an AggExec, `fused_into_parent`.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from auron_tpu_torch.analysis.fusion import body_chain
from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceColumn, bucket_capacity, concat_batches,
    concat_device_columns,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs.compiler import build_evaluator, build_predicate
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.ops.base import Operator, TaskContext, compact_indices
from auron_tpu_torch.ops.basic import _conform

# the column a pid-fused fragment appends (ops/shuffle/writer.py pops it)
PID_FIELD = "__auron_pid__"

Lane = Tuple[List[Column], Optional[torch.Tensor]]


class _Stage:
    """One body operator: its kind, node, schemas and evaluators (the
    operator constructors' rules, so that fused and unfused trees agree
    on every schema)."""

    def __init__(self, node: P.PlanNode, in_schema: Schema):
        self.kind = node.kind
        self.node = node
        self.in_schema = in_schema
        self.evals = []
        self.types: Tuple[DataType, ...] = ()
        out = in_schema
        if self.kind == "projection":
            ev = build_evaluator(node.exprs, in_schema)
            self.evals = [ev]
            out = Schema(tuple(Field(n, t) for n, t in
                               zip(node.names, ev.out_types)))
        elif self.kind == "filter":
            self.evals = [build_predicate(node.predicates, in_schema)]
        elif self.kind == "expand":
            self.evals = [build_evaluator(p, in_schema)
                          for p in node.projections]
            self.types = tuple(node.types) if node.types \
                else tuple(self.evals[0].out_types)
            out = Schema(tuple(Field(n, t) for n, t in
                               zip(node.names, self.types)))
        elif self.kind == "rename_columns":
            out = in_schema.rename(tuple(node.names))
        self.out_schema = out


class FusedFragmentExec(Operator):
    def __init__(self, child: Operator, node: P.FusedFragment):
        chain, err = body_chain(node.body)
        if err is not None or not chain:
            raise RuntimeError(f"malformed fused fragment: {err}")
        self.stages: List[_Stage] = []
        schema = child.schema
        for op in chain:
            st = _Stage(op, schema)
            self.stages.append(st)
            schema = st.out_schema
        super().__init__(schema, [child])
        self._limits = [s for s in self.stages if s.kind == "limit"]
        coalesces = [s for s in self.stages
                     if s.kind == "coalesce_batches"]
        # 0: no output staging
        self._target = (coalesces[-1].node.target_batch_size or
                        int(conf.get("auron.batch.size"))) \
            if coalesces else 0
        self._has_expand = any(s.kind == "expand" for s in self.stages)
        self._pid = None
        self._pid_schema: Optional[Schema] = None
        self.metrics.set("ops_fused", len(self.stages))

    # -- pid fusion (ops/shuffle/writer.py) --------------------------------

    def enable_pid_fusion(self, partitioning: P.Partitioning) -> bool:
        """Compute `partitioning`'s partition ids inside the fragment:
        its output batches carry one more int32 column, PID_FIELD.  Hash
        and range modes only (single is a constant, round robin a host
        row offset); False where a key cannot run inside the fragment,
        and the writer keeps its own computer."""
        if self._pid is not None:
            return True
        if partitioning.mode == "hash":
            exprs = tuple(partitioning.expressions)
        elif partitioning.mode == "range":
            exprs = tuple(s.child for s in partitioning.sort_orders)
        else:
            return False
        from auron_tpu_torch.runtime.fusion import exprs_fusable
        if exprs_fusable(exprs, self.schema) is not None:
            return False
        from auron_tpu_torch.ops.shuffle.partitioner import (
            PartitionIdComputer,
        )
        self._pid = PartitionIdComputer(partitioning, self.schema)
        self._pid_schema = Schema(self.schema.fields + (
            Field(PID_FIELD, DataType.int32(), False),))
        return True

    def _out_schema(self) -> Schema:
        return self._pid_schema or self.schema

    # -- the stages --------------------------------------------------------

    @staticmethod
    def _live(n: int, cap: int, dev) -> torch.Tensor:
        return torch.arange(cap, device=dev) < n

    def _run_stages(self, b: Batch, skip: List[int],
                    remaining: List[int]) -> List[Lane]:
        """The stages over one input batch: its lanes as (columns, live
        mask), the mask None while every row below num_rows lives."""
        n, cap, dev = b.num_rows, b.capacity, b.device
        lanes: List[Lane] = [(b.columns, None)]
        li = 0
        for st in self.stages:
            k = st.kind
            if k == "projection":
                lanes = [(st.evals[0](Batch(st.in_schema, cols, n, cap)), m)
                         for cols, m in lanes]
            elif k == "filter":
                nxt = []
                for cols, m in lanes:
                    [p] = st.evals[0](Batch(st.in_schema, cols, n, cap))
                    keep = p.validity & (p.data != 0)
                    nxt.append((cols, keep & (m if m is not None
                                              else self._live(n, cap, dev))))
                lanes = nxt
            elif k == "expand":
                lanes = [([_conform(c, t) for c, t in zip(
                    ev(Batch(st.in_schema, cols, n, cap)), st.types)], m)
                    for cols, m in lanes for ev in st.evals]
            elif k == "limit":
                (cols, m), = lanes        # the rewrite keeps limits one-lane
                lanes = [(cols, self._limit(m, n, cap, dev, li, skip,
                                            remaining))]
                li += 1
        return lanes

    def _limit(self, m: Optional[torch.Tensor], n: int, cap: int, dev,
               li: int, skip: List[int], remaining: List[int]
               ) -> torch.Tensor:
        """The limit's window over the live rows by their running rank;
        advances its counters on the host."""
        sk, rem = skip[li], remaining[li]
        if m is None:
            # every row below n lives: the window is known on the host
            lo, hi = min(sk, n), min(sk + rem, n)
            r = torch.arange(cap, device=dev)
            skip[li] -= lo
            remaining[li] -= hi - lo
            return (r >= lo) & (r < hi)
        rank = torch.cumsum(m, 0) - 1
        keep = m & (rank >= sk) & (rank < sk + rem)
        live_before, kept = torch.stack([m.sum(), keep.sum()]).tolist()
        skip[li] -= min(live_before, sk)
        remaining[li] -= kept
        return keep

    def _run_batch(self, b: Batch, skip: List[int],
                   remaining: List[int]) -> Optional[Batch]:
        """One input batch through the stages, the lanes concatenated and
        compacted once; None where no row is kept."""
        lanes = self._run_stages(b, skip, remaining)
        n, cap, dev = b.num_rows, b.capacity, b.device
        if all(m is None for _, m in lanes):
            if len(lanes) == 1:
                cols, rows, out_cap = lanes[0][0], n, cap
            else:
                # the lanes' live rows, one after another (ExpandExec)
                out = concat_batches(self.schema, [
                    Batch(self.schema, cols, n, cap) for cols, _ in lanes])
                cols, rows, out_cap = out.columns, out.num_rows, out.capacity
            if self._pid is not None:
                ids = self._pids(cols, rows, out_cap)
                cols = cols + [DeviceColumn(
                    DataType.int32(), _pad(ids, out_cap),
                    self._live(rows, out_cap, dev))]
            return Batch(self._out_schema(), list(cols), rows, out_cap)
        if len(lanes) == 1:
            (cols, m), = lanes
            span = n
        else:
            cols = [concat_device_columns([lc[i] for lc, _ in lanes])
                    for i in range(len(self.schema))]
            m = torch.cat([lm if lm is not None else self._live(n, cap, dev)
                           for _, lm in lanes])
            span = m.shape[0]
        idx, count = compact_indices(m)
        if count == 0:
            return None
        if self._pid is not None:
            # the ids of every row before the compaction, so that the one
            # gather carries them too
            ids = self._pids(cols, span, m.shape[0])
            cols = list(cols) + [DeviceColumn(
                DataType.int32(), _pad(ids, m.shape[0]), m)]
        out_cap = bucket_capacity(count)
        idx = torch.nn.functional.pad(idx, (0, out_cap - count))
        valid = self._live(count, out_cap, dev)
        return Batch(self._out_schema(), [c.gather(idx, valid) for c in cols],
                     count, out_cap)

    def _pids(self, cols: List[Column], rows: int, cap: int
              ) -> torch.Tensor:
        """int32[rows]: the partition ids of the first `rows` rows."""
        return self._pid(Batch(self.schema, list(cols), rows, cap))

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        skip = [s.node.offset for s in self._limits]
        remaining = [s.node.limit for s in self._limits]
        target = self._target
        out_schema = self._out_schema()
        staged: List[Batch] = []
        staged_rows = 0
        for b in self.child_stream(ctx):
            if b.num_rows == 0:
                continue
            if self._limits and remaining[-1] <= 0:
                break
            ob = self._run_batch(b, skip, remaining)
            if ob is None:
                continue
            self.count("fused_batches")
            if self._pid is not None:
                self.count("pid_fused_batches")
            if not target or (ob.num_rows >= target and not staged):
                yield ob
                continue
            staged.append(ob)
            staged_rows += ob.num_rows
            if staged_rows >= target:
                yield concat_batches(out_schema, staged)
                staged, staged_rows = [], 0
        if staged:
            yield concat_batches(out_schema, staged)

    # -- the prologue surface (ops/agg/exec.py) ------------------------------

    def composable(self) -> bool:
        """Can a consumer take this fragment's stages into its own pass?
        One lane (no expand) and no limit window; coalesce stages are
        only batching and drop out."""
        return not self._has_expand and not self._limits

    def apply_stages(self, b: Batch) -> Lane:
        """The stages over one input batch, uncompacted: (columns of
        `self.schema` at the batch's capacity, live mask or None)."""
        (cols, m), = self._run_stages(b, [], [])
        return cols, m


def _pad(t: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, cap - t.shape[0]))

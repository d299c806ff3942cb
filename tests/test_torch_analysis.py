"""The port's plan verifier (auron_tpu_torch/analysis) against the JAX
package's (auron_tpu/analysis).

The same plan JSON goes through both engines' `analyze`: the (pass id,
severity, node path) triples are equal over
- the cases of tests/test_analysis.py and tests/test_fusion.py whose
  kinds the port has, the malformed ones included (a ShuffleWriter
  there is an RssShuffleWriter here, a BoundReference a column);
- the committed golden plans (tests/golden_plans/*.json) that the port
  deserializes;
- every task the serial q01, q03, q65w, q27r, q74y and q39v execute at
  SF 0.01, unfused and fused.
The only differences allowed are the JAX package's TPU lints, which
describe a TPU: the (8, 128) tile and lane warnings on a
`coalesce_batches` target and the float64 hash-key info (`TPU_ONLY`).
`verify` raises PlanVerificationError in both engines on the same
plans; `verify_task` caches per plan object and logs through the task
scope; the executor's gate (`auron.plan.verify`) refuses a malformed
plan with node paths before anything runs.
"""

import json
import logging
import os

import pytest

from auron_tpu import analysis as janalysis
from auron_tpu.ir import plan as JP
from auron_tpu.ir.expr import (
    AggExpr, BinaryExpr, IsNotNull, SortExpr, col, lit,
)
from auron_tpu.ir.node import Node as JNode
from auron_tpu.ir.schema import DataType, Field, Schema
from auron_tpu.runtime import fusion as jfusion
from auron_tpu_torch import analysis as panalysis
from auron_tpu_torch.config import conf
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.node import Node
from auron_tpu_torch.runtime import fusion as pfusion
from auron_tpu_torch.runtime import task_logging
from auron_tpu_torch.runtime.executor import execute_plan
from auron_tpu_torch.runtime.resources import ResourceRegistry

import torch_parity as TP

I64, F64, I32, STR = DataType.int64(), DataType.float64(), \
    DataType.int32(), DataType.string()
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_plans")


def base_schema() -> Schema:
    return Schema.of(Field("k", I64, nullable=False),
                     Field("v", F64), Field("s", STR))


def scan(schema=None):
    return JP.ParquetScan(
        schema=schema or base_schema(),
        file_groups=(JP.FileGroup(paths=("/data/t.parquet",)),))


def reader(schema=None, rid="x"):
    return JP.IpcReader(schema=schema or base_schema(), resource_id=rid)


def writer(child, part):
    return JP.RssShuffleWriter(child=child, partitioning=part,
                               rss_resource_id="w")


def _avg(name="avg_v", mode="partial", child=None, grouping=("s",)):
    return JP.Agg(child=child if child is not None else scan(),
                  exec_mode=mode,
                  grouping=tuple(col(g) for g in grouping),
                  grouping_names=grouping,
                  aggs=(AggExpr(fn="avg", children=(col("v"),),
                                return_type=F64),),
                  agg_names=(name,))


def _sum(mode, child):
    return JP.Agg(child=child, exec_mode=mode, grouping=(col("s"),),
                  grouping_names=("s",),
                  aggs=(AggExpr(fn="sum", children=(col("v"),),
                                return_type=F64),),
                  agg_names=("sum_v",))


def _valid_two_phase():
    partial = _avg(child=JP.Filter(child=scan(), predicates=(
        BinaryExpr(left=col("k"), op=">", right=lit(5)),)))
    return JP.TaskDefinition(
        plan=writer(partial, JP.Partitioning(
            mode="hash", num_partitions=4, expressions=(col("s"),))),
        stage_id=1, partition_id=0, num_partitions=2)


def _bhj(cache_id="c1", build_id="c1", build_keys=(col("k"),),
         join_type="inner", side="right"):
    build = JP.BroadcastJoinBuildHashMap(child=reader(rid="b"),
                                         keys=build_keys, cache_id=build_id)
    probe = scan()
    left, right = (probe, build) if side == "right" else (build, probe)
    return JP.BroadcastJoin(
        left=left, right=right,
        on=JP.JoinOn(left_keys=(col("k"),), right_keys=(col("k"),)),
        join_type=join_type, broadcast_side=side,
        cached_build_hash_map_id=cache_id)


def _fused(body, child=None, schema=None):
    return JP.FusedFragment(child=child or scan(), body=body,
                            schema=schema or base_schema())


def _fragment_input(schema=None):
    return JP.FragmentInput(schema=schema or base_schema())


CASES = {
    "valid_two_phase": _valid_two_phase(),
    "projection_arity": JP.Projection(child=scan(), exprs=(col("k"),),
                                      names=("a", "b")),
    "filter_not_boolean": JP.Filter(child=scan(), predicates=(col("v"),)),
    "union_dtype": JP.Union(
        schema=Schema.of(Field("k", I64), Field("v", F64)),
        num_partitions=1, inputs=(JP.UnionInput(
            child=JP.EmptyPartitions(schema=Schema.of(Field("k", STR),
                                                      Field("v", F64))),
            partition=0, out_partition=0),)),
    "union_nullable_into_required": JP.Union(
        schema=Schema.of(Field("k", I64, nullable=False), Field("v", F64)),
        num_partitions=1, inputs=(JP.UnionInput(
            child=JP.EmptyPartitions(schema=Schema.of(Field("k", I64),
                                                      Field("v", F64))),
            partition=0, out_partition=0),)),
    "rename_arity": JP.RenameColumns(child=scan(), names=("only_one",)),
    "leaf_without_schema": JP.IpcReader(schema=None, resource_id="x"),
    "unknown_column": JP.Filter(child=scan(), predicates=(
        BinaryExpr(left=col("nope"), op=">", right=lit(1)),)),
    "scan_projection_index": JP.ParquetScan(
        schema=base_schema(), file_groups=(JP.FileGroup(paths=("/t",)),),
        projection=(0, 9)),
    "join_keys_per_side": JP.HashJoin(
        left=scan(Schema.of(Field("lk", I64))),
        right=scan(Schema.of(Field("rk", I64))),
        on=JP.JoinOn(left_keys=(col("lk"),), right_keys=(col("lk"),))),
    "single_with_many_partitions": writer(scan(), JP.Partitioning(
        mode="single", num_partitions=4)),
    "hash_without_keys": writer(scan(), JP.Partitioning(
        mode="hash", num_partitions=4)),
    "range_without_orders": writer(scan(), JP.Partitioning(
        mode="range", num_partitions=4)),
    "unknown_partitioning_mode": writer(scan(), JP.Partitioning(
        mode="spray", num_partitions=4)),
    "union_mapping": JP.Union(
        schema=base_schema(), num_partitions=2,
        inputs=(JP.UnionInput(child=scan(), partition=0, out_partition=5),)),
    "smj_sort_options": JP.SortMergeJoin(
        left=scan(), right=scan(),
        on=JP.JoinOn(left_keys=(col("k"),), right_keys=(col("k"),)),
        sort_options=((True, True), (False, False))),
    "join_key_arity": JP.HashJoin(
        left=scan(), right=scan(),
        on=JP.JoinOn(left_keys=(col("k"), col("v")),
                     right_keys=(col("k"),))),
    "join_key_types": JP.SortMergeJoin(
        left=scan(), right=scan(),
        on=JP.JoinOn(left_keys=(col("s"),), right_keys=(col("k"),))),
    "final_over_final": _sum("final", _sum("final", scan())),
    "partial_over_partial": _sum("partial", _sum("partial", scan())),
    "final_state_arity": _avg(mode="final", child=reader(Schema.of(
        Field("s", STR), Field("avg_v#sum", F64)))),
    "final_state_layout_ok": _avg(mode="final", child=reader(Schema.of(
        Field("s", STR), Field("avg_v#sum", F64),
        Field("avg_v#count", I64, nullable=False)))),
    "unknown_agg_mode": _sum("merge", scan()),
    "task_partition_range": JP.TaskDefinition(plan=scan(), partition_id=7,
                                              num_partitions=2),
    "host_resident_sort_key": JP.Sort(
        child=scan(Schema.of(Field("k", I64),
                             Field("tags", DataType.list_(STR)))),
        sort_exprs=(SortExpr(child=col("tags")),)),
    "host_resident_hash_key": writer(
        scan(Schema.of(Field("k", I64), Field("d", DataType.decimal(30, 2)))),
        JP.Partitioning(mode="hash", num_partitions=4,
                        expressions=(col("d"),))),
    "float64_hash_key": writer(scan(), JP.Partitioning(
        mode="hash", num_partitions=4, expressions=(col("v"), col("k")))),
    "tiny_coalesce": JP.CoalesceBatches(child=scan(), target_batch_size=100),
    "lane_misaligned_coalesce": JP.CoalesceBatches(child=scan(),
                                                   target_batch_size=8200),
    "window": JP.Window(
        child=scan(), window_funcs=(JP.WindowFuncCall(
            fn="rank", name="rk", return_type=I32),),
        partition_by=(col("s"),), order_by=(SortExpr(child=col("nope")),)),
    "expand_arity": JP.Expand(child=scan(), projections=(
        (col("k"), col("v")), (col("k"),)), names=("a", "b")),
    "bhj_ok": _bhj(),
    "bhj_cache_id_mismatch": _bhj(build_id="c2"),
    "bhj_no_build_keys": _bhj(build_keys=()),
    "bhj_unsafe_side": _bhj(join_type="full"),
    "fragment_ok": _fused(JP.Filter(
        child=JP.Projection(child=_fragment_input(),
                            exprs=(col("k"), col("v"), col("s")),
                            names=("k", "v", "s")),
        predicates=(BinaryExpr(left=col("v"), op=">", right=lit(0.0)),))),
    "fragment_with_a_sort": _fused(JP.Sort(
        child=_fragment_input(), sort_exprs=(SortExpr(child=col("k")),))),
    "fragment_schema_disagrees": _fused(JP.Filter(
        child=_fragment_input(Schema.of(Field("other", I64))),
        predicates=(IsNotNull(child=col("other")),))),
    "fragment_nullable_input": _fused(
        JP.Limit(child=_fragment_input(Schema.of(
            Field("k", I64, nullable=False), Field("v", F64, nullable=False),
            Field("s", STR))), limit=3)),
    "fragment_empty_body": _fused(_fragment_input()),
    "fragment_declared_schema": _fused(
        JP.Projection(child=_fragment_input(), exprs=(col("k"),),
                      names=("k",))),
}
MALFORMED = {k for k in CASES
             if k not in ("valid_two_phase", "final_state_layout_ok",
                          "bhj_ok", "fragment_ok", "union_nullable_into_required",
                          "host_resident_sort_key", "host_resident_hash_key",
                          "float64_hash_key", "tiny_coalesce",
                          "join_key_types",
                          "lane_misaligned_coalesce",
                          "fragment_nullable_input")}


def tpu_only(d) -> bool:
    """The JAX package's TPU lints, which the port does not state."""
    return d.pass_id == "tpu-lint" and (
        d.node_kind == "coalesce_batches" or d.severity == "info")


def triples(res, drop=lambda d: False):
    return sorted((d.pass_id, d.severity, d.path)
                  for d in res.diagnostics if not drop(d))


def to_port(jplan):
    return Node.from_dict(json.loads(json.dumps(jplan.to_dict())))


def to_jax(plan):
    return JNode.from_dict(json.loads(json.dumps(plan.to_dict())))


def assert_same_findings(plan):
    """The port's diagnostics on `plan` against the JAX package's on its
    JSON; returns the port's result."""
    pres = panalysis.analyze(plan)
    jres = janalysis.analyze(to_jax(plan))
    assert triples(pres) == triples(jres, tpu_only), (
        pres.render(), jres.render())
    assert pres.ok == jres.ok
    return pres


@pytest.mark.parametrize("name", sorted(CASES))
def test_findings_match_the_jax_package(name):
    plan = to_port(CASES[name])
    res = assert_same_findings(plan)
    assert (not res.ok) == (name in MALFORMED), res.render()
    if name in MALFORMED:
        with pytest.raises(panalysis.PlanVerificationError) as ei:
            panalysis.verify(plan)
        with pytest.raises(janalysis.PlanVerificationError):
            janalysis.verify(to_jax(plan))
        assert set(ei.value.paths()) == {d.path for d in res.errors}
    else:
        panalysis.verify(plan)


def test_tpu_only_lints_are_the_only_differences():
    """Each of the listed TPU lints fires in the JAX package and not in
    the port, on its case."""
    for name, kind in (("tiny_coalesce", "warning"),
                       ("lane_misaligned_coalesce", "warning"),
                       ("float64_hash_key", "info")):
        plan = to_port(CASES[name])
        j = janalysis.analyze(to_jax(plan))
        assert [d.severity for d in j.diagnostics if tpu_only(d)] == [kind]
        assert not panalysis.analyze(plan).diagnostics


def _golden_plans():
    out = []
    for f in sorted(os.listdir(GOLDEN)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(GOLDEN, f)) as fh:
            doc = json.load(fh)
        for name, plan in sorted(doc.get("plans", {}).items()):
            try:
                out.append((f"{f}:{name}", Node.from_dict(plan)))
            except NotImplementedError:
                continue     # a kind the port has not
    return out


def test_golden_plans_match_the_jax_package():
    plans = _golden_plans()
    assert len(plans) >= 20
    for f, plan in plans:
        res = assert_same_findings(plan)
        assert res.ok, (f, res.render())
        fused = pfusion.fuse_plan(plan)
        assert_same_findings(fused)


@pytest.fixture(scope="module")
def corpus_tasks(tmp_path_factory):
    return TP.serial_tasks(("q01", "q03", "q65w", "q27r", "q74y", "q39v"),
                           sf=0.01,
                           data_dir=str(tmp_path_factory.mktemp("tpcds")))


def test_corpus_tasks_match_the_jax_package(corpus_tasks):
    """Each task, and its fused plan in both engines' rewrites."""
    seen = set()
    for name, task in corpus_tasks:
        if id(task.plan) in seen:
            continue
        seen.add(id(task.plan))
        assert assert_same_findings(task).ok
        fused = pfusion.fuse_plan(task.plan)
        assert fused == to_port(jfusion.fuse_plan(to_jax(task.plan)))
        assert assert_same_findings(
            P.TaskDefinition(plan=fused, partition_id=task.partition_id,
                             num_partitions=task.num_partitions)).ok


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.ERROR)
        self.addFilter(task_logging.TaskContextFilter())
        self.setFormatter(logging.Formatter("%(task)s%(message)s"))
        self.lines = []

    def emit(self, record):
        self.lines.append(self.format(record))


def test_verify_task_caches_per_plan_and_logs_with_the_task_prefix():
    good = to_port(_valid_two_phase())
    assert panalysis.verify_task(good) is not None
    assert panalysis.verify_task(good) is None          # cached
    assert panalysis.verify_task(
        P.TaskDefinition(plan=good.plan)) is None       # same plan object
    bad = P.TaskDefinition(plan=to_port(CASES["unknown_column"]),
                           stage_id=4, partition_id=2, num_partitions=3)
    handler = _Lines()
    log = logging.getLogger("auron_tpu_torch.analysis")
    log.addHandler(handler)
    try:
        with task_logging.task_scope(4, 2):
            with pytest.raises(panalysis.PlanVerificationError) as ei:
                panalysis.verify_task(bad)
    finally:
        log.removeHandler(handler)
    assert ei.value.paths() == ("plan",)
    assert len(handler.lines) == 1
    assert handler.lines[0].startswith("[stage 4 part 2] plan verifier: "
                                       "error[column-resolution] plan ")
    assert "'nope'" in handler.lines[0]
    with pytest.raises(panalysis.PlanVerificationError):
        panalysis.verify_task(bad)                      # never cached


def test_executor_gate():
    """`auron.plan.verify` refuses a malformed plan before its source is
    read; off, the same plan fails where its operator is built."""
    import numpy as np
    bad = P.Projection(child=P.FFIReader(schema=to_port(scan()).schema,
                                         resource_id="src"),
                       exprs=(to_port(JP.Projection(
                           child=scan(), exprs=(col("zz"),),
                           names=("z",))).exprs[0],), names=("z",))
    res = ResourceRegistry()
    res.put("src", [([np.arange(3), np.zeros(3), np.array(["a"] * 3,
                                                          dtype=object)],
                     [np.ones(3, bool)] * 3)])
    with conf.scoped({"auron.plan.verify": True}):
        with pytest.raises(panalysis.PlanVerificationError) as ei:
            execute_plan(bad, resources=res, device="cpu")
    assert ei.value.paths() == ("plan",)
    with conf.scoped({"auron.plan.verify": False}):
        with pytest.raises(KeyError):
            execute_plan(bad, resources=res, device="cpu")

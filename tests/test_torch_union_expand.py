"""Union, Expand, CoalesceBatches, RenameColumns and EmptyPartitions of
auron_tpu_torch against auron_tpu on the CPU, and the serde of every plan
and expression kind this slice adds.

Each plan goes to both engines as the same serialized TaskDefinition
bytes over the same seeded rows; rows are compared exactly (no float is
computed here):
- Union with the converter's flattened assignments (each union input is
  one partition of a child, read by one output partition), task by
  task, and collapsed into a single-partition task that streams every
  assignment;
- Expand into three grouping sets with typed null string literals, the
  copies of an input batch in one batch (a string column at the widest
  of its copies' widths), and Expand under a partial aggregation as
  q27r runs it;
- CoalesceBatches to a target, RenameColumns, EmptyPartitions;
- the JSON of window, window_func_call, window_group_limit, union,
  union_input, expand, rename_columns, coalesce_batches,
  empty_partitions and scalar_function equals the reference's, built in
  either engine, and round-trips through the port's serde.
"""

import io

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.columnar import serde as batch_serde
from auron_tpu.frontend.session import PartitionedBlocks as JaxBlocks
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.runtime.executor import execute_task_bytes as jax_execute
from auron_tpu.runtime.resources import ResourceRegistry as JaxResources
from auron_tpu_torch.columnar.batch import DeviceStringColumn, from_numpy
from auron_tpu_torch.ir import expr as E
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir import serde
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.ops.scan.ipc import arrow_to_numpy
from auron_tpu_torch.ops.shuffle.writer import PartitionedBlocks
from auron_tpu_torch.runtime.executor import execute_task_bytes
from auron_tpu_torch.runtime.planner import PhysicalPlanner
from auron_tpu_torch.runtime.resources import ResourceRegistry

from test_torch_corpus_stages import _Port, out_schema
from test_torch_strings import _random_strings
from torch_parity import one_thread  # noqa: F401  (autouse)

I32, I64, F64, STR = JDT.int32(), JDT.int64(), JDT.float64(), JDT.string()
SRC = JS.of(JF("k", STR), JF("c", STR), JF("q", I32), JF("x", F64))


def _rbs(seed, n=300, size=64):
    """(k, c, q, x) record batches: k short strings, c up to 24 bytes."""
    rng = np.random.default_rng(seed)
    t = pa.Table.from_arrays(
        [pa.array(_random_strings(rng, n, max_len=6), type=pa.string(),
                  mask=rng.random(n) < 0.1),
         pa.array(_random_strings(rng, n, max_len=24), type=pa.string(),
                  mask=rng.random(n) < 0.1),
         pa.array(rng.integers(0, 50, n).astype(np.int32), type=pa.int32()),
         pa.array(np.round(rng.random(n) * 100, 2), type=pa.float64(),
                  mask=rng.random(n) < 0.1)], names=list(SRC.names()))
    return t.to_batches(max_chunksize=size)


def _port_batches(rbs):
    port_schema = serde.from_json(jserde.to_json(
        JP.FFIReader(schema=SRC))).schema
    return [from_numpy(port_schema, *arrow_to_numpy(rb), device="cpu")
            for rb in rbs]


def _jax_bytes(rbs):
    sink = io.BytesIO()
    codec = batch_serde.exchange_codec("local")
    for rb in rbs:
        batch_serde.write_one_batch(rb, sink, codec=codec)
    return sink.getvalue()


def _run(plan, resources, pid=0, n_parts=1):
    """One task through both engines; resources are (id, jax value, port
    value).  Returns (port table, reference table, port result)."""
    data = jserde.serialize(JP.TaskDefinition(
        plan=plan, partition_id=pid, num_partitions=n_parts), codec="zlib")
    jres, res = JaxResources(), ResourceRegistry()
    for rid, jv, pv in resources:
        jres.put(rid, jv)
        res.put(rid, pv)
    port = execute_task_bytes(data, res, device="cpu")
    ref = jax_execute(data, jres)
    schema = out_schema(plan)
    ref_t = pa.Table.from_batches(ref.batches) if ref.batches else \
        pa.Table.from_batches([], schema=_Port.table([port], schema).schema)
    return _Port.table([port], schema), ref_t, port


# -- union -------------------------------------------------------------------

def _union_sources():
    """a: 2 partitions, b: 1 partition, as shuffle blocks in each engine."""
    parts = {"a": [_rbs(1, 120), _rbs(2, 90)], "b": [_rbs(3, 70)]}
    res = [(rid, JaxBlocks([_jax_bytes(p) for p in ps]),
            PartitionedBlocks([_port_batches(p) for p in ps]))
           for rid, ps in parts.items()]
    return parts, res


def _union_plan():
    a = JP.IpcReader(schema=SRC, resource_id="a")
    b = JP.IpcReader(schema=SRC, resource_id="b")
    inputs = (JP.UnionInput(child=a, partition=0, out_partition=0),
              JP.UnionInput(child=a, partition=1, out_partition=1),
              JP.UnionInput(child=b, partition=0, out_partition=2))
    return JP.Union(inputs=inputs, schema=SRC, num_partitions=3)


def _rows(rbs):
    return pa.Table.from_batches(rbs).to_pylist() if rbs else []


def test_union_streams_its_assignments():
    parts, res = _union_sources()
    want = [parts["a"][0], parts["a"][1], parts["b"][0]]
    for p in range(3):
        port, ref, _ = _run(_union_plan(), res, pid=p, n_parts=3)
        assert port.to_pylist() == ref.to_pylist() == _rows(want[p])


def test_union_collapsed_streams_every_assignment():
    parts, res = _union_sources()
    port, ref, _ = _run(_union_plan(), res, pid=0, n_parts=1)
    want = parts["a"][0] + parts["a"][1] + parts["b"][0]
    assert port.to_pylist() == ref.to_pylist() == _rows(want)


# -- expand ------------------------------------------------------------------

def _null(t):
    return JE.Literal(value=None, dtype=t)


def _expand_plan():
    k, c, q = JE.col("k"), JE.col("c"), JE.col("q")
    return JP.Expand(
        child=JP.FFIReader(schema=SRC, resource_id="src"),
        projections=((k, c, q, JE.Literal(value=0, dtype=I64)),
                     (k, _null(STR), q, JE.Literal(value=1, dtype=I64)),
                     (_null(STR), _null(STR), q,
                      JE.Literal(value=3, dtype=I64))),
        names=("k", "c", "q", "gid"), types=(STR, STR, I32, I64))


def test_expand_matches_the_reference():
    rbs = _rbs(4)
    port, ref, raw = _run(_expand_plan(), [("src", rbs, rbs)])
    assert port.num_rows == 3 * sum(rb.num_rows for rb in rbs)
    assert port.to_pylist() == ref.to_pylist()
    # the three copies of an input batch come in one batch, each string
    # column at one width
    assert [b.num_rows for b in raw.batches] == [3 * rb.num_rows
                                                 for rb in rbs]
    for b in raw.batches:
        assert all(isinstance(b.columns[j], DeviceStringColumn)
                   for j in (0, 1))


def test_expand_under_a_partial_agg_matches_the_reference():
    """q27r's shape: Expand -> Agg by (k, c, gid), Count and Sum."""
    agg = JP.Agg(
        child=_expand_plan(), exec_mode="single",
        grouping=(JE.col("k"), JE.col("c"), JE.col("gid")),
        grouping_names=("k", "c", "gid"),
        aggs=(JE.AggExpr(fn="count", children=(JE.col("q"),),
                         return_type=I64),
              JE.AggExpr(fn="sum", children=(JE.col("q"),),
                         return_type=I64)),
        agg_names=("n", "s"))
    rbs = _rbs(5)
    port, ref, _ = _run(agg, [("src", rbs, rbs)])
    key = lambda r: tuple((v is None, v) for v in r.values())  # noqa: E731
    assert sorted(port.to_pylist(), key=key) == \
        sorted(ref.to_pylist(), key=key)
    assert {r["gid"] for r in port.to_pylist()} == {0, 1, 3}


def test_expand_null_of_no_type_is_a_string_column():
    """A null literal of no type under a declared string column (port
    only: the reference evaluates it as a bool column)."""
    plan = P.Expand(
        child=P.FFIReader(schema=Schema.of(Field("q", DataType.int32())),
                          resource_id="src"),
        projections=((E.Literal(value=None, dtype=DataType.null()),
                      E.col("q")),),
        names=("s", "q"), types=(DataType.string(), DataType.int32()))
    res = ResourceRegistry()
    res.put("src", [([np.arange(5, dtype=np.int32)], [None])])
    out = execute_task_bytes(serde.serialize(P.TaskDefinition(plan=plan)),
                             res, device="cpu")
    [b] = out.batches
    assert isinstance(b.columns[0], DeviceStringColumn)
    assert out.to_numpy()["s"][1].tolist() == [False] * 5


# -- coalesce, rename, empty -------------------------------------------------

@pytest.mark.parametrize("target", [0, 150, 1000])
def test_coalesce_batches_matches_the_reference(target):
    rbs = _rbs(6, n=500, size=40)
    plan = JP.CoalesceBatches(child=JP.FFIReader(schema=SRC,
                                                 resource_id="src"),
                              target_batch_size=target)
    port, ref, raw = _run(plan, [("src", rbs, rbs)])
    assert port.to_pylist() == ref.to_pylist() == _rows(rbs)
    sizes = [b.num_rows for b in raw.batches]
    assert sizes == _ref_sizes(plan, rbs)
    assert all(n >= min(target or 8192, 500) for n in sizes[:-1])


def _ref_sizes(plan, rbs):
    jres = JaxResources()
    jres.put("src", rbs)
    out = jax_execute(jserde.serialize(JP.TaskDefinition(plan=plan)), jres)
    return [rb.num_rows for rb in out.batches if rb.num_rows]


def test_rename_columns_matches_the_reference():
    rbs = _rbs(7)
    plan = JP.RenameColumns(child=JP.FFIReader(schema=SRC, resource_id="src"),
                            names=("a", "b", "c", "d"))
    port, ref, _ = _run(plan, [("src", rbs, rbs)])
    assert port.column_names == ref.column_names == ["a", "b", "c", "d"]
    assert port.to_pylist() == ref.to_pylist()


def test_empty_partitions_has_no_rows():
    plan = JP.EmptyPartitions(schema=SRC, num_partitions=4)
    for p in range(4):
        port, ref, raw = _run(plan, [], pid=p, n_parts=4)
        assert port.num_rows == ref.num_rows == 0
        assert raw.schema.names() == SRC.names()


# -- serde -------------------------------------------------------------------

def _new_kinds():
    """One node of each new kind, built with the reference's IR."""
    src = JP.FFIReader(schema=SRC, resource_id="src")
    call = JP.WindowFuncCall(
        fn="agg", args=(JE.col("q"),),
        agg=JE.AggExpr(fn="sum", children=(JE.col("q"),), return_type=I64),
        return_type=I64, name="s")
    return [
        JP.Window(child=src, window_funcs=(
            call, JP.WindowFuncCall(fn="rank", return_type=I32, name="r")),
            partition_by=(JE.col("k"),),
            order_by=(JE.SortExpr(child=JE.col("q"), asc=False,
                                  nulls_first=False),),
            group_limit=JP.WindowGroupLimit(k=5, rank_fn="dense_rank"),
            output_window_cols=False),
        call, JP.WindowGroupLimit(k=3, rank_fn="rank"),
        _union_plan(), JP.UnionInput(child=src, partition=2,
                                     out_partition=5),
        _expand_plan(),
        JP.RenameColumns(child=src, names=("a", "b", "c", "d")),
        JP.CoalesceBatches(child=src, target_batch_size=77),
        JP.EmptyPartitions(schema=SRC, num_partitions=3),
        JE.ScalarFunctionCall(name="round", args=(
            JE.col("x"), JE.Literal(value=2, dtype=I32)), return_type=F64),
        JE.ScalarFunctionCall(name="coalesce", args=(
            JE.col("k"), JE.Literal(value="none", dtype=STR))),
    ]


@pytest.mark.parametrize("node", _new_kinds(), ids=lambda n: n.kind)
def test_new_kinds_round_trip_with_the_reference_json(node):
    js = jserde.to_json(node)
    port_node = serde.from_json(js)
    assert port_node.kind == node.kind
    assert serde.to_json(port_node) == js
    if isinstance(port_node, P.PlanNode):
        # the port's task bytes decode in the reference
        task = jserde.deserialize(serde.serialize(
            P.TaskDefinition(plan=port_node)))
        assert jserde.to_json(task.plan) == js


def test_new_plan_kinds_build_in_the_port():
    for node in _new_kinds():
        if isinstance(node, JP.PlanNode) and node.kind != "union":
            PhysicalPlanner().create_plan(serde.from_json(
                jserde.to_json(node)))

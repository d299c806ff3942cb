"""The port's stage executor (`auron_tpu_torch/parallel/stage.py`)
against the JAX package's (`parallel/stage.py::execute_plan_spmd` on a
one-device CPU mesh), one case per tracer operator.

Both get the same seeded tables (the reference as pyarrow tables, the
port as SourceTables of the same record batches) and the same plans,
built with the JAX package's IR and carried across node by node
(`test_torch_session.py::to_port`, each leaf through the IR's JSON
form).  Keys, counts, ints and strings must match exactly, floats to
relative 1e-9 (the reference groups by hash on the CPU, so its sums
add in another order); rows compare in order where both engines fix
it, else sorted.  Cases: filter, projection and debug; every
aggregation mode, an empty global aggregation and an aggregation past
the reference's capacity hint; the top-k sort, limit, union and
expand; every window kind; the rejections and their reasons; the
departures from the reference (ROADMAP Queue 3); the source cache.
The joins are in test_torch_stage_joins.py (the reference compiles a
program a case, so they run in a file of their own).
"""

import gc
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu import config as jconfig
from auron_tpu.frontend.converters import BroadcastJob as JBroadcast
from auron_tpu.frontend.converters import ShuffleJob as JShuffle
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.parallel import stage as jstage
from auron_tpu.parallel.mesh import data_mesh
from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend import converters as PC
from auron_tpu_torch.ops.scan.ipc import SourceTable
from auron_tpu_torch.parallel import stage as pstage
from auron_tpu_torch.runtime.executor import execute_plan
from auron_tpu_torch.runtime.resources import ResourceRegistry

from test_torch_session import columns_table, to_port
from test_torch_strings import _random_strings
from torch_parity import one_thread, run_both  # noqa: F401

I32, I64, F64, STR = JDT.int32(), JDT.int64(), JDT.float64(), JDT.string()
BOOL = JDT.bool_()
FACT = JS.of(JF("key", I64), JF("qty", I32), JF("amount", F64),
             JF("s", STR))
DIM = JS.of(JF("dkey", I64), JF("ds", STR), JF("dval", I64))
N_FACT, N_DIM = 3000, 160
KEYS = 64


def _objects(values):
    a = np.empty(len(values), dtype=object)
    a[:] = values
    return a


def _table(schema, cols, masks):
    types = [pa.int64() if f.dtype == I64 else pa.int32() if f.dtype == I32
             else pa.float64() if f.dtype == F64 else pa.string()
             for f in schema.fields]
    return pa.Table.from_arrays(
        [pa.array(list(c) if c.dtype == object else c, type=t, mask=m)
         for c, t, m in zip(cols, types, masks)], names=schema.names())


@pytest.fixture(scope="module")
def tables():
    """fact: key over 64 values, qty, amount, s (a pool of 60 distinct
    strings: ASCII, NUL, multibyte, up to 20 bytes); dim: dkey over
    0..49 with each key 1 to 3 times (duplicate build keys, fan-out up
    to 3), ds the pool's string of its dkey, dval.  Nulls in every
    column."""
    rng = np.random.default_rng(11)
    pool = list(dict.fromkeys(_random_strings(rng, 200, max_len=20)))[:60]
    fact = _table(FACT, [
        rng.integers(0, KEYS, N_FACT).astype(np.int64),
        rng.integers(1, 100, N_FACT).astype(np.int32),
        np.round(rng.normal(50, 30, N_FACT), 2),
        _objects([pool[i] for i in rng.integers(0, 60, N_FACT)])],
        [rng.random(N_FACT) < 0.05 for _ in range(4)])
    dkeys = np.repeat(np.arange(50), rng.integers(1, 4, 50))[:N_DIM]
    n = len(dkeys)
    dim = _table(DIM, [dkeys.astype(np.int64),
                       _objects([pool[k] for k in dkeys]),
                       rng.integers(-500, 500, n).astype(np.int64)],
                 [rng.random(n) < 0.05 for _ in range(3)])
    return {"fact": fact, "dim": dim}


def fact(rid="fact"):
    return JP.FFIReader(schema=FACT, resource_id=rid)


def dim(rid="dim"):
    return JP.FFIReader(schema=DIM, resource_id=rid)


def hashed(*keys, n=4):
    return JP.Partitioning(mode="hash", num_partitions=n,
                           expressions=tuple(JE.col(k) for k in keys))


SINGLE = JP.Partitioning(mode="single", num_partitions=1)


class Query:
    """A plan with its exchanges ({rid: (child, partitioning)}) and
    broadcasts ({rid: child}), run by both stage executors."""

    def __init__(self, plan, exchanges=None, broadcasts=None):
        self.plan = plan
        self.exchanges = exchanges or {}
        self.broadcasts = broadcasts or {}

    def reader(self, rid, schema):
        return JP.IpcReader(schema=schema, resource_id=rid)

    def jax_ctx(self):
        return SimpleNamespace(
            exchanges={rid: JShuffle(rid, child=c, partitioning=p)
                       for rid, (c, p) in self.exchanges.items()},
            broadcasts={rid: JBroadcast(rid, child=c)
                        for rid, c in self.broadcasts.items()},
            sources={})

    def port(self):
        memo = {}
        ctx = PC.ConvertContext()
        for rid, (c, p) in self.exchanges.items():
            ctx.exchanges[rid] = PC.ShuffleJob(rid, to_port(c, memo),
                                               to_port(p, memo))
        for rid, c in self.broadcasts.items():
            ctx.broadcasts[rid] = PC.BroadcastJob(rid, to_port(c, memo))
        return to_port(self.plan, memo), ctx

    def run_ref(self, tables):
        return jstage.execute_plan_spmd(self.plan, self.jax_ctx(),
                                        data_mesh(1), dict(tables))

    def run_port(self, sources):
        plan, ctx = self.port()
        return pstage.execute_plan_stage(plan, ctx, sources, device="cpu")


def sources_of(tables):
    return {rid: SourceTable([t.to_batches(max_chunksize=500)])
            for rid, t in tables.items()}


def port_result(out) -> pa.Table:
    return columns_table(out.schema, out.to_numpy())


def _rows(t: pa.Table):
    return list(zip(*(c.to_pylist() for c in t.columns))) \
        if t.num_columns else []


def _sort_key(row):
    return tuple((v is None, "" if v is None else
                  (round(v, 6) if isinstance(v, float) else v))
                 for v in row)


def assert_same(port: pa.Table, ref: pa.Table, ordered=False):
    """Exact equality but for floats, which agree to relative 1e-9."""
    assert port.column_names == ref.column_names
    a, b = _rows(port), _rows(ref)
    assert len(a) == len(b)
    if not ordered:
        a, b = sorted(a, key=_sort_key), sorted(b, key=_sort_key)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                assert x == y or (np.isnan(x) and np.isnan(y)) or \
                    abs(x - y) <= 1e-9 * max(abs(x), abs(y)), (ra, rb)
            else:
                assert x == y, (ra, rb)


def check(q: Query, tables, ordered=False, min_rows=1):
    ref = q.run_ref(tables)
    out = q.run_port(sources_of(tables))
    port = port_result(out)
    assert_same(port, ref, ordered)
    assert port.num_rows >= min_rows
    return port, out


def reasons(q: Query, tables):
    """Both executors' rejection messages."""
    with pytest.raises(jstage.SpmdUnsupported) as ref:
        q.run_ref(tables)
    with pytest.raises(pstage.SpmdUnsupported) as port:
        q.run_port(sources_of(tables))
    return str(port.value), str(ref.value)


def agg(child, mode, keys, aggs, names):
    return JP.Agg(child=child, exec_mode=mode,
                  grouping=tuple(JE.col(k) for k in keys),
                  grouping_names=tuple(keys), aggs=tuple(aggs),
                  agg_names=tuple(names))


def fn(f, col, t):
    return JE.AggExpr(fn=f, children=(JE.col(col),) if col else (),
                      return_type=t)


AGGS = (fn("sum", "amount", F64), fn("count", "amount", I64),
        fn("count", None, I64), fn("avg", "amount", F64),
        fn("min", "qty", I32), fn("max", "amount", F64),
        fn("sum", "qty", I64))
AGG_NAMES = ("sum_a", "cnt_a", "cnt", "avg_a", "min_q", "max_a", "sum_q")


def _states(keys):
    """The partial states' schema of AGGS by `keys` (fact columns)."""
    fields = [FACT.fields[FACT.names().index(k)] for k in keys]
    for a, n in zip(AGGS, AGG_NAMES):
        if a.fn in ("sum", "avg"):
            fields.append(JF(f"{n}#sum", a.return_type if a.fn == "sum"
                             else F64))
        if a.fn in ("count", "avg"):
            fields.append(JF(f"{n}#count", I64, nullable=False))
        if a.fn in ("min", "max"):
            fields.append(JF(f"{n}#{a.fn}", a.return_type))
    return JS(tuple(fields))


def two_phase(keys, child=None, part=None):
    child = child if child is not None else fact()
    part = part if part is not None else (hashed(*keys) if keys
                                          else SINGLE)
    q = Query(None, {"x": (agg(child, "partial", keys, AGGS, AGG_NAMES),
                           part)})
    q.plan = agg(q.reader("x", _states(keys)), "final", keys, AGGS,
                 AGG_NAMES)
    return q


# -- row operators -------------------------------------------------------------

def test_filter_projection_debug(tables):
    pred = JE.ScAnd(
        left=JE.BinaryExpr(left=JE.col("amount"), op=">",
                           right=JE.lit(20.0)),
        right=JE.InList(child=JE.col("qty"),
                        values=tuple(JE.lit(v, I32) for v in range(1, 60))))
    plan = JP.Debug(child=JP.Projection(
        child=JP.Filter(child=fact(), predicates=(
            pred, JE.IsNotNull(child=JE.col("key")))),
        exprs=(JE.col("key"), JE.col("s"),
               JE.BinaryExpr(left=JE.Cast(child=JE.col("qty"), dtype=F64),
                             op="*", right=JE.col("amount")),
               JE.Case(branches=(JE.WhenThen(
                   when=JE.BinaryExpr(left=JE.col("qty"), op="<",
                                      right=JE.lit(30, I32)),
                   then=JE.lit("low", STR)),), else_expr=JE.col("s"))),
        names=("key", "s", "total", "band")), debug_id="d")
    port, out = check(Query(plan), tables, ordered=True, min_rows=100)
    assert out.metrics["host_syncs"] == 1      # the gather's compaction


def test_debug_exec_streams_its_batches_and_logs_them(tables, caplog):
    """The serial DebugExec: the same rows as the reference's, and a log
    line a batch at INFO."""
    import logging
    plan = JP.Debug(child=JP.Filter(child=fact(), predicates=(
        JE.BinaryExpr(left=JE.col("qty"), op=">", right=JE.lit(90, I32)),)),
        debug_id="d")
    batches = tables["fact"].to_batches(max_chunksize=1000)
    with caplog.at_level(logging.INFO, logger="auron_tpu_torch.debug"):
        port, ref = run_both(plan, batches, batches)
    assert_same(columns_table(port.schema, port.to_numpy()),
                pa.Table.from_batches(ref.batches), ordered=True)
    assert sum(r.name == "auron_tpu_torch.debug" and
               "[d] batch" in r.getMessage()
               for r in caplog.records) == len(port.batches) > 0


@pytest.mark.parametrize("keys", [("key",), ("s",), ("key", "s"), ()],
                         ids=["int64", "string", "two", "global"])
def test_two_phase_aggregation(tables, keys):
    check(two_phase(keys), tables)


def test_single_mode_aggregation_after_a_colocating_exchange(tables):
    q = Query(None, {"x": (fact(), hashed("key"))})
    q.plan = agg(q.reader("x", FACT), "single", ("key",), AGGS, AGG_NAMES)
    check(q, tables, min_rows=KEYS)


def test_empty_global_aggregation_emits_its_identity_row(tables):
    none = JP.Filter(child=fact(), predicates=(JE.BinaryExpr(
        left=JE.col("amount"), op=">", right=JE.lit(1e9)),))
    port, _ = check(two_phase((), child=none), tables)
    [row] = _rows(port)
    assert row == (None, 0, 0, None, None, None, None)


def test_aggregation_past_the_references_capacity_hint(tables):
    """More groups (about 2,900 (key, amount) pairs) than the reference's
    agg capacity hint, here cut to 64: the reference climbs its capacity
    ladder; the port sizes its output by the group count."""
    with jconfig.conf.scoped({"auron.spmd.agg.capacity.hint": 64}):
        port, _ = check(two_phase(("key", "amount")), tables)
    assert port.num_rows > 4 * 64


def test_top_k_sort(tables):
    order = (JE.SortExpr(child=JE.col("qty"), asc=True, nulls_first=True),
             JE.SortExpr(child=JE.col("s"), asc=False, nulls_first=False))
    plan = JP.CoalesceBatches(child=JP.Sort(child=fact(), sort_exprs=order,
                                            fetch_limit=25))
    port, out = check(Query(plan), tables, ordered=True)
    assert port.num_rows == 25
    assert out.metrics["host_syncs"] == 1


def test_limit(tables):
    plan = JP.CoalesceBatches(child=JP.Limit(child=JP.Filter(
        child=fact(), predicates=(JE.BinaryExpr(
            left=JE.col("qty"), op=">", right=JE.lit(50, I32)),)),
        limit=40, offset=7))
    port, _ = check(Query(plan), tables, ordered=True)
    assert port.num_rows == 40


def _union_inputs(parts):
    a = JP.Projection(child=fact(), exprs=(JE.col("key"), JE.col("s")),
                      names=("k", "v"))
    b = JP.Projection(child=dim(), exprs=(JE.col("dkey"), JE.col("ds")),
                      names=("k", "v"))
    kids = {"a": a, "b": b}
    return JP.Union(inputs=tuple(
        JP.UnionInput(child=kids[c], partition=p, out_partition=i)
        for i, (c, p) in enumerate(parts)),
        schema=JS.of(JF("k", I64), JF("v", STR)), num_partitions=len(parts))


def test_union(tables):
    """A child read once per partition comes once; read twice per
    partition, twice."""
    union = _union_inputs([("a", 0), ("a", 1), ("b", 0), ("b", 0)])
    port, _ = check(Query(JP.CoalesceBatches(child=union)), tables,
                    ordered=True)
    assert port.num_rows == N_FACT + 2 * tables["dim"].num_rows


def test_expand(tables):
    """q27r's grouping sets: copies with null string literals."""
    k, s, q = JE.col("key"), JE.col("s"), JE.col("qty")
    plan = JP.CoalesceBatches(child=JP.Expand(
        child=fact(), projections=(
            (k, s, q, JE.lit(0, I64)),
            (k, JE.lit(None, STR), q, JE.lit(1, I64)),
            (JE.lit(None, I64), JE.lit(None, STR), q, JE.lit(3, I64))),
        names=("key", "s", "qty", "gid"), types=(I64, STR, I32, I64)))
    port, _ = check(Query(plan), tables, ordered=True)
    assert port.num_rows == 3 * N_FACT


# -- joins ----------------------------------------------------------------------

BROADCAST_TYPES = ("inner", "left", "left_semi", "left_anti", "existence")
COLOCATED_TYPES = BROADCAST_TYPES + ("full", "right")
JOIN_CASES = [(op, jt, keys)
              for op, types in (("broadcast", BROADCAST_TYPES),
                                ("hash", COLOCATED_TYPES),
                                ("smj", COLOCATED_TYPES))
              for jt in types for keys in ("int64", "string")]


def join_query(op, jt, keys, build_side="right"):
    lk, rk = ("key", "dkey") if keys == "int64" else ("s", "ds")
    on = JP.JoinOn(left_keys=(JE.col(lk),), right_keys=(JE.col(rk),))
    if op == "broadcast":
        q = Query(None, broadcasts={"b": dim()})
        build = JP.BroadcastJoinBuildHashMap(
            child=q.reader("b", DIM), keys=(JE.col(rk),), cache_id="c")
        q.plan = JP.BroadcastJoin(left=fact(), right=build, on=on,
                                  join_type=jt, broadcast_side=build_side,
                                  cached_build_hash_map_id="c")
        return q
    q = Query(None, {"l": (fact(), hashed(lk)), "r": (dim(), hashed(rk))})
    left, right = q.reader("l", FACT), q.reader("r", DIM)
    if op == "hash":
        q.plan = JP.HashJoin(left=left, right=right, on=on, join_type=jt,
                             build_side=build_side)
        return q

    def sorted_by(child, k):
        return JP.Sort(child=child, sort_exprs=(JE.SortExpr(
            child=JE.col(k), asc=True, nulls_first=True),))
    q.plan = JP.SortMergeJoin(left=sorted_by(left, lk),
                              right=sorted_by(right, rk), on=on,
                              join_type=jt, sort_options=((True, True),))
    return q


# -- windows -------------------------------------------------------------------

WIN = JS.of(JF("k1", I64), JF("k2", STR), JF("o", I32), JF("v", F64),
            JF("i", I64))


@pytest.fixture(scope="module")
def win_tables():
    """k1 over 5 values, k2 over 4 strings, o over 0..29 (ties), v in
    quarters (sums exact in any order), i; nulls in every column."""
    rng = np.random.default_rng(5)
    n = 700
    cols = [rng.integers(0, 5, n).astype(np.int64),
            _objects(list(rng.choice(["", "CA", "TN", "long key\x00"], n))),
            rng.integers(0, 30, n).astype(np.int32),
            rng.integers(-400, 400, n) / 4.0,
            rng.integers(-1000, 1000, n).astype(np.int64)]
    return {"w": _table(WIN, cols, [rng.random(n) < 0.08 for _ in cols])}


def _call(f, name, args=(), agg_expr=None, rtype=None):
    return JP.WindowFuncCall(fn=f, args=tuple(args), agg=agg_expr,
                             return_type=rtype, name=name)


def _wagg(f, c, t):
    return JE.AggExpr(fn=f, children=(JE.col(c),) if c else (),
                      return_type=t)


WINDOW_CALLS = {
    "row_number": _call("row_number", "rn", rtype=I32),
    "rank": _call("rank", "rk", rtype=I32),
    "dense_rank": _call("dense_rank", "drk", rtype=I64),
    "percent_rank": _call("percent_rank", "prk", rtype=F64),
    "cume_dist": _call("cume_dist", "cd", rtype=F64),
    "lead": _call("lead", "ld", (JE.col("v"), JE.lit(1, I32)), rtype=F64),
    "lag": _call("lag", "lg", (JE.col("i"), JE.lit(2, I32),
                               JE.lit(-7, I64)), rtype=I64),
    "first_value": _call("first_value", "fv", (JE.col("v"),), rtype=F64),
    "last_value": _call("last_value", "lv", (JE.col("i"),), rtype=I64),
    "count": _call("agg", "cnt", agg_expr=_wagg("count", "v", I64),
                   rtype=I64),
    "sum": _call("agg", "sm", agg_expr=_wagg("sum", "v", F64), rtype=F64),
    "avg": _call("agg", "av", agg_expr=_wagg("avg", "v", F64), rtype=F64),
    "min": _call("agg", "mn", agg_expr=_wagg("min", "i", I64), rtype=I64),
    "max": _call("agg", "mx", agg_expr=_wagg("max", "v", F64), rtype=F64),
}
ORDER = (JE.SortExpr(child=JE.col("o"), asc=True, nulls_first=True),
         JE.SortExpr(child=JE.col("i"), asc=False, nulls_first=False))


def window_query(calls, keys, order=ORDER, group_limit=None, output=True):
    part = hashed(*keys[:1]) if keys else SINGLE
    q = Query(None, {"x": (JP.FFIReader(schema=WIN, resource_id="w"),
                           part)})
    q.plan = JP.Window(child=q.reader("x", WIN), window_funcs=tuple(calls),
                       partition_by=tuple(JE.col(k) for k in keys),
                       order_by=order, group_limit=group_limit,
                       output_window_cols=output)
    return q


@pytest.mark.parametrize("kind", sorted(WINDOW_CALLS))
@pytest.mark.parametrize("keys", [(), ("k1",), ("k1", "k2")],
                         ids=["no-key", "one-key", "two-keys"])
def test_window(win_tables, kind, keys):
    check(window_query((WINDOW_CALLS[kind],), keys), win_tables)


def test_window_without_an_order(win_tables):
    calls = [WINDOW_CALLS[k] for k in ("count", "sum", "min", "max")]
    check(window_query(calls, ("k2",), order=()), win_tables)


@pytest.mark.parametrize("rank_fn", ["row_number", "rank", "dense_rank"])
@pytest.mark.parametrize("output", [True, False])
def test_window_group_limit(win_tables, rank_fn, output):
    check(window_query((WINDOW_CALLS["rank"],), ("k1",),
                       group_limit=JP.WindowGroupLimit(k=3, rank_fn=rank_fn),
                       output=output), win_tables)


# -- rejections -----------------------------------------------------------------

def _rejected_single_agg():
    return Query(agg(fact(), "single", ("key",), AGGS, AGG_NAMES))


def _rejected_window():
    q = window_query((WINDOW_CALLS["rank"],), ("k1",))
    q.exchanges["x"] = (q.exchanges["x"][0], hashed("k2"))
    return q


def _rejected_colocation():
    q = join_query("hash", "inner", "int64")
    q.exchanges["r"] = (dim(), hashed("dval"))
    return q


def _limit_over_sort():
    return Query(JP.CoalesceBatches(child=JP.Limit(child=JP.Sort(
        child=fact(), sort_exprs=(JE.SortExpr(child=JE.col("qty")),)),
        limit=10)))


def _uneven_union():
    return Query(JP.CoalesceBatches(child=_union_inputs(
        [("a", 0), ("a", 0), ("a", 1), ("b", 0)])))


REJECTED = {
    "single-agg-without-exchange": (
        _rejected_single_agg,
        "single-mode agg needs an exchange (or partial/final shape)"),
    "window-not-colocated": (
        _rejected_window, "window needs a colocating exchange under it"),
    "join-not-colocated": (
        _rejected_colocation,
        "join sides are not hash-colocated on the join keys"),
    "broadcast-full": (
        lambda: join_query("broadcast", "full", "int64"),
        "SPMD broadcast-join type 'full'"),
    "hash-right-semi": (
        lambda: join_query("hash", "right_semi", "int64",
                           build_side="left"),
        "SPMD join type 'right_semi'"),
    "hash-build-left": (
        lambda: join_query("hash", "inner", "int64", build_side="left"),
        "SPMD join requires build_side=right"),
    "limit-over-sort": (
        _limit_over_sort, "limit over a sorted input is order-sensitive"),
    "uneven-union": (
        _uneven_union, "union references a child's partitions unevenly"),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_rejection_reason_is_the_references(tables, win_tables, case):
    make, reason = REJECTED[case]
    port, ref = reasons(make(), {**tables, **win_tables})
    assert port == ref == reason


# -- departures from the reference (ROADMAP Queue 3) ----------------------------

def test_top_k_sort_fetch_offset_is_sparks(tables):
    """A mid-plan sort with a fetch offset keeps rows [offset, offset +
    limit) of its order, as the serial SortExec does; the reference's
    stage path keeps [0, limit)."""
    order = (JE.SortExpr(child=JE.col("amount"), asc=False,
                         nulls_first=False),)
    q = Query(JP.CoalesceBatches(child=JP.Sort(
        child=fact(), sort_exprs=order, fetch_limit=5, fetch_offset=3)))
    ref = q.run_ref(tables)
    port = port_result(q.run_port(sources_of(tables)))
    plan, _ = q.port()
    res = ResourceRegistry()
    res.put("fact", sources_of(tables)["fact"])
    serial = execute_plan(plan, resources=res, device="cpu")
    assert_same(port, columns_table(serial.schema, serial.to_numpy()))
    top = sorted(tables["fact"].column("amount").drop_null().to_pylist(),
                 reverse=True)
    assert sorted(port.column("amount").to_pylist(), reverse=True) == \
        top[3:8]
    assert sorted(ref.column("amount").to_pylist(), reverse=True) == \
        top[:5]


# -- the source cache ---------------------------------------------------------

def _cache_query():
    return two_phase(("key",))


def test_a_repeat_execute_uploads_nothing(tables):
    pstage.clear_source_caches()
    srcs = sources_of(tables)
    first = _cache_query().run_port(srcs).metrics
    second = _cache_query().run_port(srcs).metrics
    assert first["bytes_uploaded"] > 0 and first["source_cache_hits"] == 0
    assert second["bytes_uploaded"] == 0 and second["source_cache_hits"] == 1
    with conf.scoped({"auron.spmd.source.cache.mb": 0}):
        third = _cache_query().run_port(srcs).metrics
    assert third["bytes_uploaded"] == first["bytes_uploaded"]
    assert third["source_cache_hits"] == 0


def test_cache_evicts_least_recently_used(tables):
    """Three 400 KB tables under a 1 MB budget: the table touched last
    before the third upload stays, the other goes."""
    pstage.clear_source_caches()
    n = 40_000
    big = JS.of(JF("key", I64))
    src = {name: SourceTable([[([np.arange(n, dtype=np.int64)],
                                [np.ones(n, bool)])]])
           for name in "abc"}

    def touch(name):
        plan = JP.CoalesceBatches(child=JP.FFIReader(schema=big,
                                                     resource_id=name))
        return Query(plan).run_port({name: src[name]}).metrics

    with conf.scoped({"auron.spmd.source.cache.mb": 1}):
        assert touch("a")["bytes_uploaded"] == 10 * n
        touch("b")
        assert touch("a")["source_cache_hits"] == 1
        touch("c")
        cached = {k[0] for k in pstage._DEVICE_SOURCES.keys()}
        assert cached == {id(src["a"]), id(src["c"])}
        assert touch("b")["bytes_uploaded"] == 10 * n
    # a collected table's entries go with it
    gone = id(src.pop("b"))
    gc.collect()
    assert gone not in {k[0] for k in pstage._DEVICE_SOURCES.keys()}
    pstage.clear_source_caches()
    assert pstage._DEVICE_SOURCES.keys() == []

"""Spilling operators of auron_tpu_torch against auron_tpu on the CPU.

Each case runs the same serialized TaskDefinition bytes over the same
seeded record batches three times: through the JAX package and through
the port under the same tiny memory budget (`reset_manager(budget)` and
the same `auron.memory.*` keys in both confs), and through the port
unbudgeted.  The budgeted port run must have spilled, and must equal
both: keys, counts, orders, Min and Max exactly, float sums to relative
1e-9 (a spilled merge adds in another order).  The port's budgeted run
equals its unbudgeted run row for row where the plan orders its output
(sort, window); the JAX package's merge does not keep ties in input
order, so against it the sort keys are compared in order and the rows as
a multiset.

The cases mirror the JAX package's own spill tests:
`test_ops_basic.py::test_external_sort_spill_fuzz` and
`::test_agg_spill_fuzz`, `test_e2e.py::test_window_spill_tiny_budget`,
`test_joins.py::test_smj_spill_tiny_budget` and
`test_smj_giant_group.py` (every join type, the null-key group, the
escape taken, the fuzz under a tiny budget); and add a sort by a string
key, a sort with a fetch limit and offset, a string-keyed aggregation
and a global aggregation.
"""

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu import config as jconfig
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.memmgr import manager as jmm
from auron_tpu.runtime.executor import execute_task_bytes as jax_execute
from auron_tpu.runtime.resources import ResourceRegistry as JaxResources
from auron_tpu_torch.config import conf
from auron_tpu_torch.memmgr import manager as pmm
from auron_tpu_torch.runtime.executor import execute_task_bytes
from auron_tpu_torch.runtime.resources import ResourceRegistry

from torch_parity import one_thread  # noqa: F401  (autouse fixture)

I64, I32, F64, STR = JDT.int64(), JDT.int32(), JDT.float64(), JDT.string()
TINY = {"auron.memory.spill.min.trigger.bytes": 1}
FLOAT_REL = 1e-9


@pytest.fixture(autouse=True)
def _fresh_managers():
    yield
    jmm.reset_manager()
    pmm.reset_manager()


# -- running a plan three ways --------------------------------------------------

def _table(result) -> pa.Table:
    cols = result.to_numpy()
    return pa.table({n: pa.array(d, mask=~v) for n, (d, v) in cols.items()})


class Runs:
    """The port's budgeted and unbudgeted runs and the JAX package's
    budgeted run of one plan."""

    def __init__(self, plan, inputs, budget: int, kv=None, base_kv=None):
        data = jserde.serialize(JP.TaskDefinition(plan=plan), codec="zlib")
        budgeted = dict(TINY, **(kv or {}))
        self.port, self.port_spills, self.port_mgr = self._port(
            data, inputs, budget, budgeted)
        self.whole, _, _ = self._port(data, inputs, None, base_kv or {})
        jres = JaxResources()
        for rid, rbs in inputs.items():
            jres.put(rid, list(rbs))
        with jconfig.conf.scoped(budgeted):
            jmgr = jmm.reset_manager(budget)
            self.jax = jax_execute(data, jres).to_table()
            self.jax_spills = jmgr.num_spills
        jmm.reset_manager()

    @staticmethod
    def _port(data, inputs, budget, kv):
        res = ResourceRegistry()
        for rid, rbs in inputs.items():
            res.put(rid, list(rbs))
        with conf.scoped(kv):
            mgr = pmm.reset_manager(budget)
            out = execute_task_bytes(data, res, device="cpu")
        pmm.reset_manager()
        return out, mgr.num_spills, mgr

    def check(self, sort_keys=None, ordered=False):
        """The port spilled, and equals its unbudgeted run and the JAX
        package's run.  `sort_keys`: columns whose order the JAX run must
        match (the rows then as a multiset); `ordered`: the port's two
        runs row for row."""
        got = _table(self.port)
        assert self.port_spills > 0 or \
            self.port.summed("mem_spill_count") > 0, "the port never spilled"
        assert_same(got, _table(self.whole), ordered=ordered)
        assert_same(got, self.jax, ordered=False)
        for k in sort_keys or ():
            assert got.column(k).to_pylist() == \
                self.jax.column(k).to_pylist(), k
        return got


def _rows(t: pa.Table):
    return list(zip(*[t.column(n).to_pylist() for n in t.column_names]))


def assert_same(got: pa.Table, exp: pa.Table, ordered: bool) -> None:
    assert got.column_names == exp.column_names
    assert got.num_rows == exp.num_rows, (got.num_rows, exp.num_rows)
    floats = {i for i, n in enumerate(exp.column_names)
              if pa.types.is_floating(exp.schema.field(n).type)}
    g, e = _rows(got), _rows(exp)
    if not ordered:
        def key(r):
            return tuple((x is None, x) for i, x in enumerate(r)
                         if i not in floats)
        g, e = sorted(g, key=key), sorted(e, key=key)
    for rg, re_ in zip(g, e):
        for i, (x, y) in enumerate(zip(rg, re_)):
            if i in floats and x is not None and y is not None:
                assert x == y or abs(x - y) <= FLOAT_REL * abs(y) or \
                    (x != x and y != y), (rg, re_)
            else:
                assert x == y, (rg, re_)


def _batches(schema: JS, arrays, size: int, masks=None):
    t = pa.table({f.name: pa.array(a, mask=None if masks is None or
                                   masks[i] is None else ~masks[i])
                  for i, (f, a) in enumerate(zip(schema.fields, arrays))})
    return t.cast(pa.schema([(f.name, _arrow(f.dtype))
                             for f in schema.fields])) \
        .to_batches(max_chunksize=size)


def _arrow(dt):
    from auron_tpu.ir.schema import to_arrow_type
    return to_arrow_type(dt)


def _reader(schema, rid="src"):
    return JP.FFIReader(schema=schema, resource_id=rid)


# -- sort ------------------------------------------------------------------------

KI = JS.of(JF("k", I64), JF("i", I64))


def test_sort_spill_fuzz():
    """test_external_sort_spill_fuzz: 5,000 rows in chunks of 500 under
    a 60,000-byte budget; the keys in the JAX order, the rows as the
    port's in-memory sort."""
    rng = np.random.default_rng(7)
    n = 5000
    vals = rng.integers(-10**6, 10**6, n)
    plan = JP.Sort(child=_reader(KI),
                   sort_exprs=(JE.SortExpr(child=JE.col("k"), asc=True),))
    r = Runs(plan, {"src": _batches(KI, [vals, np.arange(n)], 500)},
             60_000, {"auron.memory.spill.min.trigger.bytes": 10_000})
    got = r.check(sort_keys=("k",), ordered=True)
    assert got.column("k").to_pylist() == sorted(vals.tolist())
    assert r.port.summed("mem_spill_count") >= 2


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False),
                                             (True, False)])
def test_sort_by_string_key_spills(asc, nulls_first):
    """A string key of 0-40 bytes (three width buckets across the
    batches, ties, NULLs, a value that is another's prefix and one with
    a trailing NUL byte) merges in Spark's order; ties keep their input
    order, as the in-memory sort's."""
    rng = np.random.default_rng(11)
    pool = ["", "a", "ab", "ab\x00", "abc", "b" * 20, "b" * 9, "zz",
            "x" * 40, "y" * 7, "AAAA0001", "AAAA0000"]
    n = 3000
    s = np.array([pool[j] for j in rng.integers(0, len(pool), n)],
                 dtype=object)
    sv = rng.random(n) >= 0.1
    schema = JS.of(JF("s", STR), JF("i", I64))
    plan = JP.Sort(child=_reader(schema), sort_exprs=(
        JE.SortExpr(child=JE.col("s"), asc=asc, nulls_first=nulls_first),))
    r = Runs(plan, {"src": _batches(schema, [s, np.arange(n)], 250,
                                    [sv, None])}, 20_000)
    got = r.check(sort_keys=("s",), ordered=True)
    vals = got.column("s").to_pylist()
    live = [v.encode() for v in vals if v is not None]
    assert live == sorted(live, reverse=not asc)
    assert (vals[0] is None) == nulls_first


def test_sort_fetch_limit_and_offset_spills():
    """Fetch limit 100 and offset 37 apply after the merge."""
    rng = np.random.default_rng(5)
    n = 4000
    keys = rng.permutation(n).astype(np.int64)
    plan = JP.Sort(child=_reader(KI),
                   sort_exprs=(JE.SortExpr(child=JE.col("k"), asc=False),),
                   fetch_limit=100, fetch_offset=37)
    r = Runs(plan, {"src": _batches(KI, [keys, np.arange(n)], 300)},
             20_000)
    got = r.check(sort_keys=("k", "i"), ordered=True)
    assert got.column("k").to_pylist() == list(range(n - 38, n - 138, -1))


# -- aggregation -------------------------------------------------------------------

def _agg(child, grouping, aggs, names, mode="single"):
    return JP.Agg(child=child, exec_mode=mode,
                  grouping=tuple(JE.col(g) for g in grouping),
                  grouping_names=tuple(grouping), aggs=aggs,
                  agg_names=names)


def test_agg_spill_fuzz():
    """test_agg_spill_fuzz: 20,000 rows of 1,000 groups under a
    60,000-byte budget; every group exact across the runs it was split
    into."""
    n = 20000
    kv = JS.of(JF("k", I64), JF("v", I64))
    plan = _agg(_reader(kv), ("k",),
                (JE.AggExpr(fn="sum", children=(JE.col("v"),),
                            return_type=I64),), ("s",))
    r = Runs(plan, {"src": _batches(kv, [np.arange(n) % 1000,
                                         np.arange(n)], 2000)},
             60_000, {"auron.memory.spill.min.trigger.bytes": 10_000})
    got = r.check()
    assert r.port_spills >= 2 and got.num_rows == 1000
    exp = np.bincount(np.arange(n) % 1000, weights=np.arange(n))
    assert dict(zip(got.column("k").to_pylist(),
                    got.column("s").to_pylist())) == \
        {k: int(v) for k, v in enumerate(exp)}


def _mixed(rng, n):
    schema = JS.of(JF("g", STR), JF("h", I32), JF("x", F64), JF("y", I64))
    pool = np.array([f"g{j % 17}" * (1 + j % 5) for j in range(60)],
                    dtype=object)
    cols = [pool[rng.integers(0, len(pool), n)],
            rng.integers(0, 4, n).astype(np.int32),
            np.round(rng.normal(0, 100, n), 3),
            rng.integers(-10**6, 10**6, n)]
    masks = [rng.random(n) >= 0.05 for _ in cols]
    return schema, cols, masks


@pytest.mark.parametrize("mode", ["single", "partial"])
def test_agg_by_string_and_int_keys_spills(mode):
    """Group by (string, int32) with NULL keys: sum, count, min and max
    of a float and an int64 column; in partial mode the state rows."""
    rng = np.random.default_rng(21)
    schema, cols, masks = _mixed(rng, 6000)
    aggs = tuple(JE.AggExpr(fn=fn, children=(JE.col(c),),
                            return_type=F64 if c == "x" and fn != "count"
                            else I64)
                 for c in ("x", "y") for fn in ("sum", "count", "min",
                                                  "max"))
    names = tuple(f"{fn}_{c}" for c in ("x", "y")
                  for fn in ("sum", "count", "min", "max"))
    plan = _agg(_reader(schema), ("g", "h"), aggs, names, mode)
    r = Runs(plan, {"src": _batches(schema, cols, 400, masks)}, 1)
    got = r.check()
    assert got.num_rows == len({(g if a else None, h if b else None)
                                for g, a, h, b in zip(cols[0], masks[0],
                                                      cols[1], masks[1])})


def test_global_agg_spills():
    """No grouping keys: the one-row state runs concatenate and reduce
    once."""
    rng = np.random.default_rng(3)
    schema, cols, masks = _mixed(rng, 5000)
    aggs = (JE.AggExpr(fn="sum", children=(JE.col("x"),), return_type=F64),
            JE.AggExpr(fn="count", children=(JE.col("y"),),
                       return_type=I64),
            JE.AggExpr(fn="min", children=(JE.col("y"),), return_type=I64),
            JE.AggExpr(fn="max", children=(JE.col("x"),), return_type=F64),
            JE.AggExpr(fn="avg", children=(JE.col("y"),), return_type=F64))
    plan = _agg(_reader(schema), (), aggs, ("s", "c", "mn", "mx", "av"))
    r = Runs(plan, {"src": _batches(schema, cols, 500, masks)}, 1)
    got = r.check()
    assert got.num_rows == 1
    assert got.column("c").to_pylist() == [int(masks[3].sum())]


# -- window ------------------------------------------------------------------------

def test_window_spill_tiny_budget():
    """test_window_spill_tiny_budget: row_number and a running sum over
    12 partitions; every partition reassembled whole from the merge of
    the sorted runs.  The order key is unique inside a partition, so
    row_number is defined."""
    rng = np.random.default_rng(14)
    n = 4000
    schema = JS.of(JF("g", I64), JF("o", I64), JF("v", F64))
    g = rng.integers(0, 12, n)
    o = rng.permutation(n)
    v = rng.normal(size=n)
    plan = JP.Window(
        child=_reader(schema),
        window_funcs=(
            JP.WindowFuncCall(fn="row_number", return_type=I64, name="rn"),
            JP.WindowFuncCall(fn="agg", agg=JE.AggExpr(
                fn="sum", children=(JE.col("v"),), return_type=F64),
                return_type=F64, name="rs")),
        partition_by=(JE.col("g"),),
        order_by=(JE.SortExpr(child=JE.col("o")),))
    r = Runs(plan, {"src": _batches(schema, [g, o, v], 256)}, 1)
    got = r.check(ordered=True)
    assert got.num_rows == n


def test_window_by_string_partition_spills():
    """A string partition key of several widths and a rank over a
    descending order with ties: the port's budgeted run equals its
    in-memory run row for row."""
    rng = np.random.default_rng(15)
    schema, cols, masks = _mixed(rng, 3000)
    plan = JP.Window(
        child=_reader(schema),
        window_funcs=(JP.WindowFuncCall(fn="rank", return_type=I32,
                                        name="rk"),),
        partition_by=(JE.col("g"),),
        order_by=(JE.SortExpr(child=JE.col("h"), asc=False,
                              nulls_first=False),))
    r = Runs(plan, {"src": _batches(schema, cols, 300, masks)}, 1)
    r.check(ordered=True)


# -- sort-merge join ---------------------------------------------------------------

SIDES = (JS.of(JF("lk", I64), JF("lv", I64)),
         JS.of(JF("rk", I64), JF("rv", I64)))
FLAVORS = ("inner", "left", "right", "full", "left_semi", "left_anti",
           "right_semi", "right_anti", "existence")


def _smj(jt, schemas=SIDES):
    return JP.SortMergeJoin(
        left=_reader(schemas[0], "L"), right=_reader(schemas[1], "R"),
        on=JP.JoinOn(left_keys=(JE.col(schemas[0].fields[0].name),),
                     right_keys=(JE.col(schemas[1].fields[0].name),)),
        join_type=jt)


def _sides(lk, rk, chunk, lmask=None, rmask=None):
    order_l, order_r = np.argsort(lk, kind="stable"), \
        np.argsort(rk, kind="stable")
    lk, rk = np.asarray(lk)[order_l], np.asarray(rk)[order_r]
    lm = None if lmask is None else lmask[order_l]
    rm = None if rmask is None else rmask[order_r]
    if lm is not None:      # NULL keys sort first
        o = np.argsort(lm, kind="stable")
        lk, lm = lk[o], lm[o]
    if rm is not None:
        o = np.argsort(rm, kind="stable")
        rk, rm = rk[o], rm[o]
    return {"L": _batches(SIDES[0], [lk, np.arange(len(lk))], chunk,
                          [lm, None]),
            "R": _batches(SIDES[1], [rk, np.arange(len(rk)) * 10], chunk,
                          [rm, None])}


@pytest.mark.parametrize("how", FLAVORS)
def test_smj_spill_tiny_budget(how):
    """test_smj_spill_tiny_budget (every join type): 600 x 500 rows of 12
    keys, 200 left rows on one key, chunks of 64, budget 1: the cursors'
    buffers spill and stream back."""
    rng = np.random.default_rng(23)
    lk = rng.integers(0, 12, 600)
    lk[:200] = 3
    r = Runs(_smj(how), _sides(lk, rng.integers(0, 12, 500), 64), 1)
    r.check()
    assert r.port.summed("mem_spill_count") > 0


def _giant(all_ties: bool):
    """test_smj_giant_group.py::_tables: a giant tied group on key 5 on
    both sides (300 and 400 rows), a few other keys in the mixed
    shape."""
    if all_ties:
        return np.full(300, 5), np.full(400, 5)
    return (np.concatenate([np.full(300, 5), [1, 2, 2, 9], [3]]),
            np.concatenate([np.full(400, 5), [2, 2, 9, 9], [4]]))


@pytest.mark.parametrize("flavor", FLAVORS)
@pytest.mark.parametrize("all_ties", [True, False])
def test_giant_group_matches_uncapped(flavor, all_ties):
    """Window cap 64, budget 1: the escape's result equals the uncapped,
    unbudgeted join's and the JAX package's under the same cap and
    budget."""
    lk, rk = _giant(all_ties)
    r = Runs(_smj(flavor), _sides(lk, rk, 50), 1,
             {"auron.smj.window.max.rows": 64},
             {"auron.smj.window.max.rows": 0})
    r.check()
    assert r.port.metrics.get("giant_group_escapes", 0) >= 1


def test_escape_actually_triggers():
    """The capped run takes the escape (its counter), its build chunks
    go through the spill tiers, and it equals the uncapped run."""
    lk, rk = _giant(True)
    r = Runs(_smj("inner"), _sides(lk, rk, 50), 1,
             {"auron.smj.window.max.rows": 64},
             {"auron.smj.window.max.rows": 0})
    got = r.check()
    assert got.num_rows == 300 * 400
    assert r.port.metrics["giant_group_escapes"] == 1
    assert r.whole.metrics.get("giant_group_escapes", 0) == 0
    assert r.port.metrics["mem_spill_count"] > 0


@pytest.mark.parametrize("flavor", ["inner", "left", "full", "left_semi",
                                    "left_anti", "existence"])
def test_null_key_giant_group(flavor):
    """A giant NULL-key group: an equi-join matches none of it; the outer
    types null-extend it."""
    lk = np.concatenate([np.zeros(300), [1, 2]]).astype(np.int64)
    rk = np.concatenate([np.zeros(250), [2]]).astype(np.int64)
    lm = np.concatenate([np.zeros(300, bool), [True, True]])
    rm = np.concatenate([np.zeros(250, bool), [True]])
    r = Runs(_smj(flavor), _sides(lk, rk, 50, lm, rm), 1,
             {"auron.smj.window.max.rows": 64},
             {"auron.smj.window.max.rows": 0})
    r.check()
    assert r.port.metrics.get("giant_group_escapes", 0) >= 1


def test_giant_group_fuzz_tiny_budget():
    """test_giant_group_fuzz_tiny_budget: all-ties-heavy sides under a
    window cap of 48 and a 64 KiB budget (trigger 4,096), 4 trials."""
    rng = np.random.default_rng(123)
    for trial in range(4):
        giant = int(rng.integers(150, 400))
        n_other = int(rng.integers(0, 20))
        lk = np.concatenate([np.full(giant, 50),
                             rng.integers(0, 8, n_other)])
        rk = np.concatenate([np.full(int(rng.integers(100, 300)), 50),
                             rng.integers(0, 8, n_other)])
        flavor = FLAVORS[int(rng.integers(0, len(FLAVORS)))]
        r = Runs(_smj(flavor), _sides(lk, rk, 33), 64 * 1024,
                 {"auron.smj.window.max.rows": 48,
                  "auron.memory.spill.min.trigger.bytes": 4096},
                 {"auron.smj.window.max.rows": 0})
        r.check()


def test_partial_skipping_after_a_spill_keeps_the_spilled_states():
    """ROADMAP Queue 3 item 23: a partial aggregate that switches to
    passing its input through after it spilled.  60,000 unique keys in
    batches of 4,096, skipping ratio 0.01, a 100,000-byte budget: the
    port emits the spilled runs' states, so every row's state comes out
    (sum 60,000, as the unbudgeted run's); the JAX package drops the
    spilled runs (43,616 of 60,000)."""
    n = 60000
    kv = JS.of(JF("k", I64), JF("v", I64))
    plan = JP.Agg(child=_reader(kv), exec_mode="partial",
                  grouping=(JE.col("k"),), grouping_names=("k",),
                  aggs=(JE.AggExpr(fn="sum", children=(JE.col("v"),),
                                   return_type=I64),),
                  agg_names=("s",), supports_partial_skipping=True)
    skip = {"auron.partial.agg.skipping.ratio": 0.01}
    r = Runs(plan, {"src": _batches(kv, [np.arange(n), np.ones(n, np.int64)],
                                    4096)}, 100_000, skip, skip)
    got = _table(r.port)
    assert r.port_spills > 0 and r.port.metrics["partial_skipped"] == 1
    assert_same(got, _table(r.whole), ordered=False)
    assert sorted(got.column("k").to_pylist()) == list(range(n))
    assert sum(got.column("s#sum").to_pylist()) == n
    assert r.jax_spills > 0
    assert r.jax.num_rows == 43_616 < n

"""The window operator of auron_tpu_torch against auron_tpu on the CPU.

Each plan (FFIReader -> Window) goes to both engines as the same
serialized TaskDefinition bytes over the same seeded record batches:
- every window function of the JAX package's `compute_window_fn` (the
  ranks, percent_rank, cume_dist, lead/lag, first_value, last_value, and
  count, sum, avg, min and max over the window, running with an order
  and whole-partition without), with no partition key, one int key and
  two keys (int and string), nulls and ties in the order keys; the
  rows come out in the same order, ints, strings and ranks exact, the
  float sums and averages to `compare_tables`' tolerance (relative 1e-4,
  absolute 1e-6: the port's running float sum is a log-step scan within
  the partition, the reference's a global prefix difference);
- the group limit under each rank function, with and without the
  window columns;
- `rank` declared int32 comes out as int32.
Where the port keeps Spark's semantics and the reference does not
(ROADMAP Queue 3), the test pins the reference's answer and holds the
port to numpy or to a plain-Python window: the running float sum after
a partition of large values, the running min and max over NaN, a string
default of lead/lag, and nth_value / nth_value_ignore_nulls over
Spark's frame.
"""

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.it import compare

from test_torch_corpus_stages import _Port, out_schema
from test_torch_strings import _random_strings
from torch_parity import one_thread, run_both  # noqa: F401

I32, I64, F64, STR = JDT.int32(), JDT.int64(), JDT.float64(), JDT.string()
SRC = JS.of(JF("k1", I64), JF("k2", STR), JF("o", I32), JF("v", F64),
            JF("i", I64), JF("s", STR))


def _batches(seed, n=600, size=128, null_frac=0.08):
    """k1 over 5 values, k2 over 4 strings, o over 0..30 (ties), v, i, s;
    nulls in every column."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 5, n).astype(np.int64),
            rng.choice(np.array(["", "CA", "TN", "a longer key\x00"],
                                dtype=object), n),
            rng.integers(0, 30, n).astype(np.int32),
            np.round(rng.normal(0, 100, n), 3),
            rng.integers(-1000, 1000, n).astype(np.int64),
            np.array(_random_strings(rng, n, max_len=12), dtype=object)]
    types = [pa.int64(), pa.string(), pa.int32(), pa.float64(), pa.int64(),
             pa.string()]
    masks = [rng.random(n) < null_frac for _ in cols]
    t = pa.Table.from_arrays(
        [pa.array(list(c) if c.dtype == object else c, type=ty, mask=m)
         for c, ty, m in zip(cols, types, masks)], names=SRC.names())
    return t.to_batches(max_chunksize=size)


def _call(fn, name, args=(), agg=None, rtype=None):
    return JP.WindowFuncCall(fn=fn, args=tuple(args), agg=agg,
                             return_type=rtype, name=name)


def _agg(fn, col, rtype):
    return JE.AggExpr(fn=fn, children=(JE.col(col),) if col else (),
                      return_type=rtype)


def _lit(v, t):
    return JE.Literal(value=v, dtype=t)


def _calls():
    v, i, s = JE.col("v"), JE.col("i"), JE.col("s")
    return (
        _call("row_number", "rn", rtype=I32),
        _call("rank", "rk", rtype=I32),
        _call("dense_rank", "drk", rtype=I64),
        _call("percent_rank", "prk", rtype=F64),
        _call("cume_dist", "cd", rtype=F64),
        _call("lead", "lead_v", (v, _lit(1, I32)), rtype=F64),
        _call("lag", "lag_i2", (i, _lit(2, I32), _lit(-7, I64)), rtype=I64),
        _call("lag", "lag_s", (s, _lit(1, I32)), rtype=STR),
        _call("first_value", "fv", (v,), rtype=F64),
        _call("last_value", "lv", (s,), rtype=STR),
        _call("agg", "cnt_v", agg=_agg("count", "v", I64), rtype=I64),
        _call("agg", "cnt", agg=_agg("count", None, I64), rtype=I64),
        _call("agg", "sum_v", agg=_agg("sum", "v", F64), rtype=F64),
        _call("agg", "sum_i", agg=_agg("sum", "i", I64), rtype=I64),
        _call("agg", "avg_v", agg=_agg("avg", "v", F64), rtype=F64),
        _call("agg", "min_v", agg=_agg("min", "v", F64), rtype=F64),
        _call("agg", "max_v", agg=_agg("max", "v", F64), rtype=F64),
        _call("agg", "min_i", agg=_agg("min", "i", I64), rtype=I64),
        _call("agg", "max_i", agg=_agg("max", "i", I64), rtype=I64),
    )


def window_plan(calls, keys, order, group_limit=None, output=True):
    return JP.Window(
        child=JP.FFIReader(schema=SRC, resource_id="src"),
        window_funcs=tuple(calls),
        partition_by=tuple(JE.col(k) for k in keys),
        order_by=tuple(JE.SortExpr(child=JE.col(c), asc=a, nulls_first=nf)
                       for c, a, nf in order),
        group_limit=group_limit, output_window_cols=output)


def _tables(plan, batches):
    port, ref = run_both(plan, batches, batches)
    return _Port.table([port], out_schema(plan)), \
        pa.Table.from_batches(ref.batches)


def _assert_same(port, ref):
    assert port.num_rows == ref.num_rows > 0
    assert compare.compare_tables(port, ref, ordered=True) is None
    for name in port.column_names:
        if not pa.types.is_floating(port.schema.field(name).type):
            assert port.column(name).to_pylist() == \
                ref.column(name).to_pylist(), name


KEYS = {"none": (), "one": ("k1",), "two": ("k1", "k2")}
ORDERS = {"ordered": (("o", True, True), ("i", False, False)),
          "ties": (("o", False, True),),
          "unordered": ()}


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("keys", sorted(KEYS))
def test_window_functions_match_the_reference(keys, order):
    plan = window_plan(_calls(), KEYS[keys], ORDERS[order])
    port, ref = _tables(plan, _batches(7))
    _assert_same(port, ref)
    assert port.schema.field("rk").type == pa.int32()


@pytest.mark.parametrize("output", [True, False])
@pytest.mark.parametrize("rank_fn", ["row_number", "rank", "dense_rank"])
def test_group_limit_matches_the_reference(rank_fn, output):
    plan = window_plan(_calls()[:3], ("k1", "k2"), (("o", True, True),),
                       JP.WindowGroupLimit(k=2, rank_fn=rank_fn), output)
    port, ref = _tables(plan, _batches(8))
    _assert_same(port, ref)
    if output:
        col = {"row_number": "rn", "rank": "rk", "dense_rank": "drk"}[rank_fn]
        assert max(port.column(col).to_pylist()) <= 2


# -- where the port keeps Spark's semantics ----------------------------------

def _source(rows, schema):
    """One record batch of `rows` (tuples) under `schema`."""
    from auron_tpu.ir.schema import to_arrow_type
    cols = list(zip(*rows))
    return [pa.RecordBatch.from_arrays(
        [pa.array(list(c), type=to_arrow_type(f.dtype))
         for c, f in zip(cols, schema.fields)], names=list(schema.names()))]


SMALL = JS.of(JF("p", I64), JF("o", I32), JF("x", F64), JF("s", STR))


def _small_plan(calls, order=(("o", True, True),)):
    return JP.Window(
        child=JP.FFIReader(schema=SMALL, resource_id="src"),
        window_funcs=tuple(calls), partition_by=(JE.col("p"),),
        order_by=tuple(JE.SortExpr(child=JE.col(c), asc=a, nulls_first=nf)
                       for c, a, nf in order))


def test_running_sum_starts_from_its_partition():
    """Partition 0 sums values near 1e17, partition 1 small ones: each
    partition's running sum is its own, held to numpy's cumsum of the
    partition at relative 1e-9.  The reference subtracts a global prefix
    sum and loses partition 1's digits (pinned: it is off by more)."""
    rng = np.random.default_rng(3)
    big = rng.random(200) * 1e17
    small = rng.random(50) + 0.1
    rows = [(0, j, float(x), "") for j, x in enumerate(big)] + \
        [(1, j, float(x), "") for j, x in enumerate(small)]
    plan = _small_plan([_call("agg", "rs", agg=_agg("sum", "x", F64),
                              rtype=F64)])
    port, ref = _tables(plan, _source(rows, SMALL))
    got = np.array(port.column("rs").to_pylist())
    exp = np.concatenate([np.cumsum(big), np.cumsum(small)])
    np.testing.assert_allclose(got, exp, rtol=1e-9)
    ref_rs = np.array(ref.column("rs").to_pylist())[200:]
    assert np.max(np.abs(ref_rs - exp[200:]) / exp[200:]) > 1e-3


def test_running_min_max_order_nan_last():
    """Spark orders NaN above every number: the running min of [1.0, NaN,
    0.5] is [1.0, 1.0, 0.5] and the max [1.0, NaN, NaN].  The reference's
    `jnp.minimum` propagates NaN into the min (pinned)."""
    rows = [(0, 0, 1.0, ""), (0, 1, float("nan"), ""), (0, 2, 0.5, ""),
            (1, 0, float("nan"), ""), (1, 1, -2.0, "")]
    plan = _small_plan([
        _call("agg", "mn", agg=_agg("min", "x", F64), rtype=F64),
        _call("agg", "mx", agg=_agg("max", "x", F64), rtype=F64)])
    port, ref = _tables(plan, _source(rows, SMALL))
    r = repr
    assert list(map(r, port.column("mn").to_pylist())) == \
        list(map(r, [1.0, 1.0, 0.5, float("nan"), -2.0]))
    assert list(map(r, port.column("mx").to_pylist())) == \
        list(map(r, [1.0, float("nan"), float("nan"), float("nan"),
                     float("nan")]))
    assert list(map(r, ref.column("mn").to_pylist()))[:3] == \
        list(map(r, [1.0, float("nan"), float("nan")]))


def test_string_lead_lag_default_is_returned():
    """lead(s, 1, 'none') and lag(s, 2, 'none'): Spark returns the
    default where the offset row is outside the partition; the
    reference ignores a string default and returns null (pinned)."""
    rows = [(0, j, 0.0, v) for j, v in enumerate(["a", "bb", "ccc"])] + \
        [(1, 0, 0.0, "a long string value, past 16")]
    plan = _small_plan([
        _call("lead", "ld", (JE.col("s"), _lit(1, I32), _lit("none", STR)),
              rtype=STR),
        _call("lag", "lg", (JE.col("s"), _lit(2, I32), _lit("none", STR)),
              rtype=STR)])
    port, ref = _tables(plan, _source(rows, SMALL))
    assert port.column("ld").to_pylist() == ["bb", "ccc", "none", "none"]
    assert port.column("lg").to_pylist() == ["none", "none", "a", "none"]
    assert ref.column("ld").to_pylist() == ["bb", "ccc", None, None]


def _spark_nth(parts, nth, ignore_nulls, ordered):
    """nth_value over Spark's default frame, in plain Python: the frame
    ends at the last peer of the row (with an order) or at the end of
    the partition (without)."""
    out = []
    for rows in parts:          # rows: (order key, value) sorted
        for j, (o, _) in enumerate(rows):
            end = len(rows) if not ordered else \
                max(q for q, (o2, _) in enumerate(rows) if o2 == o) + 1
            vals = [x for _, x in rows[:end]]
            if ignore_nulls:
                vals = [x for x in vals if x is not None]
            out.append(vals[nth - 1] if len(vals) >= nth else None)
    return out


@pytest.mark.parametrize("ordered", [True, False])
def test_nth_value_uses_sparks_frame(ordered):
    """nth_value(x, 2) and nth_value_ignore_nulls(x, 2), held to Spark's
    frame in plain Python: with peers (ties of o) or with no order, the
    second row of the frame can follow the current row.  The reference
    stops the frame at the current row and counts nulls in
    nth_value_ignore_nulls (pinned where it differs)."""
    p0 = [(0, None), (0, 2.0), (1, 3.0), (2, None), (2, 5.0)]
    p1 = [(0, 7.0), (1, None), (1, 9.0)]
    rows = [(0, o, x, "") for o, x in p0] + [(1, o, x, "") for o, x in p1]
    batches = _source(rows, SMALL)
    plan = _small_plan([
        _call("nth_value", "n2", (JE.col("x"), _lit(2, I32)), rtype=F64),
        _call("nth_value_ignore_nulls", "n2i", (JE.col("x"), _lit(2, I32)),
              rtype=F64)],
        order=(("o", True, True),) if ordered else ())
    port, ref = _tables(plan, batches)
    assert port.column("n2").to_pylist() == \
        _spark_nth([p0, p1], 2, False, ordered)
    assert port.column("n2i").to_pylist() == \
        _spark_nth([p0, p1], 2, True, ordered)
    assert ref.column("n2").to_pylist() != port.column("n2").to_pylist()


def test_chip_smoke_window_sweep_runs_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's card-against-CPU sweep of the window functions
    (every function, no key, one and two keys, with and without an
    order, the group limits) runs at a small size with the CPU in the
    card's place, and its comparison finds a changed value."""
    import torch

    import chip_smoke
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    n = 3000
    cols, valid = chip_smoke.make_store_sales(n, 3)
    scols, svalid = chip_smoke.make_string_keys(3, n)
    chip_smoke.check_windows(scols, svalid, cols, valid, "cpu", "cpu")
    assert "9 windows over 3000 rows" in capsys.readouterr().out
    from auron_tpu_torch.columnar.batch import from_numpy
    schema = chip_smoke._schema(*chip_smoke.WINDOW_COLS[-2:])
    a = [from_numpy(schema, [np.arange(4, dtype=np.int64),
                             np.array(["a", "b", "", "c"], dtype=object)],
                    device="cpu")]
    b = [from_numpy(schema, [np.arange(4, dtype=np.int64),
                             np.array(["a", "b", "", "d"], dtype=object)],
                    device="cpu")]
    assert chip_smoke._same_columns(a, a)
    assert not chip_smoke._same_columns(a, b)

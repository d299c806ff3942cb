"""Global aggregation (no grouping keys) and Average of auron_tpu_torch
against auron_tpu: count, sum and avg in partial, final and single mode,
over an empty input and a fully filtered one, and Average grouped.  The
same serialized TaskDefinitions over the same seeded batches; counts and
integers exact, floats to relative 1e-9 (the engines sum in different
orders)."""

import numpy as np
import pytest

from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP

import torch_parity as TP

SRC = JP.FFIReader(schema=TP.SRC_SCHEMA, resource_id="src")
AGGS = (JE.AggExpr(fn="count", children=(JE.col("ss_quantity"),),
                   return_type=TP.I64),
        JE.AggExpr(fn="count", children=(), return_type=TP.I64),
        JE.AggExpr(fn="sum", children=(JE.col("ss_sales_price"),),
                   return_type=TP.F64),
        JE.AggExpr(fn="sum", children=(JE.col("ss_quantity"),),
                   return_type=TP.I64),
        JE.AggExpr(fn="avg", children=(JE.col("ss_sales_price"),),
                   return_type=TP.F64))
AGG_NAMES = ("cnt_q", "cnt_star", "sum_p", "sum_q", "avg_p")
STATE_NAMES = ("cnt_q#count", "cnt_star#count", "sum_p#sum", "sum_q#sum",
               "avg_p#sum", "avg_p#count")
STATE_SCHEMA = TP.JS.of(
    TP.JF("cnt_q#count", TP.I64, nullable=False),
    TP.JF("cnt_star#count", TP.I64, nullable=False),
    TP.JF("sum_p#sum", TP.F64), TP.JF("sum_q#sum", TP.I64),
    TP.JF("avg_p#sum", TP.F64),
    TP.JF("avg_p#count", TP.I64, nullable=False))


def _agg(child, mode, grouping=(), aggs=AGGS, names=AGG_NAMES):
    return JP.Agg(child=child, exec_mode=mode, grouping=grouping,
                  grouping_names=tuple(g.name for g in grouping), aggs=aggs,
                  agg_names=names)


def _input(n, seed, size=1000):
    cols, valid = TP.make_sales(n, seed=seed)
    parts = TP.chunks(cols, valid, size)
    return cols, valid, parts, [TP.to_arrow(*p) for p in parts]


def _same(plan, arrow, parts, names):
    port, jax = TP.run_both(plan, arrow, parts)
    got = port.to_numpy()
    TP.assert_same_rows(got, TP.jax_columns(jax.batches, names), names,
                        float_rel=1e-9)
    return got


@pytest.mark.parametrize("mode", ["partial", "single"])
@pytest.mark.parametrize("n", [1, 999, 12000])
def test_global_agg_matches(mode, n):
    cols, valid, parts, arrow = _input(n, seed=n)
    names = STATE_NAMES if mode == "partial" else AGG_NAMES
    got = _same(_agg(SRC, mode), arrow, parts, names)
    assert all(len(got[x][0]) == 1 for x in names)
    if mode == "single":
        q, qv = cols[1], valid[1]
        assert got["cnt_q"][0][0] == qv.sum()
        assert got["cnt_star"][0][0] == n
        assert got["sum_q"][0][0] == q[qv].astype(np.int64).sum()
        p = cols[2][valid[2]]
        if len(p):
            assert abs(got["avg_p"][0][0] - p.mean()) <= 1e-9 * p.mean()


def _states(n, seed):
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 50, n, dtype=np.int64)
    s = np.round(rng.normal(size=n) * 1e4, 2)
    sv = rng.random(n) > 0.2
    iq = rng.integers(-10**6, 10**6, n, dtype=np.int64)
    ac = np.where(sv, rng.integers(1, 9, n, dtype=np.int64), 0)
    cols = [cnt, cnt + 3, s, iq, s * 2, ac]
    valid = [np.ones(n, bool), np.ones(n, bool), sv, rng.random(n) > 0.2,
             ac > 0, np.ones(n, bool)]
    return cols, valid


@pytest.mark.parametrize("n", [1, 40, 3000])
def test_global_final_agg_matches(n):
    cols, valid = _states(n, seed=n)
    parts = TP.chunks(cols, valid, 256)
    arrow = [TP.to_arrow(*p, schema=STATE_SCHEMA) for p in parts]
    states = JP.FFIReader(schema=STATE_SCHEMA, resource_id="states")
    _same(_agg(states, "final"), arrow, parts, AGG_NAMES)


@pytest.mark.parametrize("mode", ["partial", "final", "single"])
def test_global_agg_over_no_rows(mode):
    """No input batch: partial emits nothing; final and single emit one
    row, counts 0 and the sums and the average null."""
    child = JP.FFIReader(schema=STATE_SCHEMA, resource_id="states") \
        if mode == "final" else SRC
    names = STATE_NAMES if mode == "partial" else AGG_NAMES
    got = _same(_agg(child, mode), [], [], names)
    if mode == "partial":
        assert len(got[names[0]][0]) == 0
    else:
        assert [got[x][0].tolist() for x in AGG_NAMES[:2]] == [[0], [0]]
        assert not any(got[x][1][0] for x in AGG_NAMES[2:])


@pytest.mark.parametrize("mode", ["partial", "single"])
def test_global_agg_over_fully_filtered_rows(mode):
    cols, valid, parts, arrow = _input(5000, seed=3)
    pred = JE.BinaryExpr(left=JE.col("ss_quantity"), op="<",
                         right=JE.Literal(value=0, dtype=TP.I32))
    plan = _agg(JP.Filter(child=SRC, predicates=(pred,)), mode)
    names = STATE_NAMES if mode == "partial" else AGG_NAMES
    got = _same(plan, arrow, parts, names)
    assert len(got[names[0]][0]) == (0 if mode == "partial" else 1)


AVG = (JE.AggExpr(fn="avg", children=(JE.col("ss_sales_price"),),
                  return_type=TP.F64),)
KEY = (JE.col("ss_customer_sk"),)


@pytest.mark.parametrize("mode", ["partial", "single"])
def test_grouped_average_matches(mode):
    """Average by a key with nulls, over a key (7) whose prices are all
    null: its average is null."""
    cols, valid, parts, arrow = _input(8000, seed=11, size=900)
    valid[0][::40] = False
    parts = TP.chunks(cols, valid, 900)
    arrow = [TP.to_arrow(*p) for p in parts]
    plan = _agg(SRC, mode, grouping=KEY, aggs=AVG, names=("a",))
    port, jax = TP.run_both(plan, arrow, parts)
    names = ("a#sum", "a#count") if mode == "partial" else ("a",)
    got = port.to_numpy()
    TP.assert_same_groups(got, TP.jax_columns(jax.batches,
                                              ("ss_customer_sk",) + names),
                          float_names=("a#sum", "a"), names=names)
    rows = TP.keyed_rows(got, "ss_customer_sk", names)
    assert rows[7][0] is None and None in rows


def test_grouped_average_final_matches():
    """The final Average merges (sum, count) states of two partials."""
    cols, valid, parts, arrow = _input(6000, seed=5)
    partial = _agg(SRC, "partial", grouping=KEY, aggs=AVG, names=("a",))
    port, _ = TP.run_both(partial, arrow, parts)
    state_schema = TP.JS.of(TP.JF("ss_customer_sk", TP.I64),
                            TP.JF("a#sum", TP.F64),
                            TP.JF("a#count", TP.I64, nullable=False))
    got = port.to_numpy()
    names = ("ss_customer_sk", "a#sum", "a#count")
    sc = [got[x][0] for x in names]
    sv = [got[x][1] for x in names]
    half = len(sc[0]) // 2
    # the same states twice, as two map tasks would send them
    sparts = [([c[:half] for c in sc], [v[:half] for v in sv]),
              ([c[half:] for c in sc], [v[half:] for v in sv])] * 2
    sarrow = [TP.to_arrow(*p, schema=state_schema) for p in sparts]
    final = _agg(JP.FFIReader(schema=state_schema, resource_id="st"),
                 "final", grouping=KEY, aggs=AVG, names=("a",))
    port, jax = TP.run_both(final, sarrow, sparts)
    fin = port.to_numpy()
    TP.assert_same_groups(fin, TP.jax_columns(
        jax.batches, ("ss_customer_sk", "a")), float_names=("a",),
        names=("a",))
    # the average of the doubled states is the average of the states
    a = TP.keyed_rows(fin, "ss_customer_sk", ("a",))
    s = TP.keyed_rows(got, "ss_customer_sk", ("a#sum", "a#count"))
    for k, (sm, c) in s.items():
        if c:
            assert abs(a[k][0] - sm / c) <= 1e-9 * abs(sm / c)

"""The port's comparator (`auron_tpu_torch/it/compare.py`) against the
JAX package's (`auron_tpu/it/compare.py`): for the same rows, the same
verdict and the same first-difference message; and `plan_is_ordered`
on every corpus plan."""

import math

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.it import compare as JC
from auron_tpu.it import datagen as JD
from auron_tpu.it import queries as JQ
from auron_tpu_torch.frontend.foreign import ForeignNode
from auron_tpu_torch.it import compare as PC

NAMES = ["k", "s", "x"]
BASE = [(1, "a", 1.5), (2, "b", -2.25), (3, None, 0.0), (4, "d", None)]


def _swap(rows, i, j):
    rows = list(rows)
    rows[i], rows[j] = rows[j], rows[i]
    return rows


def _with(rows, i, c, v):
    rows = [list(r) for r in rows]
    rows[i][c] = v
    return [tuple(r) for r in rows]


# (actual rows, expected rows, ordered)
CASES = {
    "equal": (BASE, BASE, False),
    "equal-ordered": (BASE, BASE, True),
    "changed-int": (_with(BASE, 1, 0, 9), BASE, False),
    "changed-string": (_with(BASE, 0, 1, "z"), BASE, True),
    "order-unordered": (_swap(BASE, 0, 3), BASE, False),
    "order-ordered": (_swap(BASE, 0, 3), BASE, True),
    "row-count": (BASE[:3], BASE, False),
    "nan-both": (_with(BASE, 0, 2, math.nan), _with(BASE, 0, 2, math.nan),
                 True),
    "nan-one-side": (_with(BASE, 0, 2, math.nan), BASE, True),
    "null-both": (BASE, BASE, True),
    "null-one-side": (_with(BASE, 1, 2, None), BASE, True),
    "null-string": (_with(BASE, 0, 1, None), BASE, False),
    "minus-zero": (_with(BASE, 2, 2, -0.0), BASE, False),
    "minus-zero-ordered": (_with(BASE, 2, 2, -0.0), BASE, True),
    "within-tolerance": (_with(BASE, 0, 2, 1.5 * (1 + 5e-5)), BASE, False),
    "outside-tolerance": (_with(BASE, 0, 2, 1.5 * (1 + 5e-4)), BASE,
                          False),
    "abs-tolerance": (_with(BASE, 2, 2, 5e-7), BASE, True),
    "outside-abs-tolerance": (_with(BASE, 2, 2, 5e-6), BASE, True),
}
EQUAL = ("equal", "equal-ordered", "nan-both", "null-both",
         "order-unordered", "minus-zero", "minus-zero-ordered",
         "within-tolerance", "abs-tolerance")


def _arrow(rows, names=NAMES):
    cols = list(zip(*rows)) if rows else [[] for _ in names]
    types = [pa.int64(), pa.string(), pa.float64()]
    return pa.Table.from_arrays(
        [pa.array(list(c), type=t) for c, t in zip(cols, types)],
        names=list(names))


def _host(rows, names=NAMES):
    return PC.HostTable(list(names), [tuple(r) for r in rows])


@pytest.mark.parametrize("case", list(CASES))
def test_same_verdict_and_message(case):
    actual, expected, ordered = CASES[case]
    want = JC.compare_tables(_arrow(actual), _arrow(expected),
                             ordered=ordered)
    got = PC.compare_tables(_host(actual), _host(expected),
                            ordered=ordered)
    assert got == want
    assert (got is None) == (case in EQUAL)


def test_column_names_differ():
    names = ["k", "t", "x"]
    assert PC.compare_tables(_host(BASE, names), _host(BASE)) == \
        JC.compare_tables(_arrow(BASE, names), _arrow(BASE))


def test_tolerances_pass_through():
    a, e = _with(BASE, 0, 2, 1.6), BASE
    for rel in (1e-4, 0.1):
        assert PC.compare_tables(_host(a), _host(e), rel_tol=rel) == \
            JC.compare_tables(_arrow(a), _arrow(e), rel_tol=rel)


def test_host_table_from_columns_equals_arrow_rows():
    rng = np.random.default_rng(3)
    k = rng.integers(-5, 5, 50).astype(np.int64)
    x = rng.normal(size=50)
    x[3] = np.nan
    s = np.empty(50, dtype=object)
    s[:] = [f"v{i}" for i in range(50)]
    valid = [rng.random(50) > 0.2 for _ in range(3)]
    s[~valid[1]] = None
    got = PC.HostTable.from_columns(NAMES, [k, s, x], valid)
    table = pa.Table.from_arrays(
        [pa.array(k, mask=~valid[0]), pa.array(list(s)),
         pa.array(x, mask=~valid[2])], names=NAMES)
    assert got.names == NAMES
    rows = [tuple(r[c] for c in NAMES) for r in table.to_pylist()]
    assert [tuple(JC._norm_value(v) for v in r) for r in got.rows] == \
        [tuple(JC._norm_value(v) for v in r) for r in rows]
    assert all(type(v) in (int, str, float, type(None))
               for r in got.rows for v in r)


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return JD.generate(str(tmp_path_factory.mktemp("tpcds")), sf=0.01,
                       seed=7)


def test_plan_is_ordered_on_the_corpus(catalog):
    for name in JQ.names():
        plan = JQ.build(name, catalog)
        port = ForeignNode.from_json(plan.to_json())
        assert PC.plan_is_ordered(port) == JC.plan_is_ordered(plan), name
    assert PC.plan_is_ordered(None) is False

"""String equality and order in auron_tpu_torch against auron_tpu on the
CPU, bit for bit:
- `exprs/strings.py::string_eq` and `string_cmp` against the JAX
  package's `strings_device.string_eq` / `string_cmp`, each side at a
  width of 8 to 256 bytes: the empty string, trailing NULs, non-ASCII
  bytes and nulls among the values; a one-row operand (the port's
  string literal) broadcast against a column;
- every comparison operator (`== != <=> < <= > >=`) of two string
  columns in different width buckets and of a column and a literal, and
  `IN` over strings, through ProjectExec and FilterExec as the same
  serialized TaskDefinition bytes in both engines.  With a null in the
  list the reference answers false where SQL answers null (ROADMAP Queue
  3 item 9): that case pins the reference and holds the port to SQL;
- string join keys through BroadcastJoin, HashJoin built on each side
  and SortMergeJoin streaming and whole-side, in every join type, the
  build and probe sides in different width buckets, ordered against
  the reference and unordered against a plain-Python join;
- IN over strings with a null of no type, which the reference cannot
  evaluate (ROADMAP Queue 3 item 21).
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from auron_tpu.columnar.batch import DeviceStringColumn as JStr
from auron_tpu.exprs import strings_device as JS_
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.it import compare
from auron_tpu_torch.columnar.batch import DeviceStringColumn
from auron_tpu_torch.exprs.strings import string_cmp, string_eq
from auron_tpu_torch.ir import serde as pserde
from auron_tpu_torch.ir.schema import DataType
from auron_tpu_torch.runtime.executor import execute_task
from auron_tpu_torch.runtime.resources import ResourceRegistry

from test_torch_joins import CASES, _assert_oracle, join_plan, run_join
from test_torch_strings import _objects, _random_strings
from torch_parity import one_thread, run_both  # noqa: F401

WIDTHS = (8, 16, 32, 64, 128, 256)
STR = JDT.string()
EDGE = ["", "ab", "ab\x00", "\x00", "é", "ÿþ", "日本", "a" * 8, "zz", "\x7f",
        "\x80x"]


def _matrix(vals, valid, w):
    """(bytes [n, w], lengths, validity) of values, zero-padded, nulls
    as zero bytes and length 0."""
    raw = [v.encode() if ok else b"" for v, ok in zip(vals, valid)]
    mat = np.zeros((len(raw), w), np.uint8)
    for i, r in enumerate(raw):
        mat[i, :len(r)] = np.frombuffer(r, np.uint8)
    return mat, np.array([len(r) for r in raw], np.int32), np.asarray(valid)


def _fit(vals, w):
    """Each value cut (by whole characters) to at most w bytes."""
    out = []
    for v in vals:
        while len(v.encode()) > w:
            v = v[:-1]
        out.append(v)
    return out


def _pair(seed, wa, wb, n=300):
    """Two string columns at widths wa and wb: a third of b's rows copy
    a's (where they fit), the rest are random; nulls on both sides."""
    rng = np.random.default_rng(seed)
    a = _fit(EDGE + _random_strings(rng, n - len(EDGE), max_len=wa), wa)
    b = _fit(_random_strings(rng, n, max_len=wb), wb)
    for i in range(0, n, 3):
        if len(a[i].encode()) <= wb:
            b[i] = a[i]
    b[1] = a[1] + "\x00" if len(a[1].encode()) < wb else b[1]
    return (_matrix(a, rng.random(n) >= 0.1, wa),
            _matrix(b, rng.random(n) >= 0.1, wb))


def _port(m):
    return DeviceStringColumn(DataType.string(), *map(torch.from_numpy, m))


def _jax(m):
    return JStr(STR, *map(jnp.asarray, m))


@pytest.mark.parametrize("wb", WIDTHS)
@pytest.mark.parametrize("wa", WIDTHS)
def test_eq_and_cmp_match_the_reference(wa, wb):
    a, b = _pair(wa * 1000 + wb, wa, wb)
    eq = string_eq(_port(a), _port(b)).numpy()
    cmp = string_cmp(_port(a), _port(b)).numpy()
    np.testing.assert_array_equal(eq, np.asarray(JS_.string_eq(_jax(a),
                                                               _jax(b))))
    np.testing.assert_array_equal(cmp, np.asarray(JS_.string_cmp(_jax(a),
                                                                 _jax(b))))
    assert cmp.dtype == np.int32
    # and each is Spark's order of the values' bytes (null rows hold b"")
    ra = [bytes(r[:k]) for r, k in zip(a[0], a[1])]
    rb = [bytes(r[:k]) for r, k in zip(b[0], b[1])]
    assert eq.tolist() == [x == y for x, y in zip(ra, rb)]
    assert cmp.tolist() == [(x > y) - (x < y) for x, y in zip(ra, rb)]
    assert eq.any() and (cmp < 0).any() and (cmp > 0).any()


@pytest.mark.parametrize("w_lit", [8, 32, 256])
def test_one_row_operand_broadcasts(w_lit):
    """A literal as one [1, W] row gives the answers of the same value
    repeated in every row, at a width above, below or equal to the
    column's (32)."""
    a, _ = _pair(5, 32, 8)
    col = _port(a)
    for i in (0, 1, 2, 7, 11):
        if a[1][i] > w_lit:
            continue
        row = np.zeros((1, w_lit), np.uint8)
        row[0, :a[1][i]] = a[0][i, :a[1][i]]
        lit = (row, a[1][i:i + 1], np.ones(1, bool))
        full = tuple(np.repeat(x, len(a[0]), 0) for x in lit)
        for fn in (string_eq, string_cmp):
            np.testing.assert_array_equal(fn(col, _port(lit)).numpy(),
                                          fn(col, _port(full)).numpy())


# -- through the operators ----------------------------------------------------

SRC = JS.of(JF("s", STR), JF("t", STR), JF("q", JDT.int32()))
OPS = ("==", "!=", "<=>", "<", "<=", ">", ">=")


def _batches(seed, n_batches=4, n=150):
    """(s, t, q): s short (width 8) and t longer (up to 40 bytes) in
    alternate batches, a third of t equal to s, nulls everywhere."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n_batches):
        s = _random_strings(rng, n, max_len=8 if j % 2 == 0 else 24)
        t = _random_strings(rng, n, max_len=40 if j % 2 == 0 else 8)
        t = [x if i % 3 else y for i, (x, y) in enumerate(zip(t, s))]
        s[:3] = ["", "TN", "ab\x00"]
        out.append(pa.RecordBatch.from_arrays(
            [pa.array(s, type=pa.string(), mask=rng.random(n) < 0.1),
             pa.array(t, type=pa.string(), mask=rng.random(n) < 0.1),
             pa.array(rng.integers(0, 100, n).astype(np.int32),
                      type=pa.int32())],
            names=["s", "t", "q"]))
    return out


def _lit(v):
    return JE.Literal(value=v, dtype=STR)


def _column(result, name):
    d, v = result.to_numpy()[name]
    return [x if ok else None for x, ok in zip(d.tolist(), v.tolist())]


def _ref_column(result, name):
    return pa.Table.from_batches(result.batches).column(name).to_pylist()


def _compare_exprs():
    s, t = JE.col("s"), JE.col("t")
    exprs, names = [], []
    for i, op in enumerate(OPS):
        for rhs, tag in ((t, "t"), (_lit("TN"), "lit"),
                         (_lit("a much longer literal than s"), "long")):
            exprs.append(JE.BinaryExpr(left=s, op=op, right=rhs))
            names.append(f"c{i}_{tag}")
    exprs.append(JE.BinaryExpr(left=_lit("b"), op="<", right=s))
    names.append("lit_lt_s")
    exprs.append(JE.InList(child=s, values=(_lit("TN"), _lit(""),
                                            _lit("ab\x00"))))
    names.append("in3")
    exprs.append(JE.InList(child=t, values=(_lit("TN"), _lit("é")),
                           negated=True))
    names.append("not_in")
    return tuple(exprs), tuple(names)


def test_comparisons_and_in_match_the_reference():
    exprs, names = _compare_exprs()
    plan = JP.Projection(child=JP.FFIReader(schema=SRC, resource_id="src"),
                         exprs=exprs, names=names)
    batches = _batches(1)
    port, ref = run_both(plan, batches, batches)
    for name in names:
        got = _column(port, name)
        assert got == _ref_column(ref, name), name
        assert any(x is False for x in got) or name.startswith("c1"), name
        if name in ("c0_t", "c0_lit", "c2_lit", "in3", "lit_lt_s") or \
                name.startswith(("c3", "c5")):
            assert any(x is True for x in got), name


def test_string_filter_matches_the_reference():
    """FilterExec over string predicates, with its fused projection."""
    s, t = JE.col("s"), JE.col("t")
    plan = JP.Projection(
        child=JP.Filter(
            child=JP.FFIReader(schema=SRC, resource_id="src"),
            predicates=(JE.BinaryExpr(left=s, op=">=", right=_lit("a")),
                        JE.InList(child=t, values=(
                            _lit("TN"), JE.col("s"), _lit("é")),
                            negated=False))),
        exprs=(s, t, JE.BinaryExpr(left=s, op="!=", right=t)),
        names=("s", "t", "ne"))
    batches = _batches(2)
    port, ref = run_both(plan, batches, batches)
    assert port.to_numpy()["s"][0].shape[0] > 0
    for name in ("s", "t", "ne"):
        assert _column(port, name) == _ref_column(ref, name)


def test_in_with_a_null_is_sql():
    """`s IN ('TN', NULL)`: true on a match, else null (SQL and the
    port); the reference answers false where no value matches (ROADMAP
    Queue 3 item 9), pinned here.  NOT IN negates, null stays null."""
    plan = JP.Projection(
        child=JP.FFIReader(schema=SRC, resource_id="src"),
        exprs=(JE.InList(child=JE.col("s"), values=(_lit("TN"), _lit(None))),
               JE.InList(child=JE.col("s"), values=(_lit("TN"), _lit(None)),
                         negated=True)),
        names=("i", "ni"))
    batches = _batches(3)
    port, ref = run_both(plan, batches, batches)
    s = [v for b in batches for v in b.column(0).to_pylist()]
    sql = [None if v is None else (True if v == "TN" else None) for v in s]
    assert _column(port, "i") == sql
    assert _column(port, "ni") == [None if x is None else not x for x in sql]
    assert True in sql
    ref_i = _ref_column(ref, "i")
    assert ref_i == [None if v is None else v == "TN" for v in s]


# -- string join keys ---------------------------------------------------------

def _string_side(seed, n, pool, null_frac=0.05):
    """(keys, key validity, int payload, string payload, validity) with
    keys from `pool`."""
    rng = np.random.default_rng(seed)
    k = _objects([pool[i] for i in rng.integers(0, len(pool), n)])
    v = rng.integers(-1000, 1000, n)
    s = np.array([f"p{int(x) % 29}" for x in v], dtype=object)
    return k, rng.random(n) >= null_frac, v, s, rng.random(n) >= null_frac


def _string_records(cols, size, names, vtype):
    k, kv, v, s, vv = cols
    t = pa.Table.from_arrays(
        [pa.array(list(k), type=pa.string(), mask=~kv),
         pa.array(v, type=vtype, mask=~vv),
         pa.array(list(s), type=pa.string(), mask=~vv)], names=names)
    return t.to_batches(max_chunksize=size)


def _string_sides():
    """The left side's keys fit 8 bytes (width 8); the right side's
    batches mix them with long unmatched keys (width 32), and a key
    with a trailing NUL that must not match its prefix."""
    short = ["", "a", "k\x00", "é"] + [f"k{i}" for i in range(60)]
    long = [f"an unmatched key of 20+ bytes {i}" for i in range(20)]
    left = _string_side(40, 500, short[:50] + ["k7\x00"])
    right = _string_side(41, 400, short[10:] + long)
    return (_string_records(left, 120, ["lk", "lv", "ls"], pa.int32()),
            _string_records(right, 100, ["rk", "rv", "rs"], pa.int64()))


@pytest.mark.parametrize("op,jt", CASES)
def test_string_keys_join_as_the_reference(op, jt):
    left, right = _string_sides()
    extra = {"auron.smj.streaming.enable": op != "smj_whole"}
    port, ref = run_join(join_plan(op, jt, key_type=STR), left, right,
                         extra)
    assert compare.compare_tables(port, ref, ordered=True) is None
    ls = JS.of(JF("lk", STR), JF("lv", JDT.int32()), JF("ls", STR))
    rs = JS.of(JF("rk", STR), JF("rv", JDT.int64()), JF("rs", STR))
    assert _assert_oracle(port, jt, left, right, ls, rs) > 0


def test_in_with_an_untyped_null_is_sql():
    """`s IN ('TN', NULL)` with the null of no type, as a front end may
    send it: the port answers as SQL does; the reference raises
    (AttributeError: it compares the string column with the null as a
    string column, ROADMAP Queue 3 item 21), pinned here."""
    plan = JP.Projection(
        child=JP.FFIReader(schema=SRC, resource_id="src"),
        exprs=(JE.InList(child=JE.col("s"), values=(
            _lit("TN"), JE.Literal(value=None, dtype=JDT.null()))),),
        names=("i",))
    batches = _batches(3)
    with pytest.raises(AttributeError, match="width"):
        run_both(plan, batches, batches)
    res = ResourceRegistry()
    res.put("src", batches)
    out = execute_task(pserde.from_json(jserde.to_json(
        JP.TaskDefinition(plan=plan))), res, device="cpu")
    s = [v for b in batches for v in b.column(0).to_pylist()]
    assert _column(out, "i") == \
        [None if v is None else (True if v == "TN" else None) for v in s]

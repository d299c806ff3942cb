"""Expression kinds of auron_tpu_torch against auron_tpu/exprs/compiler.py
on the same seeded columns: arithmetic, bitwise, comparisons, Kleene
logic, null tests, not, negative, case, in-list, casts and date
arithmetic, over nulls, NaN, -0.0, infinities, zero divisors and int64
extremes.  The expressions are built with the JAX package's IR and
reach the port through their JSON.

Tolerance: bit-exact for integers, bools, validity and finite floats
(the elementwise IEEE ops round alike); a NaN equals any NaN, since the
two engines' NaN sign bits differ (Spark canonicalises NaN wherever it
compares or hashes one).  The float columns hold no subnormals: XLA's
CPU backend flushes them to zero, Java does not (ROADMAP Queue 3 item
1), and their quotients stay far below 2^1023, where torch's vectorised
CPU `fmod` overflows.

Also the repairs of ROADMAP Queue 3 items 4, 6 and 7 (date/timestamp
casts, canonical NaN hashing, float to int8/int16 casts) with the
queue's inputs and Spark's values, and the SQL semantics the reference
approximates (a null in an IN list, try_cast overflow).
"""

import json

import numpy as np
import pytest
import torch

from auron_tpu.columnar.batch import Batch as JaxBatch
from auron_tpu.columnar.batch import DeviceColumn as JaxColumn
from auron_tpu.exprs.cast import cast_column as jax_cast
from auron_tpu.exprs.compiler import build_evaluator as jax_evaluator
from auron_tpu.exprs.compiler import build_predicate as jax_predicate
from auron_tpu.ir import expr as JE
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.ir.schema import TypeId as JT
from auron_tpu_torch.columnar.batch import DeviceColumn, from_numpy
from auron_tpu_torch.exprs import hashing as H
from auron_tpu_torch.exprs.cast import cast_column
from auron_tpu_torch.exprs.compiler import build_evaluator, build_predicate
from auron_tpu_torch.ir import serde
from auron_tpu_torch.ir.schema import DataType, Field, Schema, TypeId

import jax.numpy as jnp

N = 2000
I8, I16 = JDT(JT.INT8), JDT(JT.INT16)
I32, I64, F64, BOOL = JDT.int32(), JDT.int64(), JDT.float64(), JDT.bool_()
DATE, TS = JDT(JT.DATE32), JDT(JT.TIMESTAMP_US)
SCHEMA = JS.of(JF("a", I32), JF("b", I32), JF("x", I64), JF("y", I64),
               JF("f", F64), JF("g", F64), JF("h", F64), JF("p", BOOL),
               JF("q", BOOL), JF("s8", I8), JF("s16", I16), JF("d", DATE),
               JF("e", DATE), JF("ts", TS))
I32_X = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1, 1]
I64_X = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1, 1]
F_X = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1e300, -1e300, 2.0**63,
       -2.0**63, 2.0**31, 1e10, -1e10]


def _with_specials(rng, base, specials):
    out = base.copy()
    idx = rng.choice(len(out), 4 * len(specials), replace=False)
    out[idx] = np.repeat(np.array(specials, dtype=out.dtype), 4)
    return out


def _columns(seed: int):
    rng = np.random.default_rng(seed)
    a = _with_specials(rng, rng.integers(-1000, 1000, N, dtype=np.int32),
                       I32_X)
    b = _with_specials(rng, rng.integers(-40, 40, N, dtype=np.int32),
                       I32_X)
    x = _with_specials(rng, rng.integers(-2**62, 2**62, N, dtype=np.int64),
                       I64_X)
    y = _with_specials(rng, rng.integers(-70, 70, N, dtype=np.int64), I64_X)
    f = _with_specials(rng, np.round(rng.normal(size=N) * 1e3, 3), F_X)
    g = _with_specials(rng, np.round(rng.normal(size=N) * 10, 1),
                       [np.nan, -0.0, 0.0, np.inf, -np.inf, 3.5])
    h = np.round(rng.uniform(-127.9, 127.9, N), 2)        # in int8 range
    p, q = rng.random(N) < 0.5, rng.random(N) < 0.5
    s8 = rng.integers(-128, 128, N, dtype=np.int16).astype(np.int8)
    s16 = rng.integers(-2**15, 2**15, N, dtype=np.int32).astype(np.int16)
    d = rng.integers(-30000, 30000, N, dtype=np.int32)
    e = rng.integers(-30000, 30000, N, dtype=np.int32)
    ts = rng.integers(-2**60, 2**60, N, dtype=np.int64)
    cols = [a, b, x, y, f, g, h, p, q, s8, s16, d, e, ts]
    valid = [rng.random(N) >= 0.1 for _ in cols]
    return cols, valid


def _port_schema(jschema) -> Schema:
    return Schema(tuple(Field(f.name, DataType(TypeId[f.dtype.id.name]))
                        for f in jschema.fields))


def _port_expr(jexpr):
    return serde.from_json(json.dumps(jexpr.to_dict()))


def _run_both(exprs, seed=0, predicate=False):
    cols, valid = _columns(seed)
    jb = JaxBatch.from_numpy(SCHEMA, cols, valid)
    jout = (jax_predicate if predicate else jax_evaluator)(
        tuple(exprs), SCHEMA)(jb)
    pschema = _port_schema(SCHEMA)
    pb = from_numpy(pschema, cols, valid, device="cpu")
    port_exprs = [_port_expr(x) for x in exprs]
    pout = (build_predicate if predicate else build_evaluator)(
        port_exprs, pschema)(pb)
    return jout, pout


def _assert_same(jout, pout, exprs):
    assert len(jout) == len(pout)
    for x, j, p in zip(exprs, jout, pout):
        what = json.dumps(x.to_dict())[:200]
        assert p.dtype.id.name == j.dtype.id.name, what
        jv = np.asarray(j.validity)[:N]
        pv = p.validity[:N].numpy()
        np.testing.assert_array_equal(pv, jv, err_msg=what)
        pd = p.data[:N].numpy()
        jd = np.asarray(j.data)[:N].astype(pd.dtype)
        assert not pd[~pv].any(), f"data under a null: {what}"
        if pd.dtype.kind == "f":
            nan = np.isnan(pd)
            np.testing.assert_array_equal(nan[pv], np.isnan(jd)[pv],
                                          err_msg=what)
            ok = pv & ~nan
            np.testing.assert_array_equal(pd[ok].view(np.int64),
                                          jd[ok].view(np.int64),
                                          err_msg=what)
        else:
            np.testing.assert_array_equal(pd[pv], jd[pv], err_msg=what)


def _check(exprs, seed=0):
    jout, pout = _run_both(exprs, seed)
    _assert_same(jout, pout, exprs)


def _bin(l, op, r):
    l = JE.col(l) if isinstance(l, str) else l
    r = JE.col(r) if isinstance(r, str) else r
    return JE.BinaryExpr(left=l, op=op, right=r)


def lit(v, dt):
    return JE.Literal(value=v, dtype=dt)


ARITH_PAIRS = [("a", "b"), ("x", "y"), ("f", "g"), ("a", "x"), ("b", "f"),
               ("y", "g"), ("s8", "s16"), ("s16", "b")]


@pytest.mark.parametrize("l,r", ARITH_PAIRS)
def test_arithmetic_matches(l, r):
    _check([_bin(l, op, r) for op in ("+", "-", "*", "/")])


@pytest.mark.parametrize("seed", [1, 2])
def test_arithmetic_with_literals_matches(seed):
    _check([_bin("x", "+", lit(1, I64)), _bin("x", "-", lit(-1, I64)),
            _bin("a", "*", lit(3, I32)), _bin("f", "/", lit(0.0, F64)),
            _bin("a", "%", lit(0, I32)), _bin("x", "/", lit(-1, I64)),
            _bin("x", "%", lit(-1, I64)), _bin("x", "*", lit(None, I64)),
            _bin(lit(np.iinfo(np.int64).min, I64), "/", "y")], seed)


def _java_rem(a, b):
    """Java's % (the oracle): C's truncated remainder, np.fmod, whose
    sign is the dividend's; x % -1 is 0; a zero divisor is Spark's null."""
    zero = b == 0
    bb = np.where(zero | (b == -1), 1, b).astype(b.dtype)
    return np.fmod(a, bb), ~zero


@pytest.mark.parametrize("l,r", ARITH_PAIRS)
def test_remainder_is_javas(l, r):
    """`%` against Java's remainder (np.fmod) on every row, bit for bit,
    and integer `%` against the JAX package away from the type's
    minimum.  The JAX package's integer form sign(a) * (|a| mod |b|)
    overflows at the minimum; its float form a - trunc(a / b) * b is off
    wherever a / b rounds across an integer (7 % 0.1), loses the
    remainder once the quotient passes 2^53, gives NaN for a finite
    dividend over an infinite divisor and 0.0 for Java's -0.0 (ROADMAP
    Queue 3 item 8), so float `%` is held to Java's alone."""
    x = _bin(l, "%", r)
    jout, pout = _run_both([x])
    cols, valid = _columns(0)
    names = [f.name for f in SCHEMA.fields]
    p = pout[0]
    t = p.data.numpy().dtype
    a = cols[names.index(l)].astype(t)
    b = cols[names.index(r)].astype(t)
    exp, ok = _java_rem(a, b)
    pv = valid[names.index(l)] & valid[names.index(r)] & ok
    got, gv = p.data[:N].numpy(), p.validity[:N].numpy()
    np.testing.assert_array_equal(gv, pv)
    if t.kind == "f":
        np.testing.assert_array_equal(np.isnan(got[pv]), np.isnan(exp[pv]))
        fin = pv & ~np.isnan(exp)
        np.testing.assert_array_equal(got[fin].view(np.int64),
                                      exp[fin].view(np.int64))
        return
    np.testing.assert_array_equal(got[pv], exp[pv])
    sel = pv & (a != np.iinfo(t).min)
    assert sel.sum() > N // 2
    np.testing.assert_array_equal(got[sel],
                                  np.asarray(jout[0].data)[:N][sel])


def test_division_by_a_literal_is_correctly_rounded():
    """x / 7 is the correctly rounded quotient, as Java's; XLA folds a
    division by a constant into a multiplication by its reciprocal, one
    ulp off on a third of the rows (ROADMAP Queue 3 item 8)."""
    cols, valid = _columns(3)
    pschema = _port_schema(SCHEMA)
    b = from_numpy(pschema, cols, valid, device="cpu")
    [q] = build_evaluator([_port_expr(_bin("a", "/", lit(7, I32)))],
                          pschema)(b)
    exp = cols[0].astype(np.float64) / 7.0
    v = valid[0]
    np.testing.assert_array_equal(q.validity[:N].numpy(), v)
    np.testing.assert_array_equal(q.data[:N].numpy()[v].view(np.int64),
                                  exp[v].view(np.int64))


def test_remainder_faults_of_the_reference():
    """The JAX package's values where Java's % differs (Queue 3 item 8);
    the port gives Java's."""
    schema = _port_schema(JS.of(JF("a", I64), JF("b", I64),
                                JF("f", F64), JF("g", F64)))
    cols = [np.array([np.iinfo(np.int64).min, 7], np.int64),
            np.array([46, np.iinfo(np.int64).min], np.int64),
            np.array([1e300, 39.0]), np.array([5.8, np.inf])]
    b = from_numpy(schema, cols, device="cpu")
    ints, floats = build_evaluator([_port_expr(_bin("a", "%", "b")),
                                    _port_expr(_bin("f", "%", "g"))],
                                   schema)(b)
    assert ints.data[:2].tolist() == [-26, 7]
    assert floats.data[:2].tolist() == np.fmod(cols[2], cols[3]).tolist()
    assert floats.data[1].item() == 39.0


@pytest.mark.parametrize("l,r", [("a", "b"), ("x", "y"), ("p", "q"),
                                 ("s8", "s16"), ("b", "x")])
def test_bitwise_matches(l, r):
    ops = ("&", "|", "^") if l == "p" else ("&", "|", "^", "<<", ">>")
    _check([_bin(l, op, r) for op in ops] +
           ([_bin(l, "<<", lit(70, I32)), _bin(l, ">>", lit(-3, I32))]
            if l == "a" else []))


CMP_OPS = ("==", "!=", "<", "<=", ">", ">=", "<=>")


@pytest.mark.parametrize("l,r", [("a", "b"), ("x", "y"), ("f", "g"),
                                 ("a", "f"), ("x", "a"), ("d", "e"),
                                 ("p", "q"), ("s8", "a"), ("g", "h")])
def test_comparisons_match(l, r):
    _check([_bin(l, op, r) for op in CMP_OPS])


def test_comparisons_with_literals_match():
    """NaN equals NaN and sorts above every number; -0.0 equals 0.0."""
    _check([_bin("f", op, lit(v, F64)) for op in CMP_OPS
            for v in (np.nan, 0.0, -0.0, np.inf)] +
           [_bin("a", ">=", lit(20, I32)), _bin("f", "<", lit(120.0, F64)),
            _bin("x", "<=>", lit(None, I64))])


def test_logic_and_null_tests_match():
    null_b = lit(None, BOOL)
    _check([_bin("p", "and", "q"), _bin("p", "or", "q"),
            JE.ScAnd(left=JE.col("p"), right=JE.col("q")),
            JE.ScOr(left=JE.col("p"), right=JE.col("q")),
            _bin("p", "and", null_b), _bin(null_b, "or", "q"),
            JE.ScAnd(left=_bin("a", ">", lit(0, I32)),
                     right=_bin("f", "<", lit(0.0, F64))),
            JE.Not(child=JE.col("p")),
            JE.Not(child=_bin("f", ">", "g"))] +
           [JE.IsNull(child=JE.col(c)) for c in ("a", "f", "p", "d")] +
           [JE.IsNotNull(child=JE.col(c)) for c in ("x", "g", "q", "ts")] +
           [JE.Negative(child=JE.col(c)) for c in ("a", "x", "f", "s8")])


def test_predicate_matches():
    """build_predicate: the conjunction of several predicates."""
    preds = [_bin("a", ">=", lit(20, I32)), _bin("f", "<", lit(120.0, F64)),
             JE.IsNotNull(child=JE.col("x"))]
    jout, pout = _run_both(preds, predicate=True)
    _assert_same(jout, pout, preds[:1])


def _case(branches, else_expr=None):
    return JE.Case(branches=tuple(JE.WhenThen(when=w, then=t)
                                  for w, t in branches), else_expr=else_expr)


def test_case_matches():
    _check([
        _case([(_bin("a", ">", lit(0, I32)), JE.col("x")),
               (_bin("a", "<", lit(-500, I32)), JE.col("y"))],
              lit(0, I64)),
        _case([(JE.col("p"), JE.col("f"))], JE.col("a")),
        _case([(JE.col("q"), lit(None, I64))], JE.col("x")),
        _case([(_bin("f", ">", lit(0.0, F64)), lit(1, I64))]),
        _case([(JE.ScAnd(left=_bin("a", ">", lit(20, I32)),
                         right=_bin("a", "<=", lit(60, I32))),
                lit(1, I64))], lit(0, I64)),
        _case([(JE.IsNull(child=JE.col("d")), JE.col("e"))], JE.col("d")),
        _case([(_bin("f", "==", "f"), JE.col("s8")),
               (JE.col("p"), JE.col("s16"))], JE.col("b")),
    ])


def test_in_list_matches():
    _check([
        JE.InList(child=JE.col("a"), values=(lit(1, I32), lit(-1, I32),
                                             lit(0, I32))),
        JE.InList(child=JE.col("a"), values=(lit(5, I32), lit(6, I64)),
                  negated=True),
        JE.InList(child=JE.col("f"), values=(lit(np.nan, F64),
                                             lit(0.0, F64))),
        JE.InList(child=JE.col("x"), values=(
            lit(np.iinfo(np.int64).min, I64), lit(1, I64)))])


def test_in_list_with_a_null_is_sql():
    """x IN (.., null) is null where no value matches (and NOT IN too);
    the JAX package takes the child's validity instead."""
    cols, valid = [np.array([1, 2, 3], np.int32)], [np.array([1, 1, 0],
                                                            bool)]
    schema = _port_schema(JS.of(JF("a", I32)))
    b = from_numpy(schema, cols, valid, device="cpu")
    for negated in (False, True):
        x = JE.InList(child=JE.col("a"), values=(lit(1, I32),
                                                 lit(None, I32)),
                      negated=negated)
        [out] = build_evaluator([_port_expr(x)], schema)(b)
        assert out.validity[:3].tolist() == [True, False, False]
        assert out.data[:1].tolist() == [not negated]


CAST_SOURCES = ["a", "x", "f", "p", "s8", "s16", "y"]
CAST_TARGETS = [BOOL, I8, I16, I32, I64, F64]


@pytest.mark.parametrize("src", CAST_SOURCES)
def test_casts_match(src):
    """Every numeric cast; float to int8/int16 on the in-range column h
    only, since the JAX package saturates at the byte's bounds there
    (Queue 3 item 7: see test_float_to_int8_int16_casts_are_sparks)."""
    targets = CAST_TARGETS if src != "f" else [BOOL, I32, I64, F64]
    _check([JE.Cast(child=JE.col(src), dtype=t) for t in targets])


def test_casts_in_range_and_temporal_match():
    _check([JE.Cast(child=JE.col("h"), dtype=t) for t in CAST_TARGETS] +
           [JE.Cast(child=JE.col("d"), dtype=TS),
            JE.Cast(child=JE.col("ts"), dtype=DATE),
            JE.TryCast(child=JE.col("h"), dtype=I32),
            JE.TryCast(child=JE.col("s8"), dtype=I64),
            JE.TryCast(child=JE.col("a"), dtype=F64)])


def test_date_arithmetic_matches():
    _check([_bin("d", "+", "a"), _bin("d", "-", "a"), _bin("d", "-", "e"),
            _bin("d", "+", lit(1, I32)), _bin("d", "-", lit(30, I32)),
            _bin("d", "+", "s8"), _bin("d", "+", "x")])


# -- repairs of ROADMAP Queue 3 ----------------------------------------------

def _port_col(dtype: DataType, values, device="cpu"):
    t = torch.tensor(values, dtype=dtype.torch_dtype(), device=device)
    return DeviceColumn(dtype, t, torch.ones(len(values), dtype=torch.bool,
                                             device=device))


def _jax_col(dtype, values, np_dtype):
    return JaxColumn(dtype, jnp.asarray(np.array(values, np_dtype)),
                     jnp.ones(len(values), bool))


def test_date_to_timestamp_cast_is_days_times_micros():
    """Queue 3 item 4: the port read days as microseconds."""
    days = [-1, 0, 1, 19000]
    got = cast_column(_port_col(DataType.date32(), days),
                      DataType.timestamp_us())
    exp = [-86400000000, 0, 86400000000, 1641600000000000]
    assert got.data.tolist() == exp
    ref = jax_cast(_jax_col(DATE, days, np.int32), TS)
    assert np.asarray(ref.data).tolist() == exp


def test_timestamp_to_date_cast_floor_divides():
    """Queue 3 item 4: the port truncated the int64 to int32."""
    us = [-1, 0, 86400000005, 1641600000000000]
    got = cast_column(_port_col(DataType.timestamp_us(), us),
                      DataType.date32())
    assert got.data.dtype == torch.int32
    assert got.data.tolist() == [-1, 0, 1, 19000]
    ref = jax_cast(_jax_col(TS, us, np.int64), DATE)
    assert np.asarray(ref.data).tolist() == [-1, 0, 1, 19000]


@pytest.mark.parametrize("dst,exp", [
    (TypeId.INT8, [44, 56, -1, 0, -1, 0, 127]),
    (TypeId.INT16, [300, -200, -1, 0, -1, 0, 127])])
def test_float_to_int8_int16_casts_are_sparks(dst, exp):
    """Queue 3 item 7: Spark's castToByte/castToShort compute
    toInt(x).toByte/.toShort, saturating at the int range and then
    wrapping; the JAX package saturates at the byte's own bounds."""
    vals = [300.0, -200.0, 1e10, np.nan, np.inf, -np.inf, 127.9]
    got = cast_column(_port_col(DataType.float64(), vals), DataType(dst))
    assert got.data.tolist() == exp
    ref = jax_cast(_jax_col(F64, vals, np.float64), JDT(JT[dst.name]))
    assert np.asarray(ref.data).tolist()[2] != exp[2]    # the reference's
    # int16 target: 70000 wraps to 4464
    got = cast_column(_port_col(DataType.float64(), [70000.0]),
                      DataType(TypeId.INT16))
    assert got.data.tolist() == [4464]


def test_try_cast_overflow_is_null():
    """Spark's try_cast: NaN, a float outside the target's range and an
    integer outside a narrower target give null."""
    got = cast_column(_port_col(DataType.float64(),
                                [300.0, -128.5, 127.9, np.nan, -1e10]),
                      DataType(TypeId.INT8), try_=True)
    assert got.validity.tolist() == [False, True, True, False, False]
    assert got.data.tolist() == [0, -128, 127, 0, 0]
    got = cast_column(_port_col(DataType.int64(), [2**31, -2**31, 7]),
                      DataType.int32(), try_=True)
    assert got.validity.tolist() == [False, True, True]
    got = cast_column(_port_col(DataType.int32(), [2**31 - 1]),
                      DataType.int64(), try_=True)
    assert got.validity.tolist() == [True]


def test_every_nan_hashes_as_the_canonical_nan():
    """Queue 3 item 6: Spark hashes Double.doubleToLongBits, which maps
    every NaN to 0x7FF8000000000000."""
    bits = np.array([0x7FF8000000000000, 0xFFF8000000000000,
                     0x7FF0000000000001], dtype=np.uint64).view(np.int64)
    v = torch.from_numpy(bits.copy()).view(torch.float64)
    col = DeviceColumn(DataType.float64(), v, torch.ones(3, dtype=torch.bool))
    got = H.hash_columns([col], seed=42).tolist()
    assert got == [-1281358385] * 3
    canon = DeviceColumn(DataType.int64(),
                         torch.tensor([0x7FF8000000000000]),
                         torch.ones(1, dtype=torch.bool))
    assert H.hash_columns([canon], seed=42).tolist() == [-1281358385]

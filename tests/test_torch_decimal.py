"""Decimal(p <= 18) columns of auron_tpu_torch against auron_tpu on the
same seeded inputs: a decimal is the int64 unscaled value in both
engines, made with numpy and fed to each as it is.

Bit for bit against the JAX package: casts, arithmetic, comparisons,
literals, IN, `round`, `check_overflow`, `make_decimal`,
`unscaled_value`, hashes and partition ids (through the hash-pid plain
version), sort words, permutations and range ids, the Sum, Average, Min,
Max and First specs and `AggExec` partial -> final, window aggregates,
the three join operators on a decimal key, the spill tiers, the plan
JSON both ways, and a foreign plan through both sessions.  Where the JAX
package departs from Spark (ROADMAP Queue 3 items 8 and 24-31) the test
pins Spark's answer and the reference's, on the queue's input.  A
decimal of more than 18 digits has no device layout here and stays
foreign.
"""

import decimal
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auron_tpu.columnar.batch import Batch as JaxBatch
from auron_tpu.exprs.compiler import build_evaluator as jax_evaluator
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu_torch.columnar.batch import from_numpy
from auron_tpu_torch.exprs.compiler import build_evaluator
from auron_tpu_torch.ir import serde
from auron_tpu_torch.ir.schema import DataType, Field, Schema, TypeId

import torch_parity as TP
from torch_parity import one_thread  # noqa: F401

N = 3000
D = decimal.Decimal
I32, I64, F64 = JDT.int32(), JDT.int64(), JDT.float64()
D72, D94, D100, D182 = (JDT.decimal(7, 2), JDT.decimal(9, 4),
                        JDT.decimal(10, 0), JDT.decimal(18, 2))
D1810 = JDT.decimal(18, 10)
SCHEMA = JS.of(JF("a", D72), JF("b", D72), JF("c", D94), JF("q", D100),
               JF("w", D182), JF("z", D1810), JF("i", I32), JF("l", I64),
               JF("f", F64))


def _unscaled(rng, digits: int, n: int) -> np.ndarray:
    """Unscaled values of `digits` digits: uniform, ties at the last
    digit (…5), zeros and the extremes +-(10^digits - 1)."""
    top = 10 ** digits
    u = rng.integers(-top + 1, top, n, dtype=np.int64)
    u[::7] = (u[::7] // 10) * 10 + 5
    u[::29] = 0
    u[1::31], u[2::31] = top - 1, -top + 1
    return u


def columns(seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    a, b = _unscaled(rng, 7, n), _unscaled(rng, 7, n)
    b[::11] = 0                                      # zero divisors
    b[3::13] = a[3::13]                              # equal values
    c = _unscaled(rng, 9, n)
    c[5::17] = a[5::17] * 100                        # a's value at scale 4
    q = rng.integers(-2000, 2000, n, dtype=np.int64)
    w = _unscaled(rng, 18, n)
    z = _unscaled(rng, 18, n)
    i = rng.integers(-100_000, 100_000, n, dtype=np.int32)
    i[::9] = (a[::9] // 100).astype(np.int32)        # a's value as int
    l = rng.integers(-10**12, 10**12, n, dtype=np.int64)
    f = np.round(rng.normal(size=n) * 1e4, 2)
    cols = [a, b, c, q, w, z, i, l, f]
    valid = [rng.random(n) >= 0.08 for _ in cols]
    return cols, valid


def port_type(jt) -> DataType:
    return DataType(TypeId[jt.id.name], jt.precision, jt.scale)


def port_schema(js) -> Schema:
    return Schema(tuple(Field(f.name, port_type(f.dtype), f.nullable)
                        for f in js.fields))


def port_expr(jexpr):
    return serde.from_json(json.dumps(jexpr.to_dict()))


def run_exprs(exprs, seed=0, schema=SCHEMA, cols=None):
    if cols is None:
        cols, valid = columns(seed)
    else:
        cols, valid = cols
    n = len(cols[0])
    jout = jax_evaluator(tuple(exprs), schema)(
        JaxBatch.from_numpy(schema, cols, valid))
    pb = from_numpy(port_schema(schema), cols, valid, device="cpu")
    pout = build_evaluator([port_expr(x) for x in exprs],
                           port_schema(schema))(pb)
    return [(np.asarray(j.data)[:n], np.asarray(j.validity)[:n], j.dtype)
            for j in jout], \
        [(p.data[:n].numpy(), p.validity[:n].numpy(), p.dtype) for p in pout]


# a float computed from a decimal's value: the JAX package's jitted
# division by 10^scale is a multiply by its reciprocal, an ulp off the
# correctly rounded quotient the port (and Spark) give on some rows
# (ROADMAP Queue 3 item 8; `test_decimal_to_double_is_correctly_rounded`)
FLOAT_TOL = (1e-12, 1e-9)


def assert_same(jout, pout, exprs, float_tol=None):
    for x, (jd, jv, jt), (pd, pv, pt) in zip(exprs, jout, pout):
        what = json.dumps(x.to_dict())[:240]
        assert (pt.id.name, pt.precision, pt.scale) == \
            (jt.id.name, jt.precision, jt.scale), what
        np.testing.assert_array_equal(pv, jv, err_msg=what)
        assert not pd[~pv].astype(bool).any(), f"data under a null: {what}"
        jd = jd.astype(pd.dtype)
        if pd.dtype.kind == "f" and float_tol:
            np.testing.assert_allclose(pd[pv], jd[pv], rtol=float_tol[0],
                                       atol=float_tol[1], err_msg=what)
        elif pd.dtype.kind == "f":
            bits = f"u{pd.itemsize}"
            np.testing.assert_array_equal(pd[pv].view(bits),
                                          jd[pv].view(bits), err_msg=what)
        else:
            np.testing.assert_array_equal(pd[pv], jd[pv], err_msg=what)


def check(exprs, seed=0, float_tol=None):
    jout, pout = run_exprs(exprs, seed)
    assert_same(jout, pout, exprs, float_tol)


def col(name):
    return JE.col(name)


def bin_(l, op, r):
    l = col(l) if isinstance(l, str) else l
    r = col(r) if isinstance(r, str) else r
    return JE.BinaryExpr(left=l, op=op, right=r)


def cast(x, dt):
    return JE.Cast(child=col(x) if isinstance(x, str) else x, dtype=dt)


def fn(name, *args, rt=None):
    return JE.ScalarFunctionCall(
        name=name, args=tuple(col(a) if isinstance(a, str) else a
                              for a in args),
        return_type=rt if rt is not None else JDT.null())


def lit(v, dt):
    return JE.Literal(value=v, dtype=dt)


# -- casts ---------------------------------------------------------------

CASTS = {
    "rescale_up": [cast("a", D94), cast("a", JDT.decimal(18, 6)),
                   cast("a", JDT.decimal(7, 2)), cast("q", D182)],
    "rescale_down_half_up": [cast("a", JDT.decimal(6, 1)),
                             cast("c", D72), cast("c", JDT.decimal(5, 0)),
                             cast("w", JDT.decimal(18, 0))],
    "overflow_is_null": [cast("a", JDT.decimal(4, 2)),
                         cast("w", JDT.decimal(10, 2)),
                         cast("c", JDT.decimal(3, 1))],
    "to_float": [cast("a", F64), cast("c", F64), cast("w", F64),
                 cast("a", JDT.float32()), cast("z", F64)],
    "to_int_and_bool": [cast("a", I32), cast("a", I64), cast("c", I64),
                        cast("q", JDT.int16()), cast("a", JDT.bool_())],
    "from_int": [cast("i", D72), cast("i", JDT.decimal(12, 2)),
                 cast("l", JDT.decimal(18, 3)), cast("l", D100),
                 cast(lit(True, JDT.bool_()), D72)],
}


@pytest.mark.parametrize("kind", list(CASTS))
def test_casts_match(kind):
    check(CASTS[kind], float_tol=FLOAT_TOL)


def test_decimal_to_double_is_correctly_rounded():
    """Spark's `Decimal.toDouble` is `BigDecimal.doubleValue`, the double
    nearest the value; so is the port's wherever the unscaled value is
    below 2^53 (one correctly rounded division), and within an ulp past
    it.  The JAX package's jitted `unscaled / 10^scale` is `unscaled *
    (1 / 10^s)`: -0.07 (unscaled -7, scale 2) gives -0.07000000000000001
    there (ROADMAP Queue 3 item 8)."""
    cols, valid = columns(0)
    exprs = [cast("a", F64), cast("c", F64), cast("w", F64)]
    _, pout = run_exprs(exprs, cols=(cols, valid))
    names = [f.name for f in SCHEMA.fields]
    for (pd, pv, _), (name, scale) in zip(pout, (("a", 2), ("c", 4),
                                                 ("w", 2))):
        u = cols[names.index(name)]
        exact = np.array([float(D(int(x)).scaleb(-scale)) for x in u])
        small = pv & (np.abs(u) < 2**53)
        np.testing.assert_array_equal(pd[small], exact[small])
        np.testing.assert_allclose(pd[pv], exact[pv], rtol=2.3e-16, atol=0)
    one = ([np.full(9, -7, np.int64)] * 9, [np.ones(9, bool)] * 9)
    j, p = run_exprs([cast("a", F64)], cols=one)
    assert p[0][0][0] == -0.07
    assert j[0][0][0] == -0.07000000000000001


def test_float_to_decimal_away_from_ties_matches():
    """A double cast to a decimal off the rounding ties, where the float
    product and Spark's shortest text round alike."""
    rng = np.random.default_rng(3)
    f = np.round(rng.normal(size=N) * 1e5, 2)
    f[::13], f[1::13], f[2::13] = np.inf, -1e300, -0.0
    schema = JS.of(JF("f", F64))
    exprs = [cast("f", JDT.decimal(10, 2)), cast("f", JDT.decimal(12, 4)),
             cast("f", JDT.decimal(6, 0)), cast("f", JDT.decimal(5, 2))]
    jout, pout = run_exprs(exprs, schema=schema,
                           cols=([f], [np.ones(N, bool)]))
    assert_same(jout, pout, exprs)


# -- arithmetic, comparisons, literals -----------------------------------

ARITH = {
    "same_scale_add_sub": [bin_("a", "+", "b"), bin_("a", "-", "b"),
                           bin_("w", "+", "w"), bin_("a", "+", "a")],
    "through_float": [bin_("a", "*", "b"), bin_("a", "*", "q"),
                      bin_("a", "+", "c"), bin_("a", "-", "i"),
                      bin_("a", "*", "f")],
    "division": [bin_("a", "/", "b"), bin_("a", "/", "q"),
                 bin_("c", "/", "a"), bin_("i", "/", "a")],
    "negative": [JE.Negative(child=col("a")), JE.Negative(child=col("w"))],
}


@pytest.mark.parametrize("kind", list(ARITH))
def test_arithmetic_matches(kind):
    check(ARITH[kind], float_tol=FLOAT_TOL)


CMP = ["==", "!=", "<", "<=", ">", ">=", "<=>"]
_PY_CMP = {"==": np.equal, "<=>": np.equal, "!=": np.not_equal,
           "<": np.less, "<=": np.less_equal, ">": np.greater,
           ">=": np.greater_equal}


@pytest.mark.parametrize("op", CMP)
def test_comparisons_are_exact(op):
    """A decimal beside a decimal of the same or another scale, an
    integer or a literal compares its exact value, as Spark does: held
    to numpy's integer comparison at the wider scale."""
    cols, valid = columns(1)
    names = [f.name for f in SCHEMA.fields]
    c_of = {n: (cols[names.index(n)].astype(np.int64),
                valid[names.index(n)]) for n in names}
    c_of["k"] = (np.full(N, 1235, np.int64), np.ones(N, bool))
    scale = {"a": 2, "b": 2, "c": 4, "i": 0, "w": 2, "k": 2}
    pairs = [("a", "b"), ("a", "c"), ("c", "a"), ("a", "i"), ("i", "a"),
             ("w", "a")]
    exprs = [bin_(x, op, y) for x, y in pairs] + \
        [bin_("a", op, lit(D("12.35"), D72))]
    _, pout = run_exprs(exprs, cols=(cols, valid))
    for (x, y), (pd, pv, _) in zip(pairs + [("a", "k")], pout):
        (xu, xv), (yu, yv) = c_of[x], c_of[y]
        s = max(scale[x], scale[y])
        exp = _PY_CMP[op](xu * 10 ** (s - scale[x]), yu * 10 ** (s - scale[y]))
        if op == "<=>":
            np.testing.assert_array_equal(pv, np.ones(N, bool))
            exp = np.where(xv & yv, exp, ~xv & ~yv)
        else:
            np.testing.assert_array_equal(pv, xv & yv)
        np.testing.assert_array_equal(pd[pv], exp[pv], err_msg=f"{x}{op}{y}")


@pytest.mark.parametrize("op", CMP)
def test_comparisons_match_the_reference(op):
    """Where float64 holds both values apart (7 digits at one scale, an
    int64 beside a literal), the JAX package's float comparison agrees."""
    check([bin_("a", op, "b"), bin_("a", op, lit(D("12.35"), D72)),
           bin_("q", op, lit(7, I64)), bin_("q", op, "i")])


def test_literals_and_in_list_match():
    check([lit(D("-123.45"), D72), lit(12345, D72), lit(None, D72),
           bin_("a", "+", lit(D("0.05"), D72)),
           JE.InList(child=col("a"), values=(lit(D("0.00"), D72),
                                             lit(D("99999.99"), D72))),
           JE.InList(child=col("a"), values=(lit(D("0.05"), D72),),
                     negated=True),
           JE.Case(branches=(JE.WhenThen(when=bin_("a", ">", "b"),
                                         then=col("a")),),
                   else_expr=col("b"))])


# -- the decimal functions -----------------------------------------------

FUNCS = {
    "round": [fn("round", "a", lit(1, I32)), fn("round", "a", lit(0, I32)),
              fn("round", "a", lit(-2, I32)), fn("round", "c", lit(2, I32)),
              fn("round", "a", lit(3, I32)), fn("round", "w", lit(-1, I32))],
    "check_overflow": [
        fn("check_overflow", bin_(cast("q", D100), "*", "a"), rt=D182),
        fn("check_overflow", bin_("a", "*", "b"),
           rt=JDT.decimal(15, 4)),
        fn("check_overflow", "c", rt=D72),
        fn("check_overflow", bin_("a", "+", "b"), rt=JDT.decimal(7, 2))],
    "make_decimal_unscaled_value": [
        fn("make_decimal", "l", rt=JDT.decimal(12, 2)),
        fn("make_decimal", "l", rt=JDT.decimal(18, 4)),
        fn("unscaled_value", "a"), fn("unscaled_value", "w")],
}


@pytest.mark.parametrize("kind", list(FUNCS))
def test_decimal_functions_match(kind):
    check(FUNCS[kind])


# -- hashes, partition ids, sort words and range ids ------------------------

def _pair(name, seed=0):
    """(port column, JAX column) of one of `columns`' decimal columns."""
    from auron_tpu.columnar.batch import DeviceColumn as JCol
    from auron_tpu_torch.columnar.batch import DeviceColumn
    cols, valid = columns(seed)
    k = [f.name for f in SCHEMA.fields].index(name)
    jt = SCHEMA.fields[k].dtype
    data = np.where(valid[k], cols[k], 0)
    return (DeviceColumn(port_type(jt), torch.from_numpy(data),
                         torch.from_numpy(valid[k])),
            JCol(jt, jnp.asarray(data), jnp.asarray(valid[k])))


@pytest.mark.parametrize("names", [("a",), ("w",), ("c", "i"), ("z", "a")],
                         ids="-".join)
def test_hashes_match(names):
    """Spark hashes a decimal(p <= 18) as hashLong(unscaled), alone and
    chained with other keys."""
    from auron_tpu.exprs import hashing as JH
    from auron_tpu_torch.exprs import hashing as H
    cols, valid = columns(2)
    idx = [[f.name for f in SCHEMA.fields].index(n) for n in names]
    schema = JS(tuple(SCHEMA.fields[k] for k in idx))
    jb = JaxBatch.from_numpy(schema, [cols[k] for k in idx],
                             [valid[k] for k in idx])
    pb = from_numpy(port_schema(schema), [cols[k] for k in idx],
                    [valid[k] for k in idx], device="cpu")
    exp = np.asarray(JH.hash_columns(jb.columns, 42))[:N]
    got = H.hash_columns(pb.columns, 42)[:N].numpy()
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("n_parts", [1, 7, 200])
@pytest.mark.parametrize("name", ["a", "w"])
def test_single_decimal_key_partition_ids_match(name, n_parts):
    """A hash exchange on one decimal key takes the hash-pid kernel's
    route (its plain version here) and gives the JAX package's ids."""
    from auron_tpu.ops.shuffle.partitioner import PartitionIdComputer as JP_
    from auron_tpu_torch.ops import kernels_cuda
    from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer
    cols, valid = columns(4)
    part = JP.Partitioning(mode="hash", num_partitions=n_parts,
                           expressions=(col(name),))
    exp = np.asarray(JP_(part, SCHEMA)(
        JaxBatch.from_numpy(SCHEMA, cols, valid)))[:N]
    calls = []
    plain = kernels_cuda.hash_partition_ids_i64

    def counted(*a):
        calls.append(a[0].dtype)
        return plain(*a)
    kernels_cuda.hash_partition_ids_i64 = counted
    try:
        got = PartitionIdComputer(port_expr(part), port_schema(SCHEMA))(
            from_numpy(port_schema(SCHEMA), cols, valid, device="cpu"))
    finally:
        kernels_cuda.hash_partition_ids_i64 = plain
    np.testing.assert_array_equal(got.numpy(), exp)
    assert calls == ([] if n_parts == 1 else [torch.int64])


def _as_port_word(w):
    a = np.asarray(w)
    if a.dtype == np.uint64:
        return (a ^ np.uint64(1 << 63)).view(np.int64)
    return a.astype(np.int64)


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False),
                                             (True, False)])
@pytest.mark.parametrize("name", ["a", "w", "z"])
def test_sort_words_match(name, asc, nulls_first):
    """A decimal key is one 64-bit word of its unscaled value; the host
    encoder of range bounds gives the same words."""
    from auron_tpu.ops import sort_keys as JK
    from auron_tpu_torch.ops import sort_keys as SK
    from auron_tpu_torch.ops.sort import _np_encode_key
    port, jax = _pair(name, seed=5)
    got = SK.encode_key_column(port, asc, nulls_first)
    exp = JK.encode_key_column(jax, asc, nulls_first)
    assert [g.numpy().tolist() for g in got] == \
        [_as_port_word(e).tolist() for e in exp]
    assert SK.encode_key_column_bits(port) == JK.encode_key_column_bits(jax)
    host = _np_encode_key(port.data.numpy(), port.validity.numpy(),
                          port.dtype, asc, nulls_first)
    assert [h.tolist() for h in host] == [g.numpy().tolist() for g in got]


@pytest.mark.parametrize("strategy", ["radix", "argsort"])
def test_sort_permutation_matches(strategy):
    """SortExec by (a DESC NULLS LAST, c ASC NULLS FIRST) over several
    batches, through the same plan bytes in both engines."""
    from auron_tpu_torch.config import conf
    cols, valid = columns(6)
    for arr in (cols[0], cols[2]):               # ties on both keys
        arr[:] = arr % 50
    plan = JP.Sort(child=JP.FFIReader(schema=SCHEMA, resource_id="src"),
                   sort_exprs=(JE.SortExpr(child=col("a"), asc=False,
                                           nulls_first=False),
                               JE.SortExpr(child=col("c"), asc=True,
                                           nulls_first=True)))
    parts = TP.chunks(cols, valid, 700)
    with conf.scoped({"auron.kernel.sort.strategy": strategy}):
        port, jax = TP.run_both(plan, [TP.to_arrow(*p, schema=SCHEMA)
                                       for p in parts], parts)
    names = [f.name for f in SCHEMA.fields]
    TP.assert_same_rows(port.to_numpy(), TP.jax_columns(jax.batches, names),
                        names)


def _range_ids(cols, valid, orders, n_parts, bounds):
    from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer
    part = JP.Partitioning(
        mode="range", num_partitions=n_parts,
        sort_orders=tuple(JE.SortExpr(child=col(n), asc=a, nulls_first=nf)
                          for n, a, nf in orders),
        range_bounds=bounds)
    batch = from_numpy(port_schema(SCHEMA), cols, valid, device="cpu")
    return PartitionIdComputer(port_expr(part), port_schema(SCHEMA))(
        batch).numpy(), part


def _value_key(u, v, scale, asc, nf):
    """A row's order key under (asc, nulls_first), as a sortable tuple of
    exact values."""
    if not v:
        return (0 if nf else 2, 0)
    x = D(int(u)).scaleb(-scale)
    return (1, x if asc else -x)


@pytest.mark.parametrize("asc,nf", [(True, True), (False, False)])
def test_range_ids_by_decimal_bounds_are_exact(asc, nf):
    """Range ids by Spark-sampled `Decimal` bounds (rows tied to bounds, a
    null bound): each row's id is the count of bounds below its key,
    compared as exact values."""
    cols, valid = columns(7)
    rng = np.random.default_rng(8)
    rows = rng.choice(N, 15, replace=False)
    bounds = tuple((None if not valid[0][r] else
                    D(int(cols[0][r])).scaleb(-2),) for r in rows)
    got, _ = _range_ids(cols, valid, [("a", asc, nf)], 16, bounds)
    bkeys = [_value_key(0 if b[0] is None else b[0].scaleb(2),
                        b[0] is not None, 2, asc, nf) for b in bounds]
    exp = [sum(bk < _value_key(u, v, 2, asc, nf) for bk in bkeys)
           for u, v in zip(cols[0], valid[0])]
    np.testing.assert_array_equal(got, exp)
    assert len(set(got.tolist())) > 8


# -- aggregates ------------------------------------------------------------

SPEC_IDS = np.sort(np.random.default_rng(9).choice(
    np.arange(60)[np.arange(60) % 3 != 1], 2000))
SPEC_FNS = {"sum": D182, "avg": JDT.decimal(11, 6), "max": D72,
            "first_ignores_null": D72}


def _states(cols):
    return [(np.asarray(c.data), np.asarray(c.validity)) for c in cols]


def _assert_states(got, exp):
    assert len(got) == len(exp)
    for (gd, gv), (ed, ev) in zip(got, exp):
        np.testing.assert_array_equal(gv, ev)
        np.testing.assert_array_equal(gd[gv], ed[ev].astype(gd.dtype))


@pytest.mark.parametrize("fname", list(SPEC_FNS))
def test_specs_match(fname):
    """update over 60 segments (every third empty), merge of pairs of
    them, final: each step bit for bit with the JAX spec over decimal(7,2)
    values, the average rounded half up at scale 6."""
    from auron_tpu.columnar.batch import DeviceColumn as JCol
    from auron_tpu.ops.agg import functions as jfn
    from auron_tpu_torch.columnar.batch import DeviceColumn
    from auron_tpu_torch.ops.agg import functions as pfn
    rng = np.random.default_rng(len(fname))
    x = _unscaled(rng, 7, len(SPEC_IDS))
    v = rng.random(len(x)) >= 0.2
    x = np.where(v, x, 0)
    out = SPEC_FNS[fname]
    port = pfn.make_spec(fname, port_type(out), "a", port_type(D72))
    jax = jfn.make_spec(fname, D72, out, "a")
    ids = SPEC_IDS
    pu = port.update_segments([DeviceColumn(port_type(D72),
                                            torch.from_numpy(x),
                                            torch.from_numpy(v))],
                              torch.from_numpy(ids), 60)
    ju = jax.update_segments([JCol(D72, jnp.asarray(x), jnp.asarray(v))],
                             jnp.asarray(ids.astype(np.int32)), 60)
    _assert_states(_states(pu), _states(ju))
    assert [(f.name, f.dtype.id.name, f.dtype.precision, f.dtype.scale)
            for f in port.state_fields()] == \
        [(f.name, f.dtype.id.name, f.dtype.precision, f.dtype.scale)
         for f in jax.state_fields()]
    mids = np.arange(60) // 2
    pm = port.merge_segments(pu, torch.from_numpy(mids), 30)
    jm = jax.merge_segments(ju, jnp.asarray(mids.astype(np.int32)), 30)
    _assert_states(_states(pm), _states(jm))
    _assert_states(_states([port.eval_final(pm)]),
                   _states([jax.eval_final(jm)]))


AGG_SCHEMA = JS.of(JF("k", D72), JF("g", I32), JF("v", D72), JF("r", D94))
AGGS = (("s", "sum", "v", JDT.decimal(17, 2)),
        ("m", "avg", "v", JDT.decimal(11, 6)),
        ("lo", "min", "r", D94), ("hi", "max", "r", D94),
        ("fi", "first_ignores_null", "v", D72), ("n", "count", "v", I64))
STATE_KINDS = {"sum": ("sum",), "avg": ("sum", "count"), "min": ("min",),
               "max": ("max",), "first_ignores_null": ("first",),
               "count": ("count",)}


def _agg_input(seed, n=4000):
    rng = np.random.default_rng(seed)
    k = rng.integers(-40, 40, n, dtype=np.int64) * 25   # 80 keys
    g = rng.integers(0, 7, n, dtype=np.int32)
    v = _unscaled(rng, 7, n)
    r = _unscaled(rng, 9, n)
    cols = [k, g, v, r]
    valid = [rng.random(n) >= 0.05 for _ in cols]
    valid[2][k == 0] = False                       # a group of null values
    return cols, valid


def _agg_plan(child, mode, keys):
    return JP.Agg(
        child=child, exec_mode=mode, grouping=tuple(col(k) for k in keys),
        grouping_names=keys,
        aggs=tuple(JE.AggExpr(fn=f, children=(col(c),), return_type=rt)
                   for _, f, c, rt in AGGS),
        agg_names=tuple(a[0] for a in AGGS))


def _keyed(cols, keys, names):
    out = {}
    for i in range(len(cols[keys[0]][0])):
        key = tuple(cols[k][0][i].item() if cols[k][1][i] else None
                    for k in keys)
        assert key not in out
        out[key] = tuple(cols[m][0][i].item() if cols[m][1][i] else None
                         for m in names)
    return out


def _oracle(cols, valid, keys):
    """Spark's answers from numpy integers: sums, average half up at
    scale 6, min, max, first non-null, count."""
    names = [f.name for f in AGG_SCHEMA.fields]
    k_of = [names.index(k) for k in keys]
    rows = {}
    for i in range(len(cols[0])):
        key = tuple(cols[j][i].item() if valid[j][i] else None
                    for j in k_of)
        rows.setdefault(key, []).append(i)
    v, vv, r, rv = cols[2], valid[2], cols[3], valid[3]
    out = {}
    for key, idx in rows.items():
        vs = [int(v[i]) for i in idx if vv[i]]
        rs = [int(r[i]) for i in idx if rv[i]]
        avg = None
        if vs:
            q = D(sum(vs)).scaleb(4) / len(vs)
            avg = int(q.to_integral_value(rounding=decimal.ROUND_HALF_UP))
        out[key] = (sum(vs) if vs else None, avg,
                    min(rs) if rs else None, max(rs) if rs else None,
                    vs[0] if vs else None, len(vs))
    return out


@pytest.mark.parametrize("keys", [("k", "g")], ids="-".join)
def test_partial_final_agg_matches(keys):
    """Partial states through both engines, then the port's states split
    as two map tasks would send them into both engines' final: grouped
    by a decimal key (and an int), bit for bit, and equal to Spark's
    answers from numpy integers."""
    cols, valid = _agg_input(seed=len(keys))
    src = JP.FFIReader(schema=AGG_SCHEMA, resource_id="src")
    parts = TP.chunks(cols, valid, 900)
    port, jax = TP.run_both(_agg_plan(src, "partial", keys),
                            [TP.to_arrow(*p, schema=AGG_SCHEMA)
                             for p in parts], parts)
    sfields = [f for f in AGG_SCHEMA.fields if f.name in keys]
    for name, f, c, rt in AGGS:
        in_t = AGG_SCHEMA.fields[[x.name for x in AGG_SCHEMA.fields]
                                 .index(c)].dtype
        for kind in STATE_KINDS[f]:
            dt = I64 if kind == "count" else in_t if f == "avg" else rt
            sfields.append(JF(f"{name}#{kind}", dt, nullable=kind != "count"))
    states = JS(tuple(sfields))
    snames = tuple(f.name for f in states.fields)
    got = port.to_numpy()
    assert _keyed(got, keys, snames) == \
        _keyed(TP.jax_columns(jax.batches, snames), keys, snames)
    sc, sv = [got[x][0] for x in snames], [got[x][1] for x in snames]
    half = len(sc[0]) // 2
    sparts = [([c[:half] for c in sc], [v[:half] for v in sv]),
              ([c[half:] for c in sc], [v[half:] for v in sv])]
    final = _agg_plan(JP.FFIReader(schema=states, resource_id="st"),
                      "final", keys)
    port, jax = TP.run_both(final, [TP.to_arrow(*p, schema=states)
                                    for p in sparts], sparts)
    names = tuple(a[0] for a in AGGS)
    fin = _keyed(port.to_numpy(), keys, names)
    assert fin == _oracle(cols, valid, keys)
    ref = _keyed(TP.jax_columns(jax.batches, keys + names), keys, names)
    assert {k: v[:1] + v[2:] for k, v in fin.items()} == \
        {k: v[:1] + v[2:] for k, v in ref.items()}


# -- window ------------------------------------------------------------------

WIN_SCHEMA = JS.of(JF("k", D72), JF("o", D94), JF("v", D72))


def _win_input(seed, n=700):
    rng = np.random.default_rng(seed)
    k = rng.integers(-6, 6, n, dtype=np.int64) * 125
    o = rng.integers(-30, 30, n, dtype=np.int64) * 5000     # ties
    v = _unscaled(rng, 7, n)
    cols = [k, o, v]
    return cols, [rng.random(n) >= 0.07 for _ in cols]


def _win_calls():
    def agg(f, c, rt):
        return JP.WindowFuncCall(
            fn="agg", agg=JE.AggExpr(fn=f, children=(col(c),),
                                     return_type=rt),
            return_type=rt, name=f"{f}_{c}")
    return (JP.WindowFuncCall(fn="rank", return_type=I32, name="rk"),
            agg("count", "v", I64), agg("sum", "v", JDT.decimal(17, 2)),
            agg("min", "v", D72), agg("max", "o", D94),
            agg("avg", "v", JDT.decimal(11, 6)))


def _win_plan(calls, ordered):
    return JP.Window(
        child=JP.FFIReader(schema=WIN_SCHEMA, resource_id="src"),
        window_funcs=calls, partition_by=(col("k"),),
        order_by=(JE.SortExpr(child=col("o"), asc=False, nulls_first=True),)
        if ordered else ())


@pytest.mark.parametrize("ordered", [True, False])
def test_window_aggregates_match(ordered):
    """rank over a decimal order key, count, sum, min and max over
    decimal values, running (RANGE frame) and whole-partition: bit for
    bit with the JAX package.  The average is Spark's decimal(11,6), the
    frame's unscaled sum over its count rounded half up, against numpy
    integers; the JAX package's is the float64 quotient of the unscaled
    sum, which its output truncates to the unscaled decimal (ROADMAP
    Queue 3 item 30: over [1.00, 2.00, 2.00], 0.000166 for Spark's
    1.666667)."""
    cols, valid = _win_input(11)
    parts = TP.chunks(cols, valid, 200)
    arrow = [TP.to_arrow(*p, schema=WIN_SCHEMA) for p in parts]
    port, jax = TP.run_both(_win_plan(_win_calls(), ordered), arrow, parts)
    names = ["k", "o", "v"] + [c.name for c in _win_calls()]
    got, ref = port.to_numpy(), TP.jax_columns(jax.batches, names)
    TP.assert_same_rows(got, ref, names[:-1])
    k, o, v = (got[n] for n in ("k", "o", "v"))
    frame_key = list(zip(k[0].tolist(), k[1].tolist()))
    spark, trunc = [], []
    for i in range(len(k[0])):
        rows = [j for j in range(len(k[0])) if frame_key[j] == frame_key[i]
                and (not ordered or (not o[1][j] or
                                     (o[1][i] and o[0][j] >= o[0][i])))]
        vs = [int(v[0][j]) for j in rows if v[1][j]]
        spark.append(None if not vs else int(
            (D(sum(vs)).scaleb(4) / len(vs))
            .to_integral_value(rounding=decimal.ROUND_HALF_UP)))
        trunc.append(None if not vs else int(sum(vs) / len(vs)))
    for (d, ok), exp in ((got["avg_v"], spark), (ref["avg_v"], trunc)):
        assert [int(x) if b else None for x, b in zip(d, ok)] == exp


# -- joins -------------------------------------------------------------------

JOIN_KEY = JDT.decimal(9, 3)


def join_sides(key_type, pool, seed, sizes=(900, 700), batch=250):
    """Record batches of both join sides, keys drawn from `pool` (a
    decimal's unscaled values, or floats), null keys and payloads."""
    import test_torch_joins as TJ
    ls, rs = TJ._sides(key_type)
    out = []
    for schema, n, s in ((ls, sizes[0], seed), (rs, sizes[1], seed + 1)):
        k, kv, v, strs, vv = TJ._side_rows(s, n, 0, key_pool=pool)
        cols = [k, v.astype(np.int64) if schema[1].dtype.id.name == "INT64"
                else v.astype(np.int32), strs]
        rb = TP.to_arrow(cols, [kv, vv, vv], schema)
        out.append([rb.slice(i, batch) for i in range(0, n, batch)])
    return ls, rs, out[0], out[1]


@pytest.mark.parametrize("op,jt", [("broadcast", "left_anti"),
                                   ("hash_right", "inner"), ("smj", "left")])
def test_decimal_key_joins_match(op, jt):
    """Broadcast, shuffled hash and sort-merge joins on a decimal(9,3)
    key: equal to the JAX package row for row, and to a plain join of
    the exact values."""
    import test_torch_joins as TJ
    from auron_tpu.it import compare
    pool = np.random.default_rng(12).integers(-10**9 + 1, 10**9, 200)
    pool[:3] = [0, 10**9 - 1, -10**9 + 1]
    ls, rs, left, right = join_sides(JOIN_KEY, pool, 13)
    port, ref = TJ.run_join(TJ.join_plan(op, jt, JOIN_KEY), left, right)
    assert compare.compare_tables(port, ref, ordered=True) is None
    assert TJ._assert_oracle(port, jt, left, right, ls, rs) > 0


# -- spill -------------------------------------------------------------------

@pytest.mark.parametrize("host_first", [True, False], ids=["host", "file"])
def test_spill_tiers_carry_decimal_and_float32(host_first, tmp_path):
    """A sort by a decimal key (float32 and decimal payloads) under a tiny
    budget spills to the host or the file tier and equals the unbudgeted
    sort row for row, bit for bit; the tier itself gives back what it
    took."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.memmgr import manager as pmm
    from auron_tpu_torch.memmgr.spill import FileSpill, HostMemSpill
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    schema = JS.of(JF("k", D72), JF("x", JDT.float32()), JF("w", D182))
    rng = np.random.default_rng(14)
    n = 5000
    x = rng.normal(size=n).astype(np.float32)
    x[::17] = np.float32(np.nan)
    cols = [_unscaled(rng, 7, n) % 700, x, _unscaled(rng, 18, n)]
    valid = [rng.random(n) >= 0.05 for _ in cols]
    plan = JP.Sort(child=JP.FFIReader(schema=schema, resource_id="src"),
                   sort_exprs=(JE.SortExpr(child=col("k"), asc=False),))
    data = jserde.serialize(JP.TaskDefinition(plan=plan), codec="zlib")
    kv = {"auron.memory.spill.min.trigger.bytes": 1,
          "auron.spill.host.memory.first": host_first,
          "auron.spill.dir": str(tmp_path)}
    outs = []
    for budget in (60_000, None):
        res = ResourceRegistry()
        res.put("src", TP.chunks(cols, valid, 500))
        with conf.scoped(kv):
            pmm.reset_manager(budget)
            outs.append(execute_task_bytes(data, res, device="cpu"))
        pmm.reset_manager()
    assert outs[0].summed("mem_spill_count") >= 2
    got, whole = outs[0].to_numpy(), outs[1].to_numpy()
    for name in ("k", "x", "w"):
        np.testing.assert_array_equal(got[name][1], whole[name][1])
        gd, wd = got[name][0], whole[name][0]
        assert gd.dtype == wd.dtype
        np.testing.assert_array_equal(gd.view(f"u{gd.itemsize}"),
                                      wd.view(f"u{wd.itemsize}"))
    batch = from_numpy(port_schema(schema), cols, valid, device="cpu")
    tier = HostMemSpill() if host_first else FileSpill(str(tmp_path))
    tier.write_batches([batch])
    back = list(tier.read_batches())[0]
    for c, b in zip(batch.columns, back.columns):
        assert b.dtype == c.dtype
        assert torch.equal(b.validity, c.validity)
        assert torch.equal(b.data.view(torch.uint8), c.data.view(torch.uint8))
    tier.release()


# -- plans across the engines ------------------------------------------------

def _typed_plan():
    """A plan with decimal types, a `@decimal` literal and a float32
    column: Project -> Filter -> partial Agg."""
    schema = JS.of(JF("k", D72), JF("p", D72), JF("q", I32),
                   JF("x", JDT.float32()))
    amt = JE.ScalarFunctionCall(
        name="check_overflow", return_type=D182,
        args=(bin_(cast("q", D100), "*", "p"),))
    proj = JP.Projection(
        child=JP.FFIReader(schema=schema, resource_id="src"),
        exprs=(col("k"), col("p"), amt, col("x")),
        names=("k", "p", "amt", "x"))
    filt = JP.Filter(child=proj, predicates=(
        bin_("p", ">", lit(D("-12.50"), D72)),))
    return schema, JP.Agg(
        child=filt, exec_mode="single", grouping=(col("k"),),
        grouping_names=("k",),
        aggs=(JE.AggExpr(fn="sum", children=(col("p"),),
                         return_type=JDT.decimal(17, 2)),
              JE.AggExpr(fn="avg", children=(col("p"),),
                         return_type=JDT.decimal(11, 6)),
              JE.AggExpr(fn="max", children=(col("amt"),), return_type=D182),
              JE.AggExpr(fn="min", children=(col("x"),),
                         return_type=JDT.float32())),
        agg_names=("s", "m", "hi", "lo"))


def test_plan_json_runs_in_either_engine():
    """The plan serialized by the JAX package decodes in the port to the
    same JSON, and the port's serialization decodes in the JAX package
    to the same plan; both engines run it alike (the JAX package's
    average is Spark's in single mode)."""
    from auron_tpu.ir import serde as js
    schema, plan = _typed_plan()
    jtext = js.to_json(JP.TaskDefinition(plan=plan))
    ported = serde.from_json(jtext)
    assert json.loads(serde.to_json(ported)) == json.loads(jtext)
    assert js.from_json(serde.to_json(ported)) == \
        JP.TaskDefinition(plan=plan)
    lit_ = ported.plan.child.predicates[0].right
    assert lit_.value == D("-12.50") and isinstance(lit_.value, D)
    rng = np.random.default_rng(15)
    n = 2000
    cols = [rng.integers(-20, 20, n).astype(np.int64) * 5,
            _unscaled(rng, 5, n), rng.integers(-50, 50, n, dtype=np.int32),
            rng.normal(size=n).astype(np.float32)]
    valid = [rng.random(n) >= 0.05 for _ in cols]
    parts = TP.chunks(cols, valid, 600)
    port, jax = TP.run_both(plan, [TP.to_arrow(*p, schema=schema)
                                   for p in parts], parts)
    names = ("s", "m", "hi", "lo")
    assert _keyed(port.to_numpy(), ("k",), names) == \
        _keyed(TP.jax_columns(jax.batches, ("k",) + names), ("k",), names)


# -- a foreign plan through both sessions --------------------------------------

SALES = JS.of(JF("ss_customer_sk", I64), JF("ss_quantity", I32),
              JF("ss_sales_price", D72), JF("ss_wholesale", JDT.float32()),
              JF("ss_note", JDT.decimal(38, 10)))


@pytest.fixture(scope="module")
def sales_files(tmp_path_factory):
    """Two parquet chunks of a store_sales-like table: price decimal(7,2)
    (cents), a float32 column and a decimal(38,10) column."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(16)
    n = 3000
    cols = [rng.integers(1, 200, n).astype(np.int64),
            rng.integers(1, 101, n, dtype=np.int32),
            rng.integers(0, 20001, n).astype(np.int64),
            rng.normal(size=n).astype(np.float32)]
    valid = [rng.random(n) >= 0.04 for _ in cols]
    note = pa.array([None if i % 9 == 0 else
                     D(int(rng.integers(-10**18, 10**18)) * 1000 + i)
                     .scaleb(-10)
                     for i in range(n)], type=pa.decimal128(38, 10))
    rb = TP.to_arrow(cols, valid, JS(SALES.fields[:4]))
    table = pa.Table.from_batches([rb]).append_column("ss_note", note)
    d = tmp_path_factory.mktemp("sales")
    paths = []
    for k, (lo, hi) in enumerate(((0, 1700), (1700, n))):
        paths.append(str(d / f"part-{k}.parquet"))
        pq.write_table(table.slice(lo, hi - lo), paths[-1])
    return paths


class ArrowEngine:
    """A foreign engine over arrow tables: a scan reads its file groups'
    parquet (one split a group), any other node runs on the JAX
    package's pyarrow oracle; `ran` lists the ops it executed."""

    def __init__(self):
        self.ran = []

    def execute(self, node, child_tables):
        import pyarrow as pa
        import pyarrow.parquet as pq
        from auron_tpu.frontend import foreign as JFN
        from auron_tpu.it.oracle import PyArrowEngine
        from test_torch_session_foreign import EngineTable
        self.ran.append(node.op)
        if node.op == "FileSourceScanExec":
            names = list(node.output.names())
            groups = [pq.read_table(list(g), columns=names)
                      for g in node.attrs["file_groups"]]
            out = EngineTable(pa.concat_tables(groups))
            out.parts = [[arrow_to_numpy_(rb) for rb in
                          g.combine_chunks().to_batches(max_chunksize=700)]
                         for g in groups]
            return out
        return EngineTable(PyArrowEngine().execute(
            JFN.ForeignNode.from_json(node.to_json()),
            [t.arrow for t in child_tables]))


def arrow_to_numpy_(rb):
    from auron_tpu_torch.ops.scan.ipc import arrow_to_numpy
    return arrow_to_numpy(rb)


def _sales_plan(paths, note: bool):
    """scan -> Project(k, price, CheckOverflow(Cast(qty as decimal(10,0))
    * price, decimal(18,2)), wholesale) -> partial Agg -> hash(4) by k ->
    final Agg -> Sort by k: Spark's result types (sum decimal(17,2), avg
    decimal(11,6), sum of a float32 double)."""
    from auron_tpu.frontend.foreign import (ForeignNode, falias, fcall,
                                            fcol, flit)
    from auron_tpu.it.queries import agg, so
    fields = SALES.fields if note else SALES.fields[:4]
    scan = ForeignNode("FileSourceScanExec", output=JS(tuple(fields)),
                       attrs={"format": "parquet",
                              "file_groups": [[p] for p in paths],
                              "pushed_filters": []})
    if note:
        # the wide column dropped, then the rows repartitioned by the key
        # (Spark's `repartition`): an exchange converts over any child
        # but an aggregation
        scan = ForeignNode("ProjectExec", children=(scan,),
                           output=JS(SALES.fields[:4]),
                           attrs={"project_list": [
                               fcol(f.name, f.dtype)
                               for f in SALES.fields[:4]]})
        scan = ForeignNode(
            "ShuffleExchangeExec", children=(scan,), output=scan.output,
            attrs={"partitioning": {
                "mode": "hash", "num_partitions": 3,
                "expressions": [fcol("ss_customer_sk", I64)]}})
    F32 = JDT.float32()
    amt = fcall("CheckOverflow",
                fcall("Multiply", fcall("Cast", fcol("ss_quantity", I32),
                                        dtype=D100),
                      fcol("ss_sales_price", D72), dtype=D182), dtype=D182)
    proj_out = JS.of(JF("k", I64), JF("price", D72), JF("amt", D182),
                     JF("w", F32))
    proj = ForeignNode("ProjectExec", children=(scan,), output=proj_out,
                       attrs={"project_list": [
                           falias(fcol("ss_customer_sk", I64), "k"),
                           falias(fcol("ss_sales_price", D72), "price"),
                           falias(amt, "amt"),
                           falias(fcol("ss_wholesale", F32), "w")]})
    filt = ForeignNode("FilterExec", children=(proj,), output=proj_out,
                       attrs={"condition": fcall(
                           "GreaterThan", fcol("price", D72),
                           flit(1.0, D72), dtype=JDT.bool_())})
    aggs = [("s", agg("Sum", fcol("price", D72), JDT.decimal(17, 2))),
            ("m", agg("Average", fcol("price", D72), JDT.decimal(11, 6))),
            ("lo", agg("Min", fcol("amt", D182), D182)),
            ("hi", agg("Max", fcol("amt", D182), D182)),
            ("ws", agg("Sum", fcol("w", F32), F64)),
            ("wx", agg("Max", fcol("w", F32), F32))]
    states = JS.of(JF("k", I64), JF("s#sum", JDT.decimal(17, 2)),
                   JF("m#sum", D72), JF("m#count", I64),
                   JF("lo#min", D182), JF("hi#max", D182),
                   JF("ws#sum", F64), JF("wx#max", F32))
    partial = ForeignNode(
        "HashAggregateExec", children=(filt,), output=states,
        attrs={"grouping": [fcol("k", I64)], "aggs": [a for _, a in aggs],
               "agg_names": [n for n, _ in aggs], "mode": "partial"})
    exchange = ForeignNode(
        "ShuffleExchangeExec", children=(partial,), output=states,
        attrs={"partitioning": {"mode": "hash", "num_partitions": 4,
                                "expressions": [fcol("k", I64)]}})
    out = JS.of(JF("k", I64), JF("s", JDT.decimal(17, 2)),
                JF("m", JDT.decimal(11, 6)), JF("lo", D182), JF("hi", D182),
                JF("ws", F64), JF("wx", F32))
    final = ForeignNode(
        "HashAggregateExec", children=(exchange,), output=out,
        attrs={"grouping": [fcol("k", I64)], "aggs": [a for _, a in aggs],
               "agg_names": [n for n, _ in aggs], "mode": "final"})
    return ForeignNode("SortExec", children=(final,), output=out,
                       attrs={"sort_order": [so(fcol("k", I64))]})


def _session_table(res):
    import pyarrow as pa
    from auron_tpu.ir.schema import to_arrow_type
    from auron_tpu_torch.ir.node import _encode
    from auron_tpu.ir.node import _decode
    arrays = []
    for f in res.schema.fields:
        d, v = res.columns[f.name]
        typ = to_arrow_type(_decode(_encode(f.dtype)))
        arrays.append(TP.decimal_array(d, v, typ) if f.dtype.is_decimal
                      else pa.array(d, type=typ, mask=~v))
    return pa.Table.from_arrays(arrays, names=list(res.schema.names()))


def _run_sessions(plan, reference=True):
    """The plan through the port's session (and the JAX package's), each
    with a scan provider; -> (port result, JAX result or None, engine)."""
    from auron_tpu.frontend import converters as JC
    from auron_tpu.frontend.foreign import ForeignNode as JNode
    from auron_tpu.frontend.session import AuronSession as JaxSession
    from auron_tpu.it.oracle import PyArrowEngine
    from auron_tpu_torch.frontend import converters as PC
    from auron_tpu_torch.frontend.foreign import ForeignNode as PNode
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.ops import kernels_cuda as K
    jp, pp = TP.scan_provider(JC), TP.scan_provider(PC)
    JC.register_provider(jp)
    PC.register_provider(pp)
    try:
        K.reset_launches()
        engine = ArrowEngine()
        res = AuronSession(foreign_engine=engine).execute(
            PNode.from_json(plan.to_json()), device="cpu")
        ref = JaxSession(foreign_engine=PyArrowEngine()).execute(
            JNode.from_json(plan.to_json())) if reference else None
    finally:
        JC.unregister_provider(jp)
        PC.unregister_provider(pp)
    return res, ref, engine


def test_foreign_plan_through_both_sessions(sales_files):
    """decimal(7,2) and float32 columns from a parquet scan through the
    port's session on the stage path (no fallback, no launch), equal to
    the JAX package's session under `compare_tables`; the average
    against Spark's (numpy integers), since the JAX package's final
    average reads its sum at scale 0 (ROADMAP Queue 3 item 30)."""
    import pyarrow.parquet as pq
    from auron_tpu.it import compare
    from auron_tpu_torch.ops import kernels_cuda as K
    res, ref, engine = _run_sessions(_sales_plan(sales_files, note=False))
    assert res.spmd, res.spmd_rejection
    assert res.metrics["num_fallbacks"] == 0
    assert engine.ran == ["FileSourceScanExec"]
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}
    got = _session_table(res)
    keep = [n for n in got.column_names if n != "m"]
    assert compare.compare_tables(got.select(keep), ref.table.select(keep),
                                  ordered=True) is None
    rows = {}
    for p in sales_files:
        for r in pq.read_table(p).to_pylist():
            if r["ss_sales_price"] is not None and \
                    r["ss_sales_price"] > D("1.00"):
                rows.setdefault(r["ss_customer_sk"], []).append(
                    int(r["ss_sales_price"].scaleb(2)))
    d, v = res.columns["m"]
    k, kv = res.columns["k"]
    for key, ok, dd, vv in zip(k.tolist(), kv.tolist(), d.tolist(),
                               v.tolist()):
        vs = rows[key if ok else None]
        exp = (D(sum(vs)).scaleb(4) / len(vs)).to_integral_value(
            rounding=decimal.ROUND_HALF_UP)
        assert vv and dd == int(exp), key
    assert len(k) == len(rows)


def test_wide_decimal_stays_foreign(sales_files):
    """A decimal(38,10) column has no device layout in the port: the
    scan that carries it, and the projection that drops it, stay foreign
    (the converter raises NotConvertible naming ROADMAP Queue 1 item 11);
    the session runs the rest from the exchange above them on, and gives
    the rows of the same plan without the column."""
    from auron_tpu.it import compare
    from auron_tpu_torch.frontend import converters as PC
    from auron_tpu_torch.frontend.expr_convert import NotConvertible
    from auron_tpu_torch.frontend.foreign import ForeignNode as PNode
    plan = _sales_plan(sales_files, note=True)
    res, _, engine = _run_sessions(plan, reference=False)
    assert set(engine.ran) == {"FileSourceScanExec", "ProjectExec"}
    assert res.foreign_sections == 1 and not res.all_native()
    narrow, _, _ = _run_sessions(_sales_plan(sales_files, note=False),
                                 reference=False)
    assert compare.compare_tables(_session_table(res), _session_table(narrow),
                                  ordered=False) is None
    scan = PNode.from_json(plan.to_json())
    while scan.children:
        scan = scan.children[0]
    with pytest.raises(NotConvertible, match="Queue 1 item 11"):
        PC.convert_node(scan, [], PC.ConvertContext())
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        DataType.decimal(38, 10).torch_dtype()


# -- where the JAX package departs from Spark (ROADMAP Queue 3) --------------

def _one(exprs, schema, *cols):
    """`exprs` over one column set (all valid) in both engines ->
    (JAX [(data, validity, dtype)], port [...])."""
    n = len(cols[0])
    return run_exprs(exprs, schema=schema,
                     cols=([np.asarray(c) for c in cols],
                           [np.ones(n, bool)] * len(cols)))


def test_float_to_decimal_rounds_the_shortest_text():
    """Queue 3 item 24.  Spark casts a double to a decimal through its
    shortest decimal text, rounded half up: 1.005 -> 1.01, 0.145 ->
    0.15, 6708.764999999999 -> 6708.76; a NaN gives null.  The JAX
    package rounds the float product x * 10^s: 1.00, 0.14, 6708.77, and
    a NaN gives a valid 0.00."""
    f = np.array([1.005, 0.145, 6708.764999999999, -1.005, np.nan, 2.5e-3])
    j, p = _one([cast("f", JDT.decimal(8, 2))], JS.of(JF("f", F64)), f)
    assert p[0][0].tolist() == [101, 15, 670876, -101, 0, 0]
    assert p[0][1].tolist() == [True] * 4 + [False, True]
    assert j[0][0].tolist() == [100, 14, 670877, -100, 0, 0]
    assert j[0][1].tolist() == [True] * 6


def test_decimal_literals_are_exact():
    """Queue 3 item 25.  A Decimal literal is exact and a float literal
    its shortest text, rounded half up: Decimal('0.125') and 0.125 as
    decimal(3,2) are 0.13, Decimal('1234567890123456.78') as
    decimal(18,2) is itself.  The JAX package rounds float(v) * 10^s
    half to even: 0.12, 0.12 and 1234567890123456.80."""
    x = np.zeros(2, np.int64)
    exprs = [lit(D("0.125"), JDT.decimal(3, 2)),
             lit(0.125, JDT.decimal(3, 2)),
             lit(D("1234567890123456.78"), D182)]
    j, p = _one(exprs, JS.of(JF("q", D100)), x)
    assert [int(c[0][0]) for c in p] == [13, 13, 123456789012345678]
    assert [int(c[0][0]) for c in j] == [12, 12, 123456789012345680]


def test_decimal_comparisons_are_exact():
    """Queue 3 item 26.  Decimals compare exactly in Spark: 90071992547409.93
    > 90071992547409.92 (decimal(18,2)), and 0.03 (decimal(7,2)) equals
    0.0300 (decimal(9,4)).  The JAX package compares float64 values: the
    first pair equal, the second unequal (its jitted division by 10^s is
    a multiply by the reciprocal)."""
    schema = JS.of(JF("w", D182), JF("v", D182), JF("a", D72),
                   JF("c", D94))
    cols = [np.array([9007199254740993]), np.array([9007199254740992]),
            np.array([3]), np.array([300])]
    exprs = [bin_("w", "==", "v"), bin_("w", ">", "v"), bin_("a", "==", "c")]
    j, p = _one(exprs, schema, *cols)
    assert [bool(c[0][0]) for c in p] == [False, True, True]
    assert [bool(c[0][0]) for c in j] == [True, False, False]


def test_decimal_to_integral_truncates_then_wraps():
    """Queue 3 item 27.  Spark's `Decimal.toInt` is `toLong.toInt`: the
    value truncated toward zero, exactly, then wrapped.  30000000000.99
    (decimal(12,2)) -> -64771072 as int, 2.9999999999999999
    (decimal(18,16)) -> 2.  The JAX package goes through float64 and
    saturates: 2147483647 and 3."""
    schema = JS.of(JF("a", JDT.decimal(12, 2)), JF("b", JDT.decimal(18, 16)))
    exprs = [cast("a", I32), cast("b", I32), cast("b", I64)]
    j, p = _one(exprs, schema, np.array([3000000000099]),
                np.array([29999999999999999]))
    assert [int(c[0][0]) for c in p] == [-64771072, 2, 2]
    assert [int(c[0][0]) for c in j] == [2147483647, 3, 3]


def test_round_of_a_decimal_takes_its_return_type():
    """Queue 3 item 28.  round(123.45 as decimal(7,2), 1) is 123.5 of
    Spark's decimal(7,1): the port gives (decimal(7,1), 1235).  The JAX
    package keeps decimal(7,2) and 12350 under the declared
    decimal(7,1), whose readers take 12350 as 1235.0."""
    e = fn("round", "a", lit(1, I32), rt=JDT.decimal(7, 1))
    j, p = _one([e], JS.of(JF("a", D72)), np.array([12345, -12345]))
    assert (p[0][2].precision, p[0][2].scale) == (7, 1)
    assert p[0][0].tolist() == [1235, -1235]
    assert (j[0][2].precision, j[0][2].scale) == (7, 2)
    assert j[0][0].tolist() == [12350, -12350]


def test_decimal_sum_past_its_precision_is_null():
    """Queue 3 item 29.  Spark's sum of decimals is null where it passes
    the result's precision (non-ANSI).  Single-mode Sum into decimal(18,0)
    of 2 x 6 * 10^17 and of 10 x (10^18 - 1): the port gives null for
    both; the JAX package 1.2 * 10^18 (19 digits) and its int64 state's
    wrap, -8446744073709551626."""
    schema = JS.of(JF("k", I64), JF("v", JDT.decimal(18, 0)))
    k = np.array([1, 1] + [2] * 10 + [3])
    v = np.array([6 * 10**17] * 2 + [10**18 - 1] * 10 + [5])
    plan = JP.Agg(child=JP.FFIReader(schema=schema, resource_id="src"),
                  exec_mode="single", grouping=(col("k"),),
                  grouping_names=("k",),
                  aggs=(JE.AggExpr(fn="sum", children=(col("v"),),
                                   return_type=JDT.decimal(18, 0)),),
                  agg_names=("s",))
    items = [([k, v], [np.ones(len(k), bool)] * 2)]
    port, jax = TP.run_both(plan, [TP.to_arrow(*items[0], schema=schema)],
                            items)
    assert _keyed(port.to_numpy(), ("k",), ("s",)) == \
        {(1,): (None,), (2,): (None,), (3,): (5,)}
    assert _keyed(TP.jax_columns(jax.batches, ("k", "s")), ("k",),
                  ("s",)) == {(1,): (1200000000000000000,),
                              (2,): (-8446744073709551626,), (3,): (5,)}


def test_decimal_average_is_sparks():
    """Queue 3 item 30.  avg(decimal(7,2)) is Spark's decimal(11,6), sum /
    count rounded half up.  A final Agg over the states (10.03, 2) and
    (0.05, 3): the port gives 5.015000 and 0.016667; the JAX package
    takes the input's type from the partial stage's column, which the
    state schema lacks, as int64, and gives 501.500000 and 1.666667.  The
    window's average: `test_window_aggregates_match`."""
    states = JS.of(JF("k", I64), JF("m#sum", D72),
                   JF("m#count", I64, nullable=False))
    plan = JP.Agg(
        child=JP.FFIReader(schema=states, resource_id="st"),
        exec_mode="final", grouping=(col("k"),), grouping_names=("k",),
        aggs=(JE.AggExpr(fn="avg", children=(col("v"),),
                         return_type=JDT.decimal(11, 6)),),
        agg_names=("m",))
    items = [([np.array([1, 2]), np.array([1003, 5]), np.array([2, 3])],
              [np.ones(2, bool)] * 3)]
    port, jax = TP.run_both(plan, [TP.to_arrow(*items[0], schema=states)],
                            items)
    assert _keyed(port.to_numpy(), ("k",), ("m",)) == \
        {(1,): (5015000,), (2,): (16667,)}
    assert _keyed(TP.jax_columns(jax.batches, ("k", "m")), ("k",),
                  ("m",)) == {(1,): (501500000,), (2,): (1666667,)}


def test_range_bounds_by_decimal_values():
    """Queue 3 item 31.  Range ids of decimal(7,2) keys [1.00, 1.50,
    2.00, 2.50] by the bound Decimal('1.50'), 2 partitions: Spark's
    [0, 0, 1, 1].  The JAX package truncates the bound to the int 1 in
    the int64 key space of the rows' unscaled words: [1, 1, 1, 1]."""
    from auron_tpu.ops.shuffle.partitioner import PartitionIdComputer as JPC
    schema = JS.of(JF("a", D72))
    cols, valid = [np.array([100, 150, 200, 250])], [np.ones(4, bool)]
    part = JP.Partitioning(mode="range", num_partitions=2,
                           sort_orders=(JE.SortExpr(child=col("a")),),
                           range_bounds=((D("1.50"),),))
    from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer
    got = PartitionIdComputer(port_expr(part), port_schema(schema))(
        from_numpy(port_schema(schema), cols, valid, device="cpu"))
    assert got.tolist() == [0, 0, 1, 1]
    jax = JPC(part, schema)(JaxBatch.from_numpy(schema, cols, valid))
    assert np.asarray(jax)[:4].tolist() == [1, 1, 1, 1]


# -- the card's phase, rehearsed on the CPU ------------------------------------

def test_chip_smoke_phase_29_runs_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 29 at a small size with the CPU in the card's
    place and the kernel wrappers counted around their plain versions:
    every check passes, the single-decimal-key exchange takes the
    hash-pid route once per map batch, the stage path launches nothing,
    and the writers' shapes reach phase 15's list."""
    import chip_smoke
    from auron_tpu_torch.ops import kernels_cuda as K
    from auron_tpu_torch.ops.shuffle import writer as W
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def counted(name, plain):
        def run(*args):
            K.LAUNCHES[name] += 1
            return plain(*args)
        return run
    monkeypatch.setattr(K, "hash_partition_ids_i64", counted(
        "hash_partition_ids_i64", K.hash_partition_ids_i64_plain))
    hist = counted("radix_bucket_hist", K.radix_bucket_hist_plain)
    monkeypatch.setattr(K, "radix_bucket_hist", hist)
    monkeypatch.setattr(W, "radix_bucket_hist", hist)
    cols, valid = chip_smoke.make_store_sales(8 * 4000, 5)
    shapes = []
    launches = chip_smoke.run_phase29(cols, valid, "cpu", K, 5, "cpu",
                                      shapes)
    out = capsys.readouterr().out
    assert "(c) the group by customer from its foreign plan" in out
    for path in ("decimal_customer", "decimal_key"):
        assert launches[path] == {"hash_partition_ids_i64": 1,
                                  "radix_bucket_hist": 1}
    assert launches["decimal_sort"]["hash_partition_ids_i64"] == 0
    assert launches["decimal_sort"]["radix_bucket_hist"] == 1
    assert launches["float32_group_by"] == {"hash_partition_ids_i64": 0,
                                            "radix_bucket_hist": 4}
    assert launches["decimal_session_stage"] == {
        "hash_partition_ids_i64": 0, "radix_bucket_hist": 0}
    assert {(k, p) for k, _, p in shapes} == {
        ("hash_pid", chip_smoke.DECIMAL_PARTS),
        ("hist", chip_smoke.DECIMAL_PARTS),
        ("hist", chip_smoke.N_AGG_PARTS)}

"""Float32 columns of auron_tpu_torch against auron_tpu on the same
seeded inputs: a float32 is a flat `torch.float32` column in the port, a
`float32` one in the JAX package, made with numpy and fed to each.

Bit for bit against the JAX package where both keep Spark's semantics:
arithmetic, comparisons, casts, `round`, `normalize_nan_and_zero`,
`hash_float32` and partition ids, the sort words and permutations, the
Sum, Average, Min, Max and First specs (sums and averages float64, to
relative 1e-12 where the engines add in another order), `AggExec`
grouped by a float32 key, window aggregates and the three join
operators on a float32 key.  Where the JAX package departs from Spark
(ROADMAP Queue 3 items 32-33: a NaN's and a subnormal's hash, -0.0 and
NaN in the sort order and the grouping), the test pins Spark's answer
on the queue's input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auron_tpu.columnar.batch import Batch as JaxBatch
from auron_tpu.columnar.batch import DeviceColumn as JCol
from auron_tpu.exprs.compiler import build_evaluator as jax_evaluator
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu_torch.columnar.batch import DeviceColumn, from_numpy
from auron_tpu_torch.exprs.compiler import build_evaluator

import torch_parity as TP
from test_torch_decimal import (
    assert_same, bin_, cast, col, fn, lit, port_expr, port_schema,
    port_type,
)
from torch_parity import one_thread  # noqa: F401

N = 3000
F32, F64, I32, I64 = JDT.float32(), JDT.float64(), JDT.int32(), JDT.int64()
SCHEMA = JS.of(JF("x", F32), JF("y", F32), JF("i", I32), JF("l", I64),
               JF("d", F64))
# Spark's canonical float NaN, a NaN with its sign bit and a payload
NAN = np.float32(np.nan)
NAN_NEG = np.uint32(0xFFC00000).view(np.float32)
NAN_PAYLOAD = np.uint32(0x7F800123).view(np.float32)
SUBNORMAL = np.float32(1e-45)


def _floats(rng, n, specials=True):
    x = (rng.normal(size=n) * 1e3).astype(np.float32)
    x[::11] = np.round(x[::11])                     # ties and integers
    if specials:
        x[1::23], x[2::23], x[3::23] = np.inf, -np.inf, 0.0
        x[4::29] = np.float32(3.4e38)
    return x


def columns(seed, n=N):
    rng = np.random.default_rng(seed)
    x, y = _floats(rng, n), _floats(rng, n)
    y[::13] = 0.0                                   # zero divisors
    y[5::17] = x[5::17]
    i = rng.integers(-5000, 5000, n, dtype=np.int32)
    l = rng.integers(-2**40, 2**40, n, dtype=np.int64)
    d = rng.normal(size=n) * 1e3
    cols = [x, y, i, l, d]
    return cols, [rng.random(n) >= 0.08 for _ in cols]


def run(exprs, cols, valid, schema=SCHEMA):
    n = len(cols[0])
    jout = jax_evaluator(tuple(exprs), schema)(
        JaxBatch.from_numpy(schema, cols, valid))
    pout = build_evaluator([port_expr(x) for x in exprs],
                           port_schema(schema))(
        from_numpy(port_schema(schema), cols, valid, device="cpu"))
    return [(np.asarray(j.data)[:n], np.asarray(j.validity)[:n], j.dtype)
            for j in jout], \
        [(p.data[:n].numpy(), p.validity[:n].numpy(), p.dtype) for p in pout]


def check(exprs, seed=0):
    cols, valid = columns(seed)
    jout, pout = run(exprs, cols, valid)
    assert_same(jout, pout, exprs)


# -- expressions -------------------------------------------------------------

EXPRS = {
    "arithmetic": [bin_("x", op, "y") for op in ("+", "-", "*", "/")] +
                  [JE.Negative(child=col("x")), bin_("x", "+", "i"),
                   bin_("x", "*", "d"), bin_("x", "-", "l")],
    "comparisons": [bin_("x", op, "y") for op in
                    ("==", "!=", "<", "<=", ">", ">=", "<=>")] +
                   [bin_("x", "<", "d"), bin_("i", ">=", "x"),
                    bin_("x", "==", lit(0.5, F32))],
    "casts": [cast("x", F64), cast("d", F32), cast("i", F32),
              cast("l", F32), cast("x", I64), cast("x", JDT.bool_()),
              cast("x", JDT.decimal(12, 2))],
    "functions": [fn("round", "x", lit(1, I32)), fn("round", "x", lit(-1, I32)),
                  fn("normalize_nan_and_zero", "x"),
                  fn("coalesce", "x", "y"),
                  JE.InList(child=col("x"), values=(lit(0.0, F32),
                                                    lit(1.0, F32))),
                  JE.Case(branches=(JE.WhenThen(when=bin_("x", ">", "y"),
                                                then=col("x")),),
                          else_expr=col("y"))],
}


@pytest.mark.parametrize("kind", list(EXPRS))
def test_expressions_match(kind):
    check(EXPRS[kind])


def test_float32_to_int_casts_are_javas():
    """Java's (int) and (long) of a float: truncate, saturate, NaN 0 (the
    float widened to double first, exactly); to a short through int, then
    wrap."""
    x = np.array([3e9, -3e9, 2.5, -2.5, np.nan, np.inf, -np.inf, 7e4,
                  1e19], np.float32)
    schema = JS.of(JF("x", F32))
    exprs = [cast("x", I32), cast("x", I64), cast("x", JDT.int16())]
    _, pout = run(exprs, [x], [np.ones(len(x), bool)], schema)
    assert pout[0][0].tolist() == [2**31 - 1, -2**31, 2, -2, 0, 2**31 - 1,
                                   -2**31, 70000, 2**31 - 1]
    assert pout[1][0].tolist() == [3000000000, -3000000000, 2, -2, 0,
                                   2**63 - 1, -2**63, 70000, 2**63 - 1]
    assert pout[2][0].tolist() == [-1, 0, 2, -2, 0, -1, 0, 4464, -1]


# -- hashes, partition ids, sort words ---------------------------------------

def _pair(x, v):
    x = np.where(v, x, np.float32(0))
    return (DeviceColumn(port_type(F32), torch.from_numpy(x),
                         torch.from_numpy(v)),
            JCol(F32, jnp.asarray(x), jnp.asarray(v)))


def test_hash_float32_matches():
    """hashInt of the bits, -0.0 as 0.0, chained with an int64 key."""
    from auron_tpu.exprs import hashing as JH
    from auron_tpu_torch.exprs import hashing as H
    rng = np.random.default_rng(1)
    x = _floats(rng, N)
    x[7::19] = -0.0
    v = rng.random(N) >= 0.1
    p, j = _pair(x, v)
    seed = np.uint32(42)
    np.testing.assert_array_equal(
        H.hash_float32(p.data, torch.tensor(42)).numpy(),
        np.asarray(JH.hash_float32(j.data, seed)))
    lk = rng.integers(-2**62, 2**62, N, dtype=np.int64)
    schema = JS.of(JF("x", F32), JF("l", I64))
    jb = JaxBatch.from_numpy(schema, [x, lk], [v, np.ones(N, bool)])
    pb = from_numpy(port_schema(schema), [x, lk], [v, np.ones(N, bool)],
                    device="cpu")
    np.testing.assert_array_equal(
        H.hash_columns(pb.columns, 42)[:N].numpy(),
        np.asarray(JH.hash_columns(jb.columns, 42))[:N])


@pytest.mark.parametrize("n_parts", [7, 200])
def test_float32_key_partition_ids_match(n_parts):
    from auron_tpu.ops.shuffle.partitioner import PartitionIdComputer as JPC
    from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer
    cols, valid = columns(2)
    part = JP.Partitioning(mode="hash", num_partitions=n_parts,
                           expressions=(col("x"),))
    exp = np.asarray(JPC(part, SCHEMA)(
        JaxBatch.from_numpy(SCHEMA, cols, valid)))[:N]
    got = PartitionIdComputer(port_expr(part), port_schema(SCHEMA))(
        from_numpy(port_schema(SCHEMA), cols, valid, device="cpu"))
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False)])
def test_sort_words_match(asc, nulls_first):
    """A float32 key is one u32 word in the port, the high half of a u64
    word in the JAX package: the same 32 bits, away from -0.0 and NaN
    (test_float32_order_is_sparks); the host encoder of range bounds
    gives the port's words."""
    from auron_tpu.ops import sort_keys as JK
    from auron_tpu_torch.ops import sort_keys as SK
    from auron_tpu_torch.ops.sort import _np_encode_key
    rng = np.random.default_rng(3)
    x = _floats(rng, N)
    x[9::31] = SUBNORMAL
    v = rng.random(N) >= 0.1
    p, j = _pair(x, v)
    got = SK.encode_key_column(p, asc, nulls_first)
    exp = JK.encode_key_column(j, asc, nulls_first)
    assert got[0].numpy().tolist() == np.asarray(exp[0]).tolist()
    assert got[1].numpy().tolist() == \
        (np.asarray(exp[1]) >> np.uint64(32)).astype(np.int64).tolist()
    assert SK.encode_key_column_bits(p) == [1, 32]
    host = _np_encode_key(p.data.numpy(), p.validity.numpy(), p.dtype,
                          asc, nulls_first)
    assert [h.tolist() for h in host] == [g.numpy().tolist() for g in got]


@pytest.mark.parametrize("strategy", ["radix", "argsort"])
def test_sort_permutation_matches(strategy):
    """SortExec by (x DESC NULLS LAST, i) over several batches."""
    from auron_tpu_torch.config import conf
    cols, valid = columns(4)
    cols[0][:] = np.round(cols[0] / 100) + np.float32(0)    # ties, no -0.0
    plan = JP.Sort(child=JP.FFIReader(schema=SCHEMA, resource_id="src"),
                   sort_exprs=(JE.SortExpr(child=col("x"), asc=False,
                                           nulls_first=False),
                               JE.SortExpr(child=col("i"))))
    parts = TP.chunks(cols, valid, 700)
    with conf.scoped({"auron.kernel.sort.strategy": strategy}):
        port, jax = TP.run_both(plan, [TP.to_arrow(*p, schema=SCHEMA)
                                       for p in parts], parts)
    names = [f.name for f in SCHEMA.fields]
    TP.assert_same_rows(port.to_numpy(), TP.jax_columns(jax.batches, names),
                        names)


def test_range_ids_by_float32_bounds():
    """Range ids by float32 bounds (Python floats, each the float32
    nearest its value), against numpy: the count of bounds below the
    row, ties to the lower partition, NaN above +inf."""
    from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer
    cols, valid = columns(5)
    x = cols[0]
    x[::37] = NAN
    bounds = tuple((float(b),) for b in
                   (-100.5, -1.0, 0.0, 0.1, 2.5, 1e3, np.inf))
    part = JP.Partitioning(
        mode="range", num_partitions=len(bounds) + 1,
        sort_orders=(JE.SortExpr(child=col("x")),), range_bounds=bounds)
    got = PartitionIdComputer(port_expr(part), port_schema(SCHEMA))(
        from_numpy(port_schema(SCHEMA), cols, valid, device="cpu")).numpy()
    b32 = np.array([b for (b,) in bounds], np.float32)
    exp = np.where(valid[0], np.where(np.isnan(x), len(b32),
                                      (b32[None, :] < x[:, None]).sum(1)), 0)
    np.testing.assert_array_equal(got, exp)


# -- aggregates ----------------------------------------------------------------

SPEC_IDS = np.sort(np.random.default_rng(9).choice(
    np.arange(60)[np.arange(60) % 3 != 1], 2000))
SPECS = {"sum": F64, "avg": F64, "max": F32, "first": F32}


@pytest.mark.parametrize("fname", list(SPECS))
def test_specs_match(fname):
    """update, merge, final over float32 values (no NaN: the JAX scan's
    NaN is ROADMAP Queue 3 item 11): Max and First bit for bit, the
    float64 sums to relative 1e-12."""
    from auron_tpu.ops.agg import functions as jfn
    from auron_tpu_torch.ops.agg import functions as pfn
    rng = np.random.default_rng(len(fname))
    x = _floats(rng, len(SPEC_IDS))
    v = rng.random(len(x)) >= 0.2
    p, j = _pair(x, v)
    out = SPECS[fname]
    port = pfn.make_spec(fname, port_type(out), "a")
    jax = jfn.make_spec(fname, F32, out, "a")
    ids = SPEC_IDS
    pu = port.update_segments([p], torch.from_numpy(ids), 60)
    ju = jax.update_segments([j], jnp.asarray(ids.astype(np.int32)), 60)
    mids = np.arange(60) // 2
    pm = port.merge_segments(pu, torch.from_numpy(mids), 30)
    jm = jax.merge_segments(ju, jnp.asarray(mids.astype(np.int32)), 30)
    for got, exp in ((pu, ju), (pm, jm),
                     ([port.eval_final(pm)], [jax.eval_final(jm)])):
        for g, e in zip(got, exp):
            gv, ev = g.validity.numpy(), np.asarray(e.validity)
            np.testing.assert_array_equal(gv, ev)
            gd, ed = g.data.numpy()[gv], np.asarray(e.data)[ev]
            assert gd.dtype == ed.dtype
            if fname in ("sum", "avg") and gd.dtype.kind == "f":
                np.testing.assert_allclose(gd, ed, rtol=1e-12, atol=1e-9)
            else:
                np.testing.assert_array_equal(gd, ed)


AGG_SCHEMA = JS.of(JF("k", F32), JF("v", F32))
AGGS = (("s", "sum", F64), ("m", "avg", F64), ("lo", "min", F32),
        ("hi", "max", F32), ("n", "count", I64))


def _agg_plan(child, mode):
    return JP.Agg(
        child=child, exec_mode=mode, grouping=(col("k"),),
        grouping_names=("k",),
        aggs=tuple(JE.AggExpr(fn=f, children=(col("v"),), return_type=rt)
                   for _, f, rt in AGGS),
        agg_names=tuple(a[0] for a in AGGS))


def _grouped(cols, names):
    """{key: values} with float keys as their bits (NaN -> 'nan')."""
    out = {}
    kd, kv = cols["k"]
    for i in range(len(kd)):
        k = None if not kv[i] else ("nan" if kd[i] != kd[i] else
                                    float(kd[i]))
        assert k not in out, k
        out[k] = tuple(cols[n][0][i].item() if cols[n][1][i] else None
                       for n in names)
    return out


def _assert_groups(got, exp):
    assert set(got) == set(exp)
    for k in exp:
        for g, e, (name, _, _) in zip(got[k], exp[k], AGGS):
            if g is None or e is None:
                assert g is None and e is None, (k, name)
            elif g == e:
                continue
            elif name in ("s", "m") and e == e:
                assert abs(g - e) <= 1e-9 * abs(e) + 1e-9, (k, name, g, e)
            else:
                assert g == e or (g != g and e != e), (k, name, g, e)


def test_partial_final_agg_matches():
    """Partial -> final by a float32 key with ties, nulls, +-inf: equal
    to the JAX package (no -0.0 or NaN key, where it departs: Queue 3
    item 12), the key out as a float32, sum and average float64."""
    rng = np.random.default_rng(6)
    n = 4000
    k = np.round(rng.normal(size=n) * 20).astype(np.float32) + \
        np.float32(0.25)
    k[::97] = np.inf
    v = _floats(rng, n)
    cols, valid = [k, v], [rng.random(n) >= 0.05 for _ in range(2)]
    src = JP.FFIReader(schema=AGG_SCHEMA, resource_id="src")
    parts = TP.chunks(cols, valid, 900)
    arrow = [TP.to_arrow(*p, schema=AGG_SCHEMA) for p in parts]
    port, jax = TP.run_both(_agg_plan(src, "partial"), arrow, parts)
    states = JS.of(JF("k", F32), JF("s#sum", F64), JF("m#sum", F64),
                   JF("m#count", I64, nullable=False), JF("lo#min", F32),
                   JF("hi#max", F32), JF("n#count", I64, nullable=False))
    got = port.to_numpy()
    assert got["k"][0].dtype == np.float32
    snames = [f.name for f in states.fields]
    sc, sv = [got[x][0] for x in snames], [got[x][1] for x in snames]
    final = _agg_plan(JP.FFIReader(schema=states, resource_id="st"),
                      "final")
    sparts = [(sc, sv)]
    port, jax = TP.run_both(final, [TP.to_arrow(*p, schema=states)
                                    for p in sparts], sparts)
    names = tuple(a[0] for a in AGGS)
    _assert_groups(_grouped(port.to_numpy(), names),
                   _grouped(TP.jax_columns(jax.batches, ("k",) + names),
                            names))


# -- window ------------------------------------------------------------------------

WIN = JS.of(JF("p", I64), JF("o", F32), JF("v", F32))


@pytest.mark.parametrize("ordered", [True, False])
def test_window_aggregates_match(ordered):
    """rank over a float32 order key, count, sum and avg (float64), min
    and max (float32) over float32 values, running and whole-partition
    (no NaN, Queue 3 item 18, and no infinity, whose running sum the JAX
    package's prefix difference turns into NaN, item 17)."""
    rng = np.random.default_rng(7)
    n = 700
    cols = [rng.integers(0, 6, n).astype(np.int64),
            np.round(rng.normal(size=n) * 5).astype(np.float32) + 0,
            _floats(rng, n, specials=False)]
    valid = [rng.random(n) >= 0.07 for _ in cols]
    def agg(f, rt):
        return JP.WindowFuncCall(
            fn="agg", agg=JE.AggExpr(fn=f, children=(col("v"),),
                                     return_type=rt),
            return_type=rt, name=f)
    calls = (JP.WindowFuncCall(fn="rank", return_type=I32, name="rk"),
             agg("count", I64), agg("sum", F64), agg("avg", F64),
             agg("min", F32), agg("max", F32))
    plan = JP.Window(
        child=JP.FFIReader(schema=WIN, resource_id="src"),
        window_funcs=calls, partition_by=(col("p"),),
        order_by=(JE.SortExpr(child=col("o")),) if ordered else ())
    parts = TP.chunks(cols, valid, 200)
    port, jax = TP.run_both(plan, [TP.to_arrow(*p, schema=WIN)
                                   for p in parts], parts)
    names = ["p", "o", "v"] + [c.name for c in calls]
    got, exp = port.to_numpy(), TP.jax_columns(jax.batches, names)
    exact = [x for x in names if x not in ("sum", "avg")]
    TP.assert_same_rows(got, exp, exact)
    TP.assert_same_rows(got, exp, ["sum", "avg"], float_rel=1e-12)
    assert got["min"][0].dtype == np.float32


# -- joins ----------------------------------------------------------------------------

@pytest.mark.parametrize("op,jt", [("broadcast", "inner"),
                                   ("hash_right", "left"),
                                   ("smj", "left_semi")])
def test_float32_key_joins_match(op, jt):
    """Broadcast, shuffled hash and sort-merge joins on a float32 key (no
    NaN, where the JAX package matches nothing, Queue 3 item 15, and no
    subnormal, which it joins to 0.0, item 32): equal to the JAX package
    row for row and to a plain join."""
    import test_torch_joins as TJ
    from auron_tpu.it import compare
    from test_torch_decimal import join_sides
    pool = np.round(np.random.default_rng(17).normal(size=150) * 50,
                    1).astype(np.float32)
    pool[:4] = [0.0, np.inf, -np.inf, -0.0]
    ls, rs, left, right = join_sides(F32, pool, 18)
    port, ref = TJ.run_join(TJ.join_plan(op, jt, F32), left, right)
    assert compare.compare_tables(port, ref, ordered=True) is None
    assert TJ._assert_oracle(port, jt, left, right, ls, rs) > 0


# -- where the JAX package departs from Spark (ROADMAP Queue 3) ----------------

def test_hash_float32_is_sparks():
    """Queue 3 item 32.  Spark hashes a float as hashInt of
    `Float.floatToIntBits`: every NaN as 0x7FC00000, a subnormal by its
    bits, -0.0 as 0.0.  The JAX package hashes a NaN's own bits and, on
    XLA's CPU backend, a subnormal as 0.0."""
    from auron_tpu.exprs import hashing as JH
    from auron_tpu_torch.exprs import hashing as H
    x = np.array([NAN, NAN_NEG, NAN_PAYLOAD, SUBNORMAL, 0.0, -0.0],
                 np.float32)
    got = H.hash_float32(torch.from_numpy(x), torch.tensor(42)).tolist()
    canon = H.hash_int32(torch.tensor([0x7FC00000]), torch.tensor(42))
    bits = H.hash_int32(torch.tensor([1]), torch.tensor(42))
    zero = H.hash_int32(torch.tensor([0]), torch.tensor(42))
    assert got == [int(canon)] * 3 + [int(bits), int(zero), int(zero)]
    ref = np.asarray(JH.hash_float32(jnp.asarray(x), np.uint32(42)))
    assert ref[1] != got[1] and ref[2] != got[2]
    assert ref[3] == got[4] != got[3]


def test_float32_order_and_grouping_are_sparks():
    """Queue 3 item 33.  Spark orders floats with -0.0 equal to 0.0 and
    every NaN equal and above +inf, and groups them so.  Ascending over
    [0.0, -NaN, 1.0, -0.0, -inf, NaN, -1.0]: the port's permutation is
    [4, 6, 0, 3, 2, 1, 5] (ties in input order); the JAX package's
    `_orderable_u64_from_f32` puts -NaN first and -0.0 before 0.0: [1,
    4, 6, 3, 0, 2, 5], as float64's item 3.  Grouped: 5 groups in the
    port (one for +-0.0 as 0.0, one for the NaNs as the canonical NaN),
    7 in the JAX package."""
    from auron_tpu.ops import sort_keys as JK
    from auron_tpu_torch.ops import sort_keys as SK
    x = np.array([0.0, NAN_NEG, 1.0, -0.0, -np.inf, NAN, -1.0], np.float32)
    v = np.ones(len(x), bool)
    p, j = _pair(x, v)
    w = SK.encode_key_column(p)
    perm = SK.lexsort_indices(w, len(x), len(x))
    assert perm.tolist() == [4, 6, 0, 3, 2, 1, 5]
    jw = [np.asarray(t) for t in JK.encode_key_column(j)]
    assert np.lexsort(jw[::-1]).tolist() == [1, 4, 6, 3, 0, 2, 5]
    schema = JS.of(JF("k", F32), JF("v", F32))
    plan = JP.Agg(child=JP.FFIReader(schema=schema, resource_id="src"),
                  exec_mode="single", grouping=(col("k"),),
                  grouping_names=("k",),
                  aggs=(JE.AggExpr(fn="count", children=(col("v"),),
                                   return_type=I64),),
                  agg_names=("n",))
    items = [([x, x], [v, v])]
    port, jax = TP.run_both(plan, [TP.to_arrow(*items[0], schema=schema)],
                            items)
    got = port.to_numpy()
    assert sorted(zip(got["k"][0].view(np.uint32).tolist(),
                      got["n"][0].tolist())) == \
        [(0, 2), (0x3F800000, 1), (0x7FC00000, 2), (0xBF800000, 1),
         (0xFF800000, 1)]
    assert len(TP.jax_columns(jax.batches, ["k"])["k"][0]) == 7

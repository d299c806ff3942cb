"""Min, Max, First, StddevSamp / VarianceSamp and grouping on every key
type of auron_tpu_torch, against auron_tpu on the same seeded inputs.

- `sorted_segment_min` / `max` and `keys_equal_prev` against the JAX
  functions: integers bit for bit, float64 bit for bit where no NaN or
  -0.0 takes part; where one does, Spark's order decides (ROADMAP Queue 3
  item 11: the JAX scan propagates NaN).
- `MinMaxSpec`, `StddevSpec` and `FirstSpec` update, merge and final
  against the JAX specs, over groups of 0, 1, 2 and more valid rows:
  Min, Max, First and the counts bit for bit; the float sums of
  StddevSpec to relative 1e-9 (the JAX package sums by a segmented scan,
  the port by `index_add_`), bit for bit over integral values.
- `AggExec` in single mode and partial -> final over several batches,
  grouped by bool, date32, timestamp, float64 and mixed keys, through the
  same TaskDefinition bytes in both engines and against the pyarrow
  oracle: keys, counts, Min, Max and First exact, Average and the
  variance to relative 1e-9.  Float keys with -0.0 and NaNs are held to
  Spark's grouping (one group for +-0.0, one for every NaN, Queue 3
  item 12), which neither the JAX package nor pyarrow gives.
- Min and Max over a bool column by a key: pyarrow's (and Spark's)
  answer; the reference raises (Queue 3 item 16).
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from auron_tpu.columnar.batch import DeviceColumn as JCol
from auron_tpu.exprs import hashing as JH
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import to_arrow_type
from auron_tpu.ops import segments as jseg
from auron_tpu.ops import sort_keys as JSK
from auron_tpu.ops.agg import functions as jfn
from auron_tpu_torch.columnar.batch import DeviceColumn
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs import hashing as H
from auron_tpu_torch.ir import serde as pserde
from auron_tpu_torch.ir.schema import DataType, TypeId
from auron_tpu_torch.ops import segments as seg
from auron_tpu_torch.ops import sort_keys as SK
from auron_tpu_torch.ops.agg import functions as fn
from auron_tpu_torch.runtime.executor import execute_task
from auron_tpu_torch.runtime.resources import ResourceRegistry

import torch_parity as TP

F64, I64, I32 = TP.F64, TP.I64, TP.I32
NAN_NEG = np.uint64(0xFFF8000000000000).view(np.float64)
NAN_PAYLOAD = np.uint64(0x7FF0000000000123).view(np.float64)
CANONICAL_NAN = 0x7FF8000000000000

SEG_TYPES = {"int8": np.int8, "int16": np.int16, "int32": np.int32,
             "int64": np.int64, "date32": np.int32, "timestamp": np.int64,
             "float64": np.float64}


def _segment_ids(rng, n: int, n_seg: int) -> np.ndarray:
    """Ascending ids over n_seg segments, every third one empty."""
    used = np.arange(n_seg)[np.arange(n_seg) % 3 != 1]
    return np.sort(rng.choice(used, n))


def _values(rng, typ: str, n: int) -> np.ndarray:
    dt = SEG_TYPES[typ]
    if typ == "float64":
        x = np.round(rng.normal(size=n) * 1e6, 3)
        x[::37], x[::41] = np.inf, -np.inf
        return x
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    x[::53], x[::59] = info.min, info.max
    return x


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("typ", list(SEG_TYPES))
def test_sorted_segment_extreme_matches(typ, op):
    """Bit for bit, empty segments (the type's identity) and +-inf
    included."""
    rng = np.random.default_rng(len(typ) * 7 + len(op))
    n, n_seg = 2000, 90
    x, ids = _values(rng, typ, n), _segment_ids(rng, n, n_seg)
    port_fn = seg.sorted_segment_min if op == "min" else \
        seg.sorted_segment_max
    jax_fn = jseg.sorted_segment_min if op == "min" else \
        jseg.sorted_segment_max
    got = port_fn(torch.from_numpy(x), torch.from_numpy(ids), n_seg).numpy()
    exp = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(ids.astype(np.int32)),
                            n_seg))
    assert got.dtype == exp.dtype
    np.testing.assert_array_equal(got.view(f"u{got.itemsize}"),
                                  exp.view(f"u{exp.itemsize}"))


def test_float_extremes_are_sparks_order():
    """NaN above +inf and every NaN equal, -0.0 equal to 0.0; a winning
    NaN or zero comes out normalized.  The JAX scan's min of [1.0, NaN]
    is NaN (ROADMAP Queue 3 item 11); Spark's is 1.0."""
    x = np.array([1.0, np.nan, -0.0, 0.0, NAN_NEG, NAN_PAYLOAD, -np.inf,
                  3.0, np.inf, np.nan, -0.0, -0.0])
    ids = np.array([0, 0, 1, 1, 2, 2, 3, 3, 5, 5, 6, 6])
    mn = seg.sorted_segment_min(torch.from_numpy(x), torch.from_numpy(ids),
                                7).numpy()
    mx = seg.sorted_segment_max(torch.from_numpy(x), torch.from_numpy(ids),
                                7).numpy()
    bits = lambda a: a.view(np.uint64).tolist()  # noqa: E731
    nan, zero = CANONICAL_NAN, 0
    inf = int(np.float64(np.inf).view(np.uint64))
    ninf = int(np.float64(-np.inf).view(np.uint64))
    assert bits(mn) == [int(np.float64(1.0).view(np.uint64)), zero, nan,
                        ninf, inf, inf, zero]
    assert bits(mx) == [nan, zero, nan, int(np.float64(3.0).view(np.uint64)),
                        ninf, nan, zero]
    ref = np.asarray(jseg.sorted_segment_min(jnp.asarray(x),
                                             jnp.asarray(ids.astype(np.int32)),
                                             7))
    assert np.isnan(ref[0])          # the reference's fault


@pytest.mark.parametrize("op", ["min", "max"])
def test_bool_extremes_order_false_first(op):
    x = torch.tensor([True, False, True, True, False, False])
    ids = torch.tensor([0, 0, 1, 1, 2, 2])
    f = seg.sorted_segment_min if op == "min" else seg.sorted_segment_max
    exp = [False, True, False] if op == "min" else [True, True, False]
    assert f(x, ids, 4).tolist() == exp + [op == "min"]


def test_f64_word_round_trips():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=500) * 10.0 ** rng.integers(
        -300, 300, 500), [np.inf, -np.inf, 0.0, 5e-324, -5e-324]])
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(SK.f64_from_word(SK.f64_word(t)).numpy(),
                                  x)
    w = SK.f64_word(torch.from_numpy(np.array([-0.0, NAN_NEG, NAN_PAYLOAD])))
    assert SK.f64_from_word(w).numpy().view(np.uint64).tolist() == \
        [0, CANONICAL_NAN, CANONICAL_NAN]


@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_keys_equal_prev_matches(n_words):
    rng = np.random.default_rng(n_words)
    words = [np.sort(rng.integers(0, 4, 600)) for _ in range(n_words)]
    got = SK.keys_equal_prev([torch.from_numpy(w) for w in words]).numpy()
    exp = np.asarray(JSK.keys_equal_prev(
        [jnp.asarray(w.astype(np.uint64)) for w in words]))
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("typ", ["bool", "int8", "int16", "date32"])
def test_narrow_key_hashes_match(typ):
    """Spark hashes bool, byte, short and date as hashInt of the value."""
    rng = np.random.default_rng(5)
    np_dt = {"bool": np.bool_, "int8": np.int8, "int16": np.int16,
             "date32": np.int32}[typ]
    x = rng.integers(-30000, 30000, 999).astype(np_dt)
    v = rng.random(999) > 0.1
    t = getattr(DataType, {"bool": "bool_"}.get(typ, typ))()
    jt = getattr(JDT, {"bool": "bool_"}.get(typ, typ))()
    got = H.hash_columns([DeviceColumn(t, torch.from_numpy(x),
                                       torch.from_numpy(v))]).numpy()
    exp = np.asarray(JH.hash_columns([JCol(jt, jnp.asarray(x),
                                           jnp.asarray(v))]))
    np.testing.assert_array_equal(got, exp)


# -- the specs against the JAX specs -----------------------------------------

# groups of 0 (ids 1, 4), 1 and 2 valid rows (after nulls), then bigger
SPEC_IDS = np.array([0, 0, 2, 3, 3, 5, 5, 5, 6, 7, 7, 7, 7, 8] +
                    [9] * 20 + [10] * 33)
SPEC_VALID = np.ones(len(SPEC_IDS), bool)
SPEC_VALID[[3, 8, 9, 10]] = False     # group 3 keeps 1 row, 6 none, 7 two
N_SPEC_SEG = 12                       # 11 empty


def _spec_values(typ: str, integral: bool = False):
    rng = np.random.default_rng(len(typ))
    n = len(SPEC_IDS)
    if typ == "float64":
        x = rng.integers(-900, 900, n).astype(np.float64) if integral else \
            np.round(rng.normal(size=n) * 1e3, 4)
        return x
    if typ == "bool":
        return rng.random(n) < 0.5
    return _values(rng, typ, n)


def _types(typ: str):
    name = {"bool": "bool_", "timestamp": "timestamp_us"}.get(typ, typ)
    return getattr(DataType, name)(), getattr(JDT, name)()


def _both_specs(fname, typ, out=None):
    t, jt = _types(typ)
    ot, jot = _types(out) if out else (t, jt)
    return (fn.make_spec(fname, ot, "a"),
            jfn.make_spec(fname, jt, jot, "a"))


def _port_cols(x, v, t):
    return [DeviceColumn(t, torch.from_numpy(np.where(v, x, 0).astype(
        x.dtype)), torch.from_numpy(v))]


def _jax_cols(x, v, jt):
    return [JCol(jt, jnp.asarray(np.where(v, x, 0).astype(x.dtype)),
                 jnp.asarray(v))]


def _np_states(states):
    return [(np.asarray(s.data), np.asarray(s.validity)) for s in states]


def _assert_states(got, exp, float_rel=0.0):
    assert len(got) == len(exp)
    for (gd, gv), (ed, ev) in zip(got, exp):
        np.testing.assert_array_equal(gv, ev)
        # null slots hold zeros in the port
        assert not np.any(gd[~gv].astype(bool))
        gd, ed = gd[gv], ed[ev].astype(gd.dtype)
        if gd.dtype.kind == "f" and float_rel:
            np.testing.assert_allclose(gd, ed, rtol=float_rel, atol=0)
        elif gd.dtype.kind == "f":
            np.testing.assert_array_equal(gd.view(np.uint64),
                                          ed.view(np.uint64))
        else:
            np.testing.assert_array_equal(gd, ed)


def _spec_round(port, jax, x, v, t, jt, float_rel=0.0):
    """update over SPEC_IDS, merge of those states with pairs of groups
    joined, final: each step of the port held to the JAX spec's."""
    ids = SPEC_IDS
    pu = port.update_segments(_port_cols(x, v, t), torch.from_numpy(ids),
                              N_SPEC_SEG)
    ju = jax.update_segments(_jax_cols(x, v, jt),
                             jnp.asarray(ids.astype(np.int32)), N_SPEC_SEG)
    _assert_states(_np_states(pu), _np_states(ju), float_rel)
    merge_ids = np.arange(N_SPEC_SEG) // 2
    pm = port.merge_segments(pu, torch.from_numpy(merge_ids),
                             N_SPEC_SEG // 2)
    jm = jax.merge_segments(ju, jnp.asarray(merge_ids.astype(np.int32)),
                            N_SPEC_SEG // 2)
    _assert_states(_np_states(pm), _np_states(jm), float_rel)
    pf, jf = port.eval_final(pu), jax.eval_final(ju)
    _assert_states(_np_states([pf]), _np_states([jf]), float_rel)
    return _np_states(pu), _np_states([pf])[0]


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("typ", list(SEG_TYPES))
def test_min_max_spec_matches(typ, op):
    x = _spec_values(typ)
    port, jax = _both_specs(op, typ)
    t, jt = _types(typ)
    assert isinstance(port, fn.MinMaxSpec)
    assert [f.name for f in port.state_fields()] == \
        [f.name for f in jax.state_fields()] == [f"a#{op}"]
    states, final = _spec_round(port, jax, x, SPEC_VALID, t, jt)
    # no valid row (group 6, and the empty groups): null
    assert not final[1][[1, 4, 6, 11]].any() and final[1][[0, 3, 7]].all()


@pytest.mark.parametrize("fname", ["stddev_samp", "var_samp"])
@pytest.mark.parametrize("typ,integral", [("float64", False),
                                          ("float64", True),
                                          ("int32", True)])
def test_stddev_spec_matches(fname, typ, integral):
    """Over integral values the power sums are exact in any order, so the
    states are bit for bit; otherwise relative 1e-9.  One valid row gives
    NaN, none null."""
    x = _spec_values(typ, integral)
    if typ == "int32":
        x = (x % 1000).astype(np.int32)
    port, jax = _both_specs(fname, typ, "float64")
    t, jt = _types(typ)
    assert [f.name for f in port.state_fields()] == \
        [f.name for f in jax.state_fields()]
    _, (fd, fv) = _spec_round(port, jax, x, SPEC_VALID, t, jt,
                              0.0 if integral else 1e-9)
    assert np.isnan(fd[3]) and fv[3] and not fv[6] and fd[6] == 0
    vals = x[(SPEC_IDS == 10) & SPEC_VALID].astype(np.float64)
    exp = vals.std(ddof=1) if fname == "stddev_samp" else vals.var(ddof=1)
    assert abs(fd[10] - exp) <= 1e-9 * exp


@pytest.mark.parametrize("fname", ["first", "first_ignores_null"])
@pytest.mark.parametrize("typ", ["bool", "int32", "date32", "timestamp",
                                 "float64"])
def test_first_spec_matches(typ, fname):
    x = _spec_values(typ)
    port, jax = _both_specs(fname, typ)
    t, jt = _types(typ)
    v = SPEC_VALID.copy()
    v[[0, 5]] = False          # a group whose first row is null
    _, (fd, fv) = _spec_round(port, jax, x, v, t, jt)
    # group 0: rows 0 (null), 1; group 5: rows 5 (null), 6, 7
    assert fv[0] == (fname == "first_ignores_null")
    assert fv[5] == (fname == "first_ignores_null")
    if fv[5]:
        assert fd[5] == x[6]


def test_stddev_cancellation_on_a_near_constant_group():
    """The power-sum states lose a near-constant group's variance to
    cancellation, in the port as in the reference, whose state layout is
    the wire's (ROADMAP Queue 3 item 13): 1e8 + [0.1, 0.2, 0.3] has
    numpy var(ddof=1) 0.01; the power sums give 0.0."""
    x = 1e8 + np.array([0.1, 0.2, 0.3])
    v = np.ones(3, bool)
    ids = np.zeros(3, np.int64)
    port, jax = _both_specs("var_samp", "float64")
    t, jt = _types("float64")
    pf = port.eval_final(port.update_segments(_port_cols(x, v, t),
                                              torch.from_numpy(ids), 1))
    jf = jax.eval_final(jax.update_segments(_jax_cols(x, v, jt),
                                            jnp.asarray(ids.astype(np.int32)),
                                            1))
    got, ref = float(pf.data[0]), float(np.asarray(jf.data)[0])
    assert got == ref == 0.0
    assert abs(np.var(x, ddof=1) - 0.01) < 1e-6


def test_make_spec_builds_every_device_aggregate():
    t, f = DataType.int32(), DataType.float64()
    for name, cls in (("min", fn.MinMaxSpec), ("max", fn.MinMaxSpec),
                      ("first", fn.FirstSpec),
                      ("first_ignores_null", fn.FirstSpec),
                      ("stddev_samp", fn.StddevSpec),
                      ("var_samp", fn.StddevSpec), ("avg", fn.AvgSpec),
                      ("sum", fn.SumSpec), ("count", fn.CountSpec)):
        out = f if name in ("stddev_samp", "var_samp", "avg") else t
        assert isinstance(fn.make_spec(name, out, "a"), cls), name
    with pytest.raises(NotImplementedError):
        fn.make_spec("collect_list", t, "a")
    with pytest.raises(NotImplementedError):
        fn.make_spec("min", DataType(TypeId.STRING), "a")


# -- AggExec through both engines and the oracle -----------------------------

KEY_TYPES = {"bool": TP.JDT.bool_(), "date32": TP.JDT.date32(),
             "timestamp": TP.JDT.timestamp_us(), "float64": F64,
             "int16": TP.JDT.int16()}
AGG_FNS = (("mn_i", "min", "vi", I32), ("mx_i", "max", "vi", I32),
           ("mn_f", "min", "vf", F64), ("mx_f", "max", "vf", F64),
           ("first_i", "first", "vi", I32),
           ("first_f", "first_ignores_null", "vf", F64),
           ("sd", "stddev_samp", "vf", F64), ("var", "var_samp", "vi", F64),
           ("avg", "avg", "vf", F64), ("n", "count", "vi", I64))
STATE_KINDS = {"min": ("min",), "max": ("max",), "first": ("first",),
               "first_ignores_null": ("first",),
               "stddev_samp": ("sum", "sumsq", "count"),
               "var_samp": ("sum", "sumsq", "count"),
               "avg": ("sum", "count"), "count": ("count",)}
FLOAT_OUTS = {"sd", "var", "avg"}


def _key_values(rng, typ: str, n: int) -> np.ndarray:
    if typ == "bool":
        return rng.random(n) < 0.3
    if typ == "date32":
        return rng.integers(10950, 11010, n).astype(np.int32)
    if typ == "timestamp":
        return (946684800 + rng.integers(0, 40, n) * 86400).astype(
            np.int64) * 1_000_000
    if typ == "int16":
        return rng.integers(-40, 40, n).astype(np.int16)
    keys = np.round(rng.normal(size=30) * 100.0, 1)
    keys[:3] = (np.inf, -np.inf, 0.0)
    return rng.choice(keys, n)


def _agg_input(key_types, n: int, seed: int):
    """Key columns k0.. of `key_types` (5% nulls each), int32 vi and
    float64 vf (10% nulls) and the plan's source schema."""
    rng = np.random.default_rng(seed)
    cols = [_key_values(rng, t, n) for t in key_types]
    cols += [rng.integers(-500, 500, n).astype(np.int32),
             np.round(rng.normal(size=n) * 50.0, 2)]
    valid = [rng.random(n) >= 0.05 for _ in key_types] + \
        [rng.random(n) >= 0.1, rng.random(n) >= 0.1]
    schema = TP.JS.of(*[TP.JF(f"k{i}", KEY_TYPES[t])
                        for i, t in enumerate(key_types)],
                      TP.JF("vi", I32), TP.JF("vf", F64))
    return cols, valid, schema


def _aggs():
    return tuple(JE.AggExpr(fn=f, children=(JE.col(c),), return_type=rt)
                 for _, f, c, rt in AGG_FNS)


def _agg(child, mode, nk):
    keys = tuple(JE.col(f"k{i}") for i in range(nk))
    return JP.Agg(child=child, exec_mode=mode, grouping=keys,
                  grouping_names=tuple(f"k{i}" for i in range(nk)),
                  aggs=_aggs(), agg_names=tuple(a[0] for a in AGG_FNS))


def _state_schema(schema, nk):
    fields = list(schema.fields[:nk])
    for name, f, _, rt in AGG_FNS:
        for kind in STATE_KINDS[f]:
            dt = I64 if kind == "count" else \
                F64 if kind in ("sum", "sumsq") else rt
            fields.append(TP.JF(f"{name}#{kind}", dt,
                                nullable=kind != "count"))
    return TP.JS(tuple(fields))


def _key_of(vals):
    return tuple(None if v is None else
                 ("nan" if isinstance(v, float) and v != v else v)
                 for v in vals)


def _keyed(cols, nk, names):
    """{key tuple: value tuple}, nulls as None, every NaN as 'nan'."""
    n = len(cols["k0"][0])
    out = {}
    for i in range(n):
        key = _key_of([cols[f"k{j}"][0][i].item() if cols[f"k{j}"][1][i]
                       else None for j in range(nk)])
        assert key not in out, f"group {key} appears twice"
        out[key] = tuple(cols[m][0][i].item() if cols[m][1][i] else None
                         for m in names)
    return out


def _assert_same_keyed(got, exp, names, float_rel=1e-9):
    assert set(got) == set(exp)
    for k, ev in exp.items():
        for name, g, e in zip(names, got[k], ev):
            if g is None or e is None:
                assert g is None and e is None, (k, name, g, e)
            elif isinstance(e, float) and (e != e or g != g):
                assert g != g and e != e, (k, name, g, e)
            elif name in FLOAT_OUTS or name.endswith(("#sum", "#sumsq")):
                assert abs(g - e) <= float_rel * abs(e), (k, name, g, e)
            else:
                assert g == e, (k, name, g, e)


def _oracle(cols, valid, schema, nk):
    """pyarrow's group-by of the same rows (`first` with skip_nulls
    False: Spark's takes a null first row)."""
    table = pa.Table.from_batches([TP.to_arrow(cols, valid, schema)])
    keys = [f"k{i}" for i in range(nk)]
    skip = pc.ScalarAggregateOptions(skip_nulls=True)
    keep = pc.ScalarAggregateOptions(skip_nulls=False)
    specs = [("vi", "min", skip), ("vi", "max", skip), ("vf", "min", skip),
             ("vf", "max", skip), ("vi", "first", keep),
             ("vf", "first", skip),
             ("vf", "stddev", pc.VarianceOptions(ddof=1)),
             ("vi", "variance", pc.VarianceOptions(ddof=1)),
             ("vf", "mean", skip), ("vi", "count", None)]
    res = table.group_by(keys, use_threads=False).aggregate(
        specs + [("vf", "count", None)])
    cols = TP.jax_columns(res.to_batches(), keys + [
        f"{c}_{op}" for c, op, _ in specs] + ["vf_count"])
    for (name, *_), (c, op, _) in zip(AGG_FNS, specs):
        cols[name] = cols.pop(f"{c}_{op}")
    # pyarrow's sample variance over one value is null; the JAX package's
    # NaN (Spark's only under spark.sql.legacy.statisticalAggregate:
    # ROADMAP Queue 3 item 14)
    for name, n in (("sd", cols.pop("vf_count")[0]), ("var", cols["n"][0])):
        d, v = cols[name]
        cols[name] = (np.where(n == 1, np.nan, d), v | (n == 1))
    return cols


def _run(plan, cols, valid, schema, batch_rows):
    parts = TP.chunks(cols, valid, batch_rows)
    arrow = [TP.to_arrow(*p, schema=schema) for p in parts]
    return TP.run_both(plan, arrow, parts)


NAMES = tuple(a[0] for a in AGG_FNS)


@pytest.mark.parametrize("strategy", ["radix", "argsort"])
@pytest.mark.parametrize("key_types", [("bool",), ("date32",),
                                       ("timestamp",), ("float64",),
                                       ("int16",),
                                       ("bool", "date32", "float64"),
                                       ("timestamp", "int16")],
                         ids="-".join)
def test_single_agg_by_key_types_matches(key_types, strategy):
    """Single mode over several batches, both sort forms (First needs a
    stable sort in each): equal to the JAX engine and to pyarrow."""
    nk = len(key_types)
    cols, valid, schema = _agg_input(key_types, 3000, seed=nk * 11)
    plan = _agg(JP.FFIReader(schema=schema, resource_id="src"), "single",
                nk)
    with conf.scoped({"auron.kernel.sort.strategy": strategy}):
        port, jax = _run(plan, cols, valid, schema, 700)
    got = _keyed(port.to_numpy(), nk, NAMES)
    keys = tuple(f"k{i}" for i in range(nk))
    exp = _keyed(TP.jax_columns(jax.batches, keys + NAMES), nk, NAMES)
    _assert_same_keyed(got, exp, NAMES)
    orc = _keyed(_oracle(cols, valid, schema, nk), nk, NAMES)
    _assert_same_keyed(got, orc, NAMES)
    assert any(None in k for k in got)          # null keys group


@pytest.mark.parametrize("key_types", [("bool",), ("date32",),
                                       ("timestamp",), ("float64",),
                                       ("bool", "date32", "float64")],
                         ids="-".join)
def test_partial_final_agg_by_key_types_matches(key_types):
    """Partial states (both engines, the same), then the port's states
    split as two map tasks would send them into both engines' final."""
    nk = len(key_types)
    cols, valid, schema = _agg_input(key_types, 4000, seed=nk * 13 + 1)
    src = JP.FFIReader(schema=schema, resource_id="src")
    port, jax = _run(_agg(src, "partial", nk), cols, valid, schema, 900)
    states = _state_schema(schema, nk)
    snames = tuple(f.name for f in states.fields)
    got = port.to_numpy()
    _assert_same_keyed(_keyed(got, nk, snames[nk:]),
                       _keyed(TP.jax_columns(jax.batches, snames), nk,
                              snames[nk:]), snames[nk:])
    sc, sv = [got[x][0] for x in snames], [got[x][1] for x in snames]
    half = len(sc[0]) // 2
    sparts = [([c[:half] for c in sc], [v[:half] for v in sv]),
              ([c[half:] for c in sc], [v[half:] for v in sv])]
    final = _agg(JP.FFIReader(schema=states, resource_id="st"), "final", nk)
    port, jax = TP.run_both(final, [TP.to_arrow(*p, schema=states)
                                    for p in sparts], sparts)
    keys = tuple(f"k{i}" for i in range(nk))
    fin = _keyed(port.to_numpy(), nk, NAMES)
    _assert_same_keyed(fin, _keyed(TP.jax_columns(jax.batches, keys + NAMES),
                                   nk, NAMES), NAMES)
    _assert_same_keyed(fin, _keyed(_oracle(cols, valid, schema, nk), nk,
                                   NAMES), NAMES)


def test_float_keys_group_as_spark():
    """-0.0 groups with 0.0 and every NaN (either sign, any payload) with
    the others, and the key comes out normalized, as Spark's
    NormalizeFloatingNumbers leaves it.  The JAX engine keeps -0.0 apart
    from 0.0 and splits the NaNs by sign (ROADMAP Queue 3 item 12), and
    pyarrow keeps -0.0 apart; neither decides."""
    rng = np.random.default_rng(17)
    n = 4000
    pool = np.array([-0.0, 0.0, np.nan, NAN_NEG, NAN_PAYLOAD, 1.5, -2.25,
                     np.inf, -np.inf])
    k = rng.choice(pool, n)
    vf = rng.choice(np.array([np.nan, -0.0, 0.0, 3.0, -np.inf, 7.5]), n)
    vi = rng.integers(-9, 9, n).astype(np.int32)
    valid = [rng.random(n) >= 0.04, rng.random(n) >= 0.1,
             rng.random(n) >= 0.1]
    schema = TP.JS.of(TP.JF("k0", F64), TP.JF("vi", I32), TP.JF("vf", F64))
    aggs = (JE.AggExpr(fn="count", children=(JE.col("vi"),), return_type=I64),
            JE.AggExpr(fn="min", children=(JE.col("vf"),), return_type=F64),
            JE.AggExpr(fn="max", children=(JE.col("vf"),), return_type=F64),
            JE.AggExpr(fn="first_ignores_null", children=(JE.col("vf"),),
                       return_type=F64))
    names = ("n", "mn", "mx", "fst")
    plan = JP.Agg(child=JP.FFIReader(schema=schema, resource_id="src"),
                  exec_mode="single", grouping=(JE.col("k0"),),
                  grouping_names=("k0",), aggs=aggs, agg_names=names)
    port, jax = _run(plan, [k, vi, vf], valid, schema, 1000)
    out = port.to_numpy()
    kd, kv = out["k0"]
    assert sorted(kd[kv].view(np.uint64).tolist()) == sorted(
        np.array([0.0, np.nan, 1.5, -2.25, np.inf, -np.inf])
        .view(np.uint64).tolist())
    got = _keyed(out, 1, names)
    # Spark: keys normalized; Min / Max over NaN as the greatest value,
    # -0.0 equal to 0.0; first_ignores_null the first non-null value
    exp = {}
    for i in range(n):
        key = _key_of([(float(k[i]) + 0.0) if valid[0][i] else None])
        cnt, mn, mx, fst = exp.get(key, (0, None, None, None))
        cnt += int(valid[1][i])
        if valid[2][i]:
            x = float(vf[i])
            order = lambda a: (a != a, a)  # noqa: E731
            mn = x if mn is None or order(x) < order(mn) else mn
            mx = x if mx is None or order(x) > order(mx) else mx
            fst = x if fst is None else fst
        exp[key] = (cnt, mn, mx, fst)
    assert set(got) == set(exp)
    for key, (cnt, mn, mx, fst) in exp.items():
        g = got[key]
        assert g[0] == cnt
        for gv, ev in zip(g[1:], (mn, mx, fst)):
            assert (gv is None) == (ev is None)
            if ev is not None:
                assert (gv != gv and ev != ev) or gv == ev, (key, gv, ev)
    # the first non-null value keeps its bits (-0.0 stays -0.0)
    fd, fv = out["fst"]
    firsts = {}
    for i in range(n):
        key = _key_of([(float(k[i]) + 0.0) if valid[0][i] else None])
        if valid[2][i] and key not in firsts:
            firsts[key] = vf[i].view(np.uint64)
    for i, key in enumerate(_keyed(out, 1, ()).keys()):
        assert fd[i].view(np.uint64) == firsts[key]
    ref_keys = TP.jax_columns(jax.batches, ("k0",))["k0"]
    assert len(ref_keys[0]) > len(kd)        # the reference's split


@pytest.mark.parametrize("mode", ["single", "final"])
def test_global_min_max_first_stddev_over_no_rows(mode):
    """No input rows: Min, Max, First and the variances are null, the
    count 0, in both engines."""
    schema = TP.JS.of(TP.JF("vi", I32), TP.JF("vf", F64))
    aggs = _aggs()
    if mode == "final":
        schema = _state_schema(schema, 0)
    plan = JP.Agg(child=JP.FFIReader(schema=schema, resource_id="src"),
                  exec_mode=mode, grouping=(), grouping_names=(),
                  aggs=aggs, agg_names=NAMES)
    port, jax = TP.run_both(plan, [], [])
    got = port.to_numpy()
    TP.assert_same_rows(got, TP.jax_columns(jax.batches, NAMES), NAMES)
    assert got["n"][0].tolist() == [0]
    assert not any(got[x][1][0] for x in NAMES if x != "n")


def test_bool_min_max_by_key_is_pyarrows():
    """Min and Max of a bool column by an int64 key (ROADMAP Queue 3 item
    16): the port gives pyarrow's (and Spark's) min [false, true, NULL]
    and max [true, true, NULL] for keys 1, 2, 3; the reference raises
    `ValueError` (np.iinfo of bool), pinned here."""
    k = np.array([1, 1, 2, 2, 3], np.int64)
    b = np.array([True, False, True, False, False])
    bv = np.array([True, True, True, False, False])
    schema = TP.JS.of(TP.JF("k", I64), TP.JF("b", JDT.bool_()))
    aggs = tuple(JE.AggExpr(fn=f, children=(JE.col("b"),),
                            return_type=JDT.bool_()) for f in ("min", "max"))
    plan = JP.Agg(child=JP.FFIReader(schema=schema, resource_id="src"),
                  exec_mode="single", grouping=(JE.col("k"),),
                  grouping_names=("k",), aggs=aggs, agg_names=("mn", "mx"))
    rb = pa.RecordBatch.from_arrays(
        [pa.array(k, type=to_arrow_type(I64)),
         pa.array(b, type=pa.bool_(), mask=~bv)], names=["k", "b"])
    with pytest.raises(ValueError, match="Invalid integer data type"):
        TP.run_both(plan, [rb], [rb])
    res = ResourceRegistry()
    res.put("src", [rb])
    out = execute_task(pserde.from_json(jserde.to_json(
        JP.TaskDefinition(plan=plan))), res, device="cpu").to_numpy()
    got = {int(kk): tuple(bool(out[n][0][i]) if out[n][1][i] else None
                          for n in ("mn", "mx"))
           for i, kk in enumerate(out["k"][0])}
    exp = pa.table({"k": k, "b": pa.array(b, mask=~bv)}).group_by("k") \
        .aggregate([("b", "min"), ("b", "max")]).to_pylist()
    assert got == {r["k"]: (r["b_min"], r["b_max"]) for r in exp}
    assert got == {1: (False, True), 2: (True, True), 3: (None, None)}

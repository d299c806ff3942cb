"""The scalar functions of auron_tpu_torch (`exprs/functions.py`)
against auron_tpu's (`exprs/functions_device.py`) on the CPU, through
ProjectExec, as the same serialized TaskDefinition bytes over the same
seeded rows, bit for bit but where noted:
- `round(x, scale)` half-up at scales -2, 0 and 2 over float64, int32
  and int64 columns, the .5 ties (x.5, x.x5, x50 and their negatives)
  among the values, nulls kept.  A float result is numpy's
  `half_up(x * 10^s) / 10^s` bit for bit, and within one ulp of the
  reference's, whose division by the literal 10^s is XLA's multiply by
  its reciprocal (ROADMAP Queue 3 item 8);
- `coalesce` and `nvl` over flat columns (int and float, a literal
  last) and over string columns of different width buckets;
- a function outside the port's registry raises where the expression
  is built, naming it.
"""

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS

from test_torch_strings import _random_strings
from torch_parity import one_thread, run_both  # noqa: F401

I32, I64, F64, STR = JDT.int32(), JDT.int64(), JDT.float64(), JDT.string()
SRC = JS.of(JF("f", F64), JF("i", I32), JF("l", I64), JF("g", F64),
            JF("s", STR), JF("t", STR))
TIES_F = [0.5, 1.5, 2.5, -0.5, -1.5, 0.125, 0.135, 1.005, -2.675, 2.675,
          1234.5, 1250.0, -1250.0, 149.999, 0.0, 1e15 + 0.5]
TIES_I = [50, 150, 250, -50, -150, 149, -149, 1049, 1050, -1050, 0, 7]


def _batches(seed, n=400, size=150):
    rng = np.random.default_rng(seed)
    f = np.concatenate([TIES_F, np.round(rng.normal(0, 1000, n -
                                                    len(TIES_F)), 4)])
    i = np.concatenate([TIES_I, rng.integers(-10**6, 10**6,
                                             n - len(TIES_I))])
    cols = [
        pa.array(f, type=pa.float64(), mask=rng.random(n) < 0.1),
        pa.array(i.astype(np.int32), type=pa.int32(),
                 mask=rng.random(n) < 0.1),
        pa.array(i.astype(np.int64) * 1001, type=pa.int64(),
                 mask=rng.random(n) < 0.1),
        pa.array(rng.random(n), type=pa.float64(), mask=rng.random(n) < 0.5),
        pa.array(_random_strings(rng, n, max_len=6), type=pa.string(),
                 mask=rng.random(n) < 0.4),
        pa.array(_random_strings(rng, n, max_len=30), type=pa.string(),
                 mask=rng.random(n) < 0.4)]
    t = pa.Table.from_arrays(cols, names=list(SRC.names()))
    return t.to_batches(max_chunksize=size)


def _fn(name, *args, rtype=None):
    return JE.ScalarFunctionCall(name=name, args=tuple(args),
                                 return_type=rtype or JDT.null())


def _lit(v, t):
    return JE.Literal(value=v, dtype=t)


def _project(exprs, names):
    plan = JP.Projection(child=JP.FFIReader(schema=SRC, resource_id="src"),
                         exprs=tuple(exprs), names=tuple(names))
    batches = _batches(11)
    port, ref = run_both(plan, batches, batches)
    ref_t = pa.Table.from_batches(ref.batches)
    return port.to_numpy(), ref_t


def _bits(xs):
    return [None if x is None else np.float64(x).view(np.int64).item()
            for x in xs]


def _same(port, ref_t, name, kind):
    """The port's column; ints and strings equal to the reference's, the
    float64 bits within one ulp of it (the reference's division by a
    literal is not correctly rounded, ROADMAP Queue 3 item 8)."""
    d, v = port[name]
    got = [x if ok else None for x, ok in zip(d.tolist(), v.tolist())]
    exp = ref_t.column(name).to_pylist()
    if kind == "f":
        assert [x is None for x in got] == [x is None for x in exp], name
        assert all(abs(a - b) <= 1 for a, b in zip(_bits(got), _bits(exp))
                   if a is not None), name
    else:
        assert got == exp, name
    return got


@pytest.mark.parametrize("col,kind", [("f", "f"), ("i", "i"), ("l", "i")])
@pytest.mark.parametrize("scale", [-2, 0, 2])
def test_round_matches_the_reference(col, kind, scale):
    port, ref = _project([_fn("round", JE.col(col), _lit(scale, I32))],
                         ["r"])
    got = _same(port, ref, "r", kind)
    src = _batches(11)
    vals = [x for rb in src for x in rb.column(SRC.names().index(col))
            .to_pylist()]
    for x, r in zip(vals, got):
        if x is None:
            assert r is None
        elif kind == "i" and scale < 0:
            m = 10 ** -scale
            q, rem = divmod(abs(x), m)
            assert r == (1 if x > 0 else -1) * (q + (rem >= m // 2)) * m \
                or x == 0
        elif kind == "i":
            assert r == x
        else:       # half-up, correctly rounded: numpy's same operations
            m = 10.0 ** scale
            y = np.float64(x) * m
            y = np.floor(y + 0.5) if y >= 0 else np.ceil(y - 0.5)
            assert _bits([r]) == _bits([y / m])


def test_round_ties_go_away_from_zero():
    port, ref = _project([_fn("round", JE.col("f"), _lit(0, I32)),
                          _fn("round", JE.col("i"), _lit(-2, I32))],
                         ["r0", "rm2"])
    r0 = _same(port, ref, "r0", "f")
    rm2 = _same(port, ref, "rm2", "i")
    ties = dict(zip(TIES_F, r0))
    assert ties[0.5] == 1.0 and ties[2.5] == 3.0 and ties[-0.5] == -1.0 \
        and ties[-1.5] == -2.0 and ties[1234.5] == 1235.0
    iv = dict(zip(TIES_I, rm2))
    assert iv[50] == 100 and iv[150] == 200 and iv[-50] == -100 \
        and iv[149] == 100 and iv[1050] == 1100 and iv[-1050] == -1100


def test_coalesce_matches_the_reference():
    f, g, i, l, s, t = (JE.col(c) for c in "fgilst")
    exprs = [_fn("coalesce", g, f, rtype=F64),
             _fn("coalesce", g, _lit(-1.0, F64), rtype=F64),
             _fn("nvl", i, _lit(0, I32), rtype=I32),
             _fn("coalesce", l, _lit(None, I64), _lit(42, I64), rtype=I64),
             _fn("coalesce", g, f),
             _fn("coalesce", s, t, rtype=STR),
             _fn("nvl", t, s, rtype=STR),
             _fn("coalesce", s, t, _lit("none", STR), rtype=STR)]
    names = ["gf", "g_lit", "nvl_i", "l_null_lit", "gf_untyped", "st", "ts",
             "st_lit"]
    port, ref = _project(exprs, names)
    for name in names:
        kind = "f" if name.startswith("g") else "i"
        got = _same(port, ref, name, kind)
        assert any(x is not None for x in got)
    assert None not in port["st_lit"][0].tolist() and \
        port["st_lit"][1].all()


@pytest.mark.parametrize("name", ["upper", "abs", "date_add"])
def test_other_functions_raise_naming_themselves(name):
    from auron_tpu_torch.exprs.compiler import build_evaluator
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir.schema import DataType, Field, Schema
    e = E.ScalarFunctionCall(name=name, args=(E.col("x"),),
                             return_type=DataType.float64())
    with pytest.raises(NotImplementedError, match=repr(name)):
        build_evaluator((e,), Schema.of(Field("x", DataType.float64())))

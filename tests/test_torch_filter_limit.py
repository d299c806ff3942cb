"""FilterExec (with and without its fused projection) and LimitExec of
auron_tpu_torch against auron_tpu: the same serialized TaskDefinitions
over the same seeded batches, compared row by row in order, bit for
bit.  Plans: FFIReader -> Filter [-> Projection] [-> Limit]."""

import json

import pytest

from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu_torch.runtime.planner import PhysicalPlanner
from auron_tpu_torch.ops.basic import FilterExec
from auron_tpu_torch.ir import serde

import torch_parity as TP

NAMES = ("ss_customer_sk", "ss_quantity", "ss_sales_price")
SRC = JP.FFIReader(schema=TP.SRC_SCHEMA, resource_id="src")


def _lit(v, dt):
    return JE.Literal(value=v, dtype=dt)


def q96_predicates():
    """ss_quantity >= 20 AND ss_sales_price < 120.0, as the converter
    lowers q96's WHERE clause: two conjuncts."""
    return (JE.BinaryExpr(left=JE.col("ss_quantity"), op=">=",
                          right=_lit(20, TP.I32)),
            JE.BinaryExpr(left=JE.col("ss_sales_price"), op="<",
                          right=_lit(120.0, TP.F64)))


def _batches(n, size, seed):
    cols, valid = TP.make_sales(n, seed=seed)
    parts = TP.chunks(cols, valid, size)
    return parts, [TP.to_arrow(*p) for p in parts]


def _run(plan, n=9000, size=1000, seed=0, names=NAMES):
    parts, arrow = _batches(n, size, seed)
    port, jax = TP.run_both(plan, arrow, parts)
    got = port.to_numpy()
    exp = TP.jax_columns(jax.batches, names)
    TP.assert_same_rows(got, exp, names)
    return got


@pytest.mark.parametrize("size", [700, 1000, 4096])
def test_filter_matches(size):
    got = _run(JP.Filter(child=SRC, predicates=q96_predicates()), size=size)
    q, qv = got["ss_quantity"]
    p, pv = got["ss_sales_price"]
    assert qv.all() and pv.all() and (q >= 20).all() and (p < 120).all()
    assert 0 < len(q) < 9000


def test_filter_with_fused_projection_matches():
    plan = JP.Projection(
        child=JP.Filter(child=SRC, predicates=q96_predicates()),
        exprs=TP.projection(SRC).exprs, names=("ss_customer_sk", "sales"))
    _run(plan, names=("ss_customer_sk", "sales"))
    port_op = PhysicalPlanner().create_plan(
        serde.from_json(json.dumps(plan.to_dict())))
    assert isinstance(port_op, FilterExec) and port_op.exprs is not None


def test_filter_keeping_nothing_matches():
    pred = JE.BinaryExpr(left=JE.col("ss_quantity"), op=">",
                         right=_lit(1000, TP.I32))
    got = _run(JP.Filter(child=SRC, predicates=(pred,)))
    assert len(got["ss_quantity"][0]) == 0


@pytest.mark.parametrize("pred", ["is_null", "null_literal", "or"])
def test_filter_null_predicates_match(pred):
    """IS NULL keeps the null rows and never a padding row; a null
    predicate drops the row; Kleene OR keeps true-or-null only where
    true."""
    if pred == "is_null":
        p = JE.IsNull(child=JE.col("ss_sales_price"))
    elif pred == "null_literal":
        p = JE.Literal(value=None, dtype=TP.JDT.bool_())
    else:
        p = JE.BinaryExpr(
            left=JE.BinaryExpr(left=JE.col("ss_quantity"), op="<",
                               right=_lit(10, TP.I32)),
            op="or", right=JE.IsNull(child=JE.col("ss_customer_sk")))
    got = _run(JP.Filter(child=SRC, predicates=(p,)), size=700)
    if pred == "is_null":
        assert len(got["ss_sales_price"][0]) > 0
        assert not got["ss_sales_price"][1].any()
    if pred == "null_literal":
        assert len(got["ss_quantity"][0]) == 0


@pytest.mark.parametrize("limit,offset", [(10, 0), (2500, 700), (1000, 1000),
                                          (50, 8990), (5, 9000),
                                          (100000, 3)])
def test_limit_matches(limit, offset):
    """Limit with an offset across batches of 1000 rows."""
    got = _run(JP.Limit(child=SRC, limit=limit, offset=offset))
    assert len(got["ss_quantity"][0]) == max(0, min(limit, 9000 - offset))


def test_limit_over_filter_matches():
    plan = JP.Limit(child=JP.Filter(child=SRC, predicates=q96_predicates()),
                    limit=1234, offset=321)
    got = _run(plan, size=512)
    assert len(got["ss_quantity"][0]) == 1234

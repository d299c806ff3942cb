"""TPC-DS queries as foreign physical plans (counterpart of
auron_tpu/it/queries.py, for the queries the card runs from their
foreign plans: q01, q13a and q65w).

Each builder takes a `Catalog` (it/datagen.py) and returns the already
optimized physical plan Spark would hand the converter for that query,
built with the JAX package's plan idioms (scans with pushed filters,
broadcast joins on dimensions, the partial -> hash exchange -> final
aggregation pair, TakeOrderedAndProject on top), so that each equals
the JAX package's plan in JSON.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from auron_tpu_torch.frontend.foreign import (ForeignExpr, ForeignNode, falias,
                                              fcall, fcol, flit)
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.it.datagen import Catalog

I32 = DataType.int32()
I64 = DataType.int64()
F64 = DataType.float64()
STR = DataType.string()

QUERIES: Dict[str, Callable[[Catalog], ForeignNode]] = {}


def _q(name: str):
    def deco(fn):
        QUERIES[name] = fn
        return fn
    return deco


# ---------------------------------------------------------------------------
# plan-building helpers (the idioms Spark's planner emits)
# ---------------------------------------------------------------------------

def so(e: ForeignExpr, asc: bool = True,
       nulls_first: Optional[bool] = None) -> ForeignExpr:
    return ForeignExpr("SortOrder", children=(e,),
                       attrs={"asc": asc,
                              "nulls_first": asc if nulls_first is None
                              else nulls_first})


def agg(fn: str, child: Optional[ForeignExpr], dtype: DataType,
        distinct: bool = False) -> ForeignExpr:
    children = (child,) if child is not None else ()
    return ForeignExpr("AggregateExpression",
                       children=(fcall(fn, *children, dtype=dtype),),
                       attrs={"distinct": distinct})


def ffilter(child: ForeignNode, cond: ForeignExpr) -> ForeignNode:
    return ForeignNode("FilterExec", children=(child,), output=child.output,
                       attrs={"condition": cond})


def fproject(child: ForeignNode, exprs: Sequence[ForeignExpr],
             out: Schema) -> ForeignNode:
    return ForeignNode("ProjectExec", children=(child,), output=out,
                       attrs={"project_list": list(exprs)})


def bhj(probe: ForeignNode, build: ForeignNode, left_key: ForeignExpr,
        right_key: ForeignExpr, join_type: str = "Inner") -> ForeignNode:
    bx = ForeignNode("BroadcastExchangeExec", children=(build,),
                     output=build.output)
    out = probe.output.concat(build.output) \
        if join_type in ("Inner", "LeftOuter", "RightOuter", "FullOuter") \
        else probe.output
    return ForeignNode(
        "BroadcastHashJoinExec", children=(probe, bx),
        output=out,
        attrs={"left_keys": [left_key], "right_keys": [right_key],
               "join_type": join_type, "build_side": "right"})


def smj(left: ForeignNode, right: ForeignNode,
        left_keys: Sequence[ForeignExpr], right_keys: Sequence[ForeignExpr],
        join_type: str = "Inner", n_parts: int = 4,
        out: Optional[Schema] = None) -> ForeignNode:
    def exchange(child, keys):
        return ForeignNode(
            "ShuffleExchangeExec", children=(child,), output=child.output,
            attrs={"partitioning": {"mode": "hash",
                                    "num_partitions": n_parts,
                                    "expressions": list(keys)}})
    if out is None:
        out = left.output.concat(right.output) \
            if join_type in ("Inner", "LeftOuter", "RightOuter",
                             "FullOuter") else left.output
    return ForeignNode(
        "SortMergeJoinExec",
        children=(exchange(left, left_keys), exchange(right, right_keys)),
        output=out,
        attrs={"left_keys": list(left_keys),
               "right_keys": list(right_keys), "join_type": join_type})


def two_phase_agg(child: ForeignNode, grouping: Sequence[ForeignExpr],
                  group_fields: Sequence[Field],
                  aggs: Sequence[Tuple[str, ForeignExpr, Field]],
                  n_parts: int = 4) -> ForeignNode:
    """partial HashAggregate -> hash ShuffleExchange -> final HashAggregate
    (the shape of every TPC-DS group-by stage)."""
    agg_exprs = [a for _, a, _ in aggs]
    agg_names = [n for n, _, _ in aggs]
    state_fields = list(group_fields)
    for name, a, out_f in aggs:
        fn = a.children[0].name
        if fn == "Average":
            state_fields += [Field(f"{name}#sum", F64),
                             Field(f"{name}#count", I64)]
        elif fn in ("StddevSamp", "VarianceSamp"):
            state_fields += [Field(f"{name}#sum", F64),
                             Field(f"{name}#sumsq", F64),
                             Field(f"{name}#count", I64)]
        elif fn == "Count":
            state_fields.append(Field(f"{name}#count", I64))
        else:
            state_fields.append(Field(f"{name}#{fn.lower()}", out_f.dtype))
    partial = ForeignNode(
        "HashAggregateExec", children=(child,),
        output=Schema(tuple(state_fields)),
        attrs={"grouping": list(grouping), "aggs": agg_exprs,
               "agg_names": agg_names, "mode": "partial"})
    # the exchange consumes the PARTIAL agg's output, so it partitions by
    # the output attributes (alias names), not the pre-agg child columns
    part_spec = {"mode": "hash", "num_partitions": n_parts,
                 "expressions": [fcol(f.name, f.dtype)
                                 for f in group_fields]} if grouping else \
        {"mode": "single", "num_partitions": 1}
    exchange = ForeignNode(
        "ShuffleExchangeExec", children=(partial,), output=partial.output,
        attrs={"partitioning": part_spec})
    final_out = Schema(tuple(group_fields) + tuple(f for _, _, f in aggs))
    # like the exchange, the final agg sees the partial-state schema, so
    # its grouping references the output attributes
    final_grouping = [fcol(f.name, f.dtype) for f in group_fields]
    return ForeignNode(
        "HashAggregateExec", children=(exchange,), output=final_out,
        attrs={"grouping": final_grouping, "aggs": agg_exprs,
               "agg_names": agg_names, "mode": "final"})


def take_ordered(child: ForeignNode, orders: Sequence[ForeignExpr],
                 limit: int, project: Sequence[ForeignExpr],
                 out: Schema) -> ForeignNode:
    return ForeignNode(
        "TakeOrderedAndProjectExec", children=(child,), output=out,
        attrs={"sort_order": list(orders), "limit": limit,
               "project_list": list(project)})


def _dim_date(cat: Catalog, cond: ForeignExpr,
              cols: Sequence[str]) -> ForeignNode:
    scan = cat.scan("date_dim", cols, pushed_filters=[cond])
    return ffilter(scan, cond)


# ---------------------------------------------------------------------------
# the queries
# ---------------------------------------------------------------------------

@_q("q01")
def q01(cat: Catalog) -> ForeignNode:
    """TPC-DS q01: customers whose store returns exceed 1.2x the store
    average — aggregation over aggregation with a broadcast self-join."""
    def ctr() -> ForeignNode:
        sr = cat.scan("store_returns",
                      ["sr_customer_sk", "sr_store_sk", "sr_return_amt"])
        return two_phase_agg(
            sr,
            grouping=[fcol("sr_customer_sk", I64),
                      fcol("sr_store_sk", I64)],
            group_fields=[Field("sr_customer_sk", I64),
                          Field("sr_store_sk", I64)],
            aggs=[("ctr_total_return",
                   agg("Sum", fcol("sr_return_amt", F64), F64),
                   Field("ctr_total_return", F64))])

    # per-store threshold = avg(ctr_total_return) * 1.2 over the ctr table
    avg_side = two_phase_agg(
        ctr(),
        grouping=[fcol("sr_store_sk", I64)],
        group_fields=[Field("sr_store_sk", I64)],
        aggs=[("avg_return", agg("Average",
                                 fcol("ctr_total_return", F64), F64),
               Field("avg_return", F64))],
        n_parts=2)
    threshold = fproject(
        avg_side,
        [falias(fcol("sr_store_sk", I64), "avg_store_sk"),
         falias(fcall("Multiply", fcol("avg_return", F64), flit(1.2)),
                "threshold")],
        Schema((Field("avg_store_sk", I64), Field("threshold", F64))))
    joined = bhj(ctr(), threshold, fcol("sr_store_sk", I64),
                 fcol("avg_store_sk", I64))
    over = ffilter(joined, fcall(
        "GreaterThan", fcol("ctr_total_return", F64),
        fcol("threshold", F64)))
    cu = cat.scan("customer", ["c_customer_sk", "c_customer_id"])
    named = smj(over, cu, [fcol("sr_customer_sk", I64)],
                [fcol("c_customer_sk", I64)])
    return take_ordered(
        named, orders=[so(fcol("c_customer_id", STR)),
                       so(fcol("sr_store_sk", I64)),
                       so(fcol("ctr_total_return", F64), asc=False)],
        limit=100,
        project=[fcol("c_customer_id", STR)],
        out=Schema((Field("c_customer_id", STR),)))


@_q("q65w")
def q65w(cat: Catalog) -> ForeignNode:
    """q65/q67 family: top revenue items per store via a rank() window
    over aggregated revenue."""
    ss = cat.scan("store_sales",
                  ["ss_item_sk", "ss_store_sk", "ss_sales_price",
                   "ss_quantity"])
    grouped = two_phase_agg(
        ss,
        grouping=[fcol("ss_store_sk", I64), fcol("ss_item_sk", I64)],
        group_fields=[Field("ss_store_sk", I64), Field("ss_item_sk", I64)],
        aggs=[("revenue", agg("Sum", fcol("ss_sales_price", F64), F64),
               Field("revenue", F64))])
    # Spark partitions window input by the window partition key
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,), output=grouped.output,
        attrs={"partitioning": {"mode": "hash", "num_partitions": 4,
                                "expressions": [fcol("ss_store_sk", I64)]}})
    win_out = Schema((Field("ss_store_sk", I64), Field("ss_item_sk", I64),
                      Field("revenue", F64), Field("rk", I32)))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "rk", "fn": "rank", "args": [], "agg": None,
                    "dtype": I32}],
               "partition_spec": [fcol("ss_store_sk", I64)],
               "order_spec": [so(fcol("revenue", F64), asc=False),
                              so(fcol("ss_item_sk", I64))]})
    top = ffilter(win, fcall("LessThanOrEqual", fcol("rk", I32), flit(5)))
    return take_ordered(
        top,
        orders=[so(fcol("ss_store_sk", I64)), so(fcol("rk", I32)),
                so(fcol("ss_item_sk", I64))],
        limit=200,
        project=[fcol("ss_store_sk", I64), fcol("ss_item_sk", I64),
                 fcol("revenue", F64), fcol("rk", I32)],
        out=win_out)


@_q("q13a")
def q13a(cat: Catalog) -> ForeignNode:
    """q13 family: averages under an IN-list store-state predicate."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_store_sk", "ss_quantity",
                   "ss_sales_price", "ss_net_profit"])
    dd = _dim_date(cat, fcall("EqualTo", fcol("d_year", I32), flit(2001)),
                   ["d_date_sk", "d_year"])
    st = cat.scan("store", ["s_store_sk", "s_state"])
    st = ffilter(st, fcall("In", fcol("s_state", STR), flit("TN"),
                           flit("CA"), flit("TX"), flit("OH")))
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    grouped = two_phase_agg(
        j2, grouping=[fcol("s_state", STR)],
        group_fields=[Field("s_state", STR)],
        aggs=[("avg_q", agg("Average", fcall("Cast", fcol("ss_quantity",
                                                          I32), dtype=F64),
                            F64), Field("avg_q", F64)),
              ("avg_p", agg("Average", fcol("ss_sales_price", F64), F64),
               Field("avg_p", F64)),
              ("profit", agg("Sum", fcol("ss_net_profit", F64), F64),
               Field("profit", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("s_state", STR))], limit=100,
        project=[fcol("s_state", STR), fcol("avg_q", F64),
                 fcol("avg_p", F64), fcol("profit", F64)],
        out=Schema((Field("s_state", STR), Field("avg_q", F64),
                    Field("avg_p", F64), Field("profit", F64))))


def build(name: str, cat: Catalog) -> ForeignNode:
    return QUERIES[name](cat)


def names() -> List[str]:
    return list(QUERIES)

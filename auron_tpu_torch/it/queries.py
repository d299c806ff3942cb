"""The TPC-DS query corpus as foreign physical plans (counterpart of
auron_tpu/it/queries.py).

Each builder takes a `Catalog` (it/datagen.py) and returns the already
optimized physical plan Spark would hand the converter for that TPC-DS
query family: scans with pushed filters, broadcast joins on dimensions,
the partial -> hash exchange -> final aggregation pair,
TakeOrderedAndProject on top.  Every builder, helper and registration
is the JAX package's, in its order, so that each plan equals the JAX
package's in JSON and `names()` lists the queries in the same order
(the default run order of it/runner.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from auron_tpu_torch.frontend.foreign import (ForeignExpr, ForeignNode,
                                              falias, fcall, fcol, flit)
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
# the corpus
# ---------------------------------------------------------------------------

@_q("q03")
def q03(cat: Catalog) -> ForeignNode:
    """TPC-DS q03: brand revenue for manufacturer in November by year."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
    dd = _dim_date(cat, fcall("EqualTo", fcol("d_moy", I32), flit(11)),
                   ["d_date_sk", "d_year", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_brand", "i_manufact_id"])
    it = ffilter(it, fcall("LessThanOrEqual", fcol("i_manufact_id", I32),
                           flit(100)))
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2,
        grouping=[fcol("d_year", I32), fcol("i_brand", STR)],
        group_fields=[Field("d_year", I32), Field("i_brand", STR)],
        aggs=[("sum_agg", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("sum_agg", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("d_year", I32)),
                so(fcol("sum_agg", F64), asc=False),
                so(fcol("i_brand", STR))],
        limit=100,
        project=[fcol("d_year", I32), fcol("i_brand", STR),
                 fcol("sum_agg", F64)],
        out=Schema((Field("d_year", I32), Field("i_brand", STR),
                    Field("sum_agg", F64))))


@_q("q07")
def q07(cat: Catalog) -> ForeignNode:
    """TPC-DS q07 family: average quantities/prices per item under a
    promotion-channel predicate in one year."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_promo_sk",
                   "ss_quantity", "ss_sales_price"])
    dd = _dim_date(cat, fcall("EqualTo", fcol("d_year", I32), flit(2000)),
                   ["d_date_sk", "d_year"])
    pr = cat.scan("promotion",
                  ["p_promo_sk", "p_channel_email", "p_channel_event"])
    pr = ffilter(pr, fcall(
        "Or",
        fcall("EqualTo", fcol("p_channel_email", STR), flit("N")),
        fcall("EqualTo", fcol("p_channel_event", STR), flit("N"))))
    it = cat.scan("item", ["i_item_sk", "i_item_id"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, pr, fcol("ss_promo_sk", I64), fcol("p_promo_sk", I64))
    j3 = bhj(j2, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j3,
        grouping=[fcol("i_item_id", STR)],
        group_fields=[Field("i_item_id", STR)],
        aggs=[("agg1", agg("Average", fcall(
                   "Cast", fcol("ss_quantity", I32), dtype=F64), F64),
               Field("agg1", F64)),
              ("agg2", agg("Average", fcol("ss_sales_price", F64), F64),
               Field("agg2", F64)),
              ("cnt", agg("Count", fcol("ss_quantity", I32), I64),
               Field("cnt", I64))])
    return take_ordered(
        grouped, orders=[so(fcol("i_item_id", STR))], limit=100,
        project=[fcol("i_item_id", STR), fcol("agg1", F64),
                 fcol("agg2", F64), fcol("cnt", I64)],
        out=Schema((Field("i_item_id", STR), Field("agg1", F64),
                    Field("agg2", F64), Field("cnt", I64))))


@_q("q19")
def q19(cat: Catalog) -> ForeignNode:
    """TPC-DS q19 family: brand revenue by customer geography — the
    join-heavy shape (5-way star join)."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk",
                   "ss_store_sk", "ss_ext_sales_price"])
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("EqualTo", fcol("d_moy", I32), flit(11)),
              fcall("EqualTo", fcol("d_year", I32), flit(1999))),
        ["d_date_sk", "d_year", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_brand", "i_manager_id"])
    it = ffilter(it, fcall("LessThanOrEqual", fcol("i_manager_id", I32),
                           flit(10)))
    cu = cat.scan("customer", ["c_customer_sk", "c_current_addr_sk"])
    caddr = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    st = cat.scan("store", ["s_store_sk", "s_state"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    j3 = smj(j2, cu, [fcol("ss_customer_sk", I64)],
             [fcol("c_customer_sk", I64)])
    j4 = bhj(j3, caddr, fcol("c_current_addr_sk", I64),
             fcol("ca_address_sk", I64))
    j5 = bhj(j4, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    grouped = two_phase_agg(
        j5,
        grouping=[fcol("i_brand", STR), fcol("ca_state", STR)],
        group_fields=[Field("i_brand", STR), Field("ca_state", STR)],
        aggs=[("ext_price", agg("Sum", fcol("ss_ext_sales_price", F64),
                                F64),
               Field("ext_price", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("ext_price", F64), asc=False),
                so(fcol("i_brand", STR)), so(fcol("ca_state", STR))],
        limit=100,
        project=[fcol("i_brand", STR), fcol("ca_state", STR),
                 fcol("ext_price", F64)],
        out=Schema((Field("i_brand", STR), Field("ca_state", STR),
                    Field("ext_price", F64))))


@_q("q42")
def q42(cat: Catalog) -> ForeignNode:
    """TPC-DS q42: category revenue for one month/year."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("EqualTo", fcol("d_moy", I32), flit(12)),
              fcall("EqualTo", fcol("d_year", I32), flit(1998))),
        ["d_date_sk", "d_year", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_category"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2,
        grouping=[fcol("d_year", I32), fcol("i_category", STR)],
        group_fields=[Field("d_year", I32), Field("i_category", STR)],
        aggs=[("total", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("total", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("total", F64), asc=False),
                so(fcol("d_year", I32)), so(fcol("i_category", STR))],
        limit=100,
        project=[fcol("d_year", I32), fcol("i_category", STR),
                 fcol("total", F64)],
        out=Schema((Field("d_year", I32), Field("i_category", STR),
                    Field("total", F64))))


@_q("q55")
def q55(cat: Catalog) -> ForeignNode:
    """TPC-DS q55: brand revenue for one manager's items in a month."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("EqualTo", fcol("d_moy", I32), flit(11)),
              fcall("EqualTo", fcol("d_year", I32), flit(1999))),
        ["d_date_sk", "d_year", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_brand", "i_manager_id"])
    it = ffilter(it, fcall("LessThanOrEqual", fcol("i_manager_id", I32),
                           flit(20)))
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2,
        grouping=[fcol("i_brand", STR)],
        group_fields=[Field("i_brand", STR)],
        aggs=[("ext_price", agg("Sum", fcol("ss_ext_sales_price", F64),
                                F64),
               Field("ext_price", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("ext_price", F64), asc=False),
                so(fcol("i_brand", STR))],
        limit=100,
        project=[fcol("i_brand", STR), fcol("ext_price", F64)],
        out=Schema((Field("i_brand", STR), Field("ext_price", F64))))


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


@_q("q16a")
def q16a(cat: Catalog) -> ForeignNode:
    """q16 family: anti-join — sales whose ticket never came back, counted
    per store (LeftAnti on the returns table)."""
    ss = cat.scan("store_sales",
                  ["ss_ticket_number", "ss_item_sk", "ss_store_sk",
                   "ss_net_profit"])
    sr = cat.scan("store_returns", ["sr_ticket_number", "sr_item_sk"])
    anti = smj(ss, sr,
               [fcol("ss_ticket_number", I64), fcol("ss_item_sk", I64)],
               [fcol("sr_ticket_number", I64), fcol("sr_item_sk", I64)],
               join_type="LeftAnti")
    grouped = two_phase_agg(
        anti,
        grouping=[fcol("ss_store_sk", I64)],
        group_fields=[Field("ss_store_sk", I64)],
        aggs=[("kept", agg("Count", fcol("ss_ticket_number", I64), I64),
               Field("kept", I64)),
              ("profit", agg("Sum", fcol("ss_net_profit", F64), F64),
               Field("profit", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("ss_store_sk", I64))], limit=100,
        project=[fcol("ss_store_sk", I64), fcol("kept", I64),
                 fcol("profit", F64)],
        out=Schema((Field("ss_store_sk", I64), Field("kept", I64),
                    Field("profit", F64))))


@_q("q71u")
def q71u(cat: Catalog) -> ForeignNode:
    """q71 family: brand revenue unioned across the three sales channels."""
    def channel(table: str, date_col: str, item_col: str,
                price_col: str) -> ForeignNode:
        sc = cat.scan(table, [date_col, item_col, price_col])
        dd = _dim_date(cat, fcall("EqualTo", fcol("d_year", I32),
                                  flit(2001)),
                       ["d_date_sk", "d_year"])
        j = bhj(sc, dd, fcol(date_col, I64), fcol("d_date_sk", I64))
        return fproject(
            j, [falias(fcol(item_col, I64), "sold_item_sk"),
                falias(fcol(price_col, F64), "ext_price")],
            Schema((Field("sold_item_sk", I64), Field("ext_price", F64))))

    union_out = Schema((Field("sold_item_sk", I64),
                        Field("ext_price", F64)))
    un = ForeignNode(
        "UnionExec",
        children=(channel("web_sales", "ws_sold_date_sk", "ws_item_sk",
                          "ws_ext_sales_price"),
                  channel("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                          "cs_ext_sales_price"),
                  channel("store_sales", "ss_sold_date_sk", "ss_item_sk",
                          "ss_ext_sales_price")),
        output=union_out)
    it = cat.scan("item", ["i_item_sk", "i_brand", "i_manager_id"])
    it = ffilter(it, fcall("LessThanOrEqual", fcol("i_manager_id", I32),
                           flit(30)))
    j = bhj(un, it, fcol("sold_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j,
        grouping=[fcol("i_brand", STR)],
        group_fields=[Field("i_brand", STR)],
        aggs=[("ext_price", agg("Sum", fcol("ext_price", F64), F64),
               Field("ext_price", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("ext_price", F64), asc=False),
                so(fcol("i_brand", STR))],
        limit=100,
        project=[fcol("i_brand", STR), fcol("ext_price", F64)],
        out=Schema((Field("i_brand", STR), Field("ext_price", F64))))


@_q("q27r")
def q27r(cat: Catalog) -> ForeignNode:
    """q27/q18 family: rollup over (category, state) via ExpandExec
    (grouping sets) feeding the aggregate."""
    ss = cat.scan("store_sales",
                  ["ss_item_sk", "ss_store_sk", "ss_quantity"])
    it = cat.scan("item", ["i_item_sk", "i_category"])
    st = cat.scan("store", ["s_store_sk", "s_state"])
    j1 = bhj(ss, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    j2 = bhj(j1, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    pre = fproject(
        j2, [fcol("i_category", STR), fcol("s_state", STR),
             falias(fcall("Cast", fcol("ss_quantity", I32), dtype=F64),
                    "qty")],
        Schema((Field("i_category", STR), Field("s_state", STR),
                Field("qty", F64))))
    expand_out = Schema((Field("i_category", STR), Field("s_state", STR),
                         Field("qty", F64),
                         Field("spark_grouping_id", I64)))
    expand = ForeignNode(
        "ExpandExec", children=(pre,), output=expand_out,
        attrs={"projections": [
            [fcol("i_category", STR), fcol("s_state", STR),
             fcol("qty", F64), flit(0, I64)],
            [fcol("i_category", STR), flit(None, STR), fcol("qty", F64),
             flit(1, I64)],
            [flit(None, STR), flit(None, STR), fcol("qty", F64),
             flit(3, I64)],
        ]})
    grouped = two_phase_agg(
        expand,
        grouping=[fcol("i_category", STR), fcol("s_state", STR),
                  fcol("spark_grouping_id", I64)],
        group_fields=[Field("i_category", STR), Field("s_state", STR),
                      Field("spark_grouping_id", I64)],
        aggs=[("avg_qty", agg("Average", fcol("qty", F64), F64),
               Field("avg_qty", F64)),
              ("n", agg("Count", fcol("qty", F64), I64),
               Field("n", I64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("spark_grouping_id", I64)),
                so(fcol("i_category", STR), nulls_first=True),
                so(fcol("s_state", STR), nulls_first=True)],
        limit=200,
        project=[fcol("i_category", STR), fcol("s_state", STR),
                 fcol("spark_grouping_id", I64), fcol("avg_qty", F64),
                 fcol("n", I64)],
        out=Schema((Field("i_category", STR), Field("s_state", STR),
                    Field("spark_grouping_id", I64),
                    Field("avg_qty", F64), Field("n", I64))))


@_q("q68s")
def q68s(cat: Catalog) -> ForeignNode:
    """q68 family: per-customer basket totals through a shuffled hash join
    against the customer dim, with a HAVING-style filter on the agg."""
    ss = cat.scan("store_sales",
                  ["ss_customer_sk", "ss_ticket_number",
                   "ss_ext_sales_price"])
    grouped = two_phase_agg(
        ss,
        grouping=[fcol("ss_customer_sk", I64),
                  fcol("ss_ticket_number", I64)],
        group_fields=[Field("ss_customer_sk", I64),
                      Field("ss_ticket_number", I64)],
        aggs=[("basket", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("basket", F64))])
    big = ffilter(grouped, fcall("GreaterThan", fcol("basket", F64),
                                 flit(100.0)))
    cu = cat.scan("customer", ["c_customer_sk", "c_customer_id"])
    named = smj(big, cu, [fcol("ss_customer_sk", I64)],
                [fcol("c_customer_sk", I64)])
    return take_ordered(
        named,
        orders=[so(fcol("c_customer_id", STR)),
                so(fcol("ss_ticket_number", I64))],
        limit=100,
        project=[fcol("c_customer_id", STR),
                 fcol("ss_ticket_number", I64), fcol("basket", F64)],
        out=Schema((Field("c_customer_id", STR),
                    Field("ss_ticket_number", I64),
                    Field("basket", F64))))


def build(name: str, cat: Catalog) -> ForeignNode:
    return QUERIES[name](cat)


def names() -> List[str]:
    return list(QUERIES)


@_q("q52")
def q52(cat: Catalog) -> ForeignNode:
    """TPC-DS q52: brand revenue for one month/year (q03's sibling with a
    different sort: year asc, revenue desc)."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("EqualTo", fcol("d_moy", I32), flit(11)),
              fcall("EqualTo", fcol("d_year", I32), flit(2000))),
        ["d_date_sk", "d_year", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_brand", "i_manager_id"])
    it = ffilter(it, fcall("LessThanOrEqual", fcol("i_manager_id", I32),
                           flit(40)))
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2,
        grouping=[fcol("d_year", I32), fcol("i_brand", STR)],
        group_fields=[Field("d_year", I32), Field("i_brand", STR)],
        aggs=[("ext_price", agg("Sum", fcol("ss_ext_sales_price", F64),
                                F64),
               Field("ext_price", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("d_year", I32)),
                so(fcol("ext_price", F64), asc=False),
                so(fcol("i_brand", STR))],
        limit=100,
        project=[fcol("d_year", I32), fcol("i_brand", STR),
                 fcol("ext_price", F64)],
        out=Schema((Field("d_year", I32), Field("i_brand", STR),
                    Field("ext_price", F64))))


@_q("q43")
def q43(cat: Catalog) -> ForeignNode:
    """TPC-DS q43: store sales totals by store and day-of-week."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_store_sk", "ss_sales_price"])
    dd = _dim_date(cat, fcall("EqualTo", fcol("d_year", I32), flit(2001)),
                   ["d_date_sk", "d_year", "d_day_name"])
    st = cat.scan("store", ["s_store_sk", "s_store_id", "s_store_name"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    grouped = two_phase_agg(
        j2,
        grouping=[fcol("s_store_name", STR), fcol("s_store_id", STR),
                  fcol("d_day_name", STR)],
        group_fields=[Field("s_store_name", STR),
                      Field("s_store_id", STR),
                      Field("d_day_name", STR)],
        aggs=[("sales", agg("Sum", fcol("ss_sales_price", F64), F64),
               Field("sales", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("s_store_name", STR)),
                so(fcol("s_store_id", STR)),
                so(fcol("d_day_name", STR))],
        limit=100,
        project=[fcol("s_store_name", STR), fcol("s_store_id", STR),
                 fcol("d_day_name", STR), fcol("sales", F64)],
        out=Schema((Field("s_store_name", STR), Field("s_store_id", STR),
                    Field("d_day_name", STR), Field("sales", F64))))


@_q("q96")
def q96(cat: Catalog) -> ForeignNode:
    """TPC-DS q96: global count of qualifying store sales (grouping-free
    two-phase count through a single-partition exchange)."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_quantity", "ss_sales_price"])
    filt = ffilter(ss, fcall(
        "And",
        fcall("GreaterThanOrEqual", fcol("ss_quantity", I32), flit(20)),
        fcall("LessThan", fcol("ss_sales_price", F64), flit(120.0))))
    grouped = two_phase_agg(
        filt, grouping=[], group_fields=[],
        aggs=[("cnt", agg("Count", fcol("ss_quantity", I32), I64),
               Field("cnt", I64))])
    return ForeignNode("GlobalLimitExec", children=(grouped,),
                       output=grouped.output, attrs={"limit": 100})


@_q("q98")
def q98(cat: Catalog) -> ForeignNode:
    """TPC-DS q98: item revenue with each item's share of its class's
    total — agg feeding a sum-over-window partitioned by class."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
    dd = _dim_date(cat, fcall("EqualTo", fcol("d_year", I32), flit(1999)),
                   ["d_date_sk", "d_year"])
    it = cat.scan("item", ["i_item_sk", "i_item_id", "i_class",
                           "i_category"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2,
        grouping=[fcol("i_item_id", STR), fcol("i_class", STR),
                  fcol("i_category", STR)],
        group_fields=[Field("i_item_id", STR), Field("i_class", STR),
                      Field("i_category", STR)],
        aggs=[("itemrevenue", agg("Sum", fcol("ss_ext_sales_price", F64),
                                  F64),
               Field("itemrevenue", F64))])
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,), output=grouped.output,
        attrs={"partitioning": {"mode": "hash", "num_partitions": 4,
                                "expressions": [fcol("i_class", STR)]}})
    win_out = Schema((Field("i_item_id", STR), Field("i_class", STR),
                      Field("i_category", STR),
                      Field("itemrevenue", F64),
                      Field("class_total", F64)))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "class_total", "fn": "agg", "args": [],
                    "agg": agg("Sum", fcol("itemrevenue", F64), F64)}],
               "partition_spec": [fcol("i_class", STR)],
               "order_spec": []})
    ratio = fproject(
        win,
        [fcol("i_item_id", STR), fcol("i_class", STR),
         fcol("i_category", STR), fcol("itemrevenue", F64),
         falias(fcall("Multiply",
                      fcall("Divide", fcol("itemrevenue", F64),
                            fcol("class_total", F64)),
                      flit(100.0)), "revenueratio")],
        Schema((Field("i_item_id", STR), Field("i_class", STR),
                Field("i_category", STR), Field("itemrevenue", F64),
                Field("revenueratio", F64))))
    return take_ordered(
        ratio,
        orders=[so(fcol("i_category", STR)), so(fcol("i_class", STR)),
                so(fcol("i_item_id", STR)),
                so(fcol("revenueratio", F64))],
        limit=100,
        project=[fcol("i_item_id", STR), fcol("i_class", STR),
                 fcol("i_category", STR), fcol("itemrevenue", F64),
                 fcol("revenueratio", F64)],
        out=ratio.output)


@_q("q15")
def q15(cat: Catalog) -> ForeignNode:
    """TPC-DS q15: catalog sales revenue by customer state via two
    sort-merge joins (cs -> customer -> address) and a date broadcast."""
    cs = cat.scan("catalog_sales",
                  ["cs_sold_date_sk", "cs_bill_customer_sk",
                   "cs_ext_sales_price"])
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("EqualTo", fcol("d_qoy", I32), flit(1)),
              fcall("EqualTo", fcol("d_year", I32), flit(2001))),
        ["d_date_sk", "d_year", "d_qoy"])
    cu = cat.scan("customer", ["c_customer_sk", "c_current_addr_sk"])
    caddr = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    j1 = bhj(cs, dd, fcol("cs_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = smj(j1, cu, [fcol("cs_bill_customer_sk", I64)],
             [fcol("c_customer_sk", I64)])
    j3 = smj(j2, caddr, [fcol("c_current_addr_sk", I64)],
             [fcol("ca_address_sk", I64)])
    grouped = two_phase_agg(
        j3,
        grouping=[fcol("ca_state", STR)],
        group_fields=[Field("ca_state", STR)],
        aggs=[("total", agg("Sum", fcol("cs_ext_sales_price", F64), F64),
               Field("total", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("ca_state", STR))], limit=100,
        project=[fcol("ca_state", STR), fcol("total", F64)],
        out=Schema((Field("ca_state", STR), Field("total", F64))))


# ---------------------------------------------------------------------------
# grouping sets and rollups, windows, semi/anti/outer joins, unions, CASE
# WHEN and IN expression shapes
# ---------------------------------------------------------------------------

@_q("q06a")
def q06a(cat: Catalog) -> ForeignNode:
    """q06 family: customer count per address state for store shoppers."""
    ss = cat.scan("store_sales", ["ss_customer_sk", "ss_ext_sales_price"])
    cu = cat.scan("customer", ["c_customer_sk", "c_current_addr_sk"])
    caddr = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    j1 = smj(ss, cu, [fcol("ss_customer_sk", I64)],
             [fcol("c_customer_sk", I64)])
    j2 = bhj(j1, caddr, fcol("c_current_addr_sk", I64),
             fcol("ca_address_sk", I64))
    grouped = two_phase_agg(
        j2,
        grouping=[fcol("ca_state", STR)],
        group_fields=[Field("ca_state", STR)],
        aggs=[("cnt", agg("Count", fcol("ss_customer_sk", I64), I64),
               Field("cnt", I64)),
              ("rev", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("rev", F64))])
    big = ffilter(grouped, fcall("GreaterThanOrEqual", fcol("cnt", I64),
                                 flit(10)))
    return take_ordered(
        big, orders=[so(fcol("cnt", I64), asc=False),
                     so(fcol("ca_state", STR))], limit=100,
        project=[fcol("ca_state", STR), fcol("cnt", I64),
                 fcol("rev", F64)],
        out=Schema((Field("ca_state", STR), Field("cnt", I64),
                    Field("rev", F64))))


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


@_q("q17m")
def q17m(cat: Catalog) -> ForeignNode:
    """q17 family: sold-then-returned tickets, quantity stats by store."""
    ss = cat.scan("store_sales",
                  ["ss_ticket_number", "ss_item_sk", "ss_store_sk",
                   "ss_quantity"])
    sr = cat.scan("store_returns",
                  ["sr_ticket_number", "sr_item_sk", "sr_return_amt"])
    j = smj(ss, sr,
            [fcol("ss_ticket_number", I64), fcol("ss_item_sk", I64)],
            [fcol("sr_ticket_number", I64), fcol("sr_item_sk", I64)])
    grouped = two_phase_agg(
        j, grouping=[fcol("ss_store_sk", I64)],
        group_fields=[Field("ss_store_sk", I64)],
        aggs=[("min_q", agg("Min", fcol("ss_quantity", I32), I32),
               Field("min_q", I32)),
              ("max_q", agg("Max", fcol("ss_quantity", I32), I32),
               Field("max_q", I32)),
              ("avg_r", agg("Average", fcol("sr_return_amt", F64), F64),
               Field("avg_r", F64)),
              ("n", agg("Count", fcol("ss_ticket_number", I64), I64),
               Field("n", I64))])
    return take_ordered(
        grouped, orders=[so(fcol("ss_store_sk", I64))], limit=100,
        project=[fcol("ss_store_sk", I64), fcol("min_q", I32),
                 fcol("max_q", I32), fcol("avg_r", F64), fcol("n", I64)],
        out=Schema((Field("ss_store_sk", I64), Field("min_q", I32),
                    Field("max_q", I32), Field("avg_r", F64),
                    Field("n", I64))))


@_q("q22r")
def q22r(cat: Catalog) -> ForeignNode:
    """q22 family: rollup (category, brand) average quantity on catalog
    sales (ExpandExec grouping sets)."""
    cs = cat.scan("catalog_sales", ["cs_item_sk", "cs_quantity"])
    it = cat.scan("item", ["i_item_sk", "i_category", "i_brand"])
    j = bhj(cs, it, fcol("cs_item_sk", I64), fcol("i_item_sk", I64))
    pre = fproject(
        j, [fcol("i_category", STR), fcol("i_brand", STR),
            falias(fcall("Cast", fcol("cs_quantity", I32), dtype=F64),
                   "qty")],
        Schema((Field("i_category", STR), Field("i_brand", STR),
                Field("qty", F64))))
    expand_out = Schema((Field("i_category", STR), Field("i_brand", STR),
                         Field("qty", F64),
                         Field("spark_grouping_id", I64)))
    expand = ForeignNode(
        "ExpandExec", children=(pre,), output=expand_out,
        attrs={"projections": [
            [fcol("i_category", STR), fcol("i_brand", STR),
             fcol("qty", F64), flit(0, I64)],
            [fcol("i_category", STR), flit(None, STR), fcol("qty", F64),
             flit(1, I64)],
            [flit(None, STR), flit(None, STR), fcol("qty", F64),
             flit(3, I64)]]})
    grouped = two_phase_agg(
        expand,
        grouping=[fcol("i_category", STR), fcol("i_brand", STR),
                  fcol("spark_grouping_id", I64)],
        group_fields=[Field("i_category", STR), Field("i_brand", STR),
                      Field("spark_grouping_id", I64)],
        aggs=[("avg_q", agg("Average", fcol("qty", F64), F64),
               Field("avg_q", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("avg_q", F64), asc=False),
                so(fcol("i_category", STR)), so(fcol("i_brand", STR)),
                so(fcol("spark_grouping_id", I64))],
        limit=100,
        project=[fcol("i_category", STR), fcol("i_brand", STR),
                 fcol("spark_grouping_id", I64), fcol("avg_q", F64)],
        out=Schema((Field("i_category", STR), Field("i_brand", STR),
                    Field("spark_grouping_id", I64),
                    Field("avg_q", F64))))


@_q("q25m")
def q25m(cat: Catalog) -> ForeignNode:
    """q25 family: sold, returned, then re-bought through the catalog —
    three-fact join with profit sums per store."""
    ss = cat.scan("store_sales",
                  ["ss_ticket_number", "ss_item_sk", "ss_customer_sk",
                   "ss_store_sk", "ss_net_profit"])
    sr = cat.scan("store_returns",
                  ["sr_ticket_number", "sr_item_sk", "sr_customer_sk",
                   "sr_return_amt"])
    cs = cat.scan("catalog_sales",
                  ["cs_bill_customer_sk", "cs_item_sk", "cs_net_profit"])
    j1 = smj(ss, sr,
             [fcol("ss_ticket_number", I64), fcol("ss_item_sk", I64)],
             [fcol("sr_ticket_number", I64), fcol("sr_item_sk", I64)])
    j2 = smj(j1, cs,
             [fcol("sr_customer_sk", I64), fcol("sr_item_sk", I64)],
             [fcol("cs_bill_customer_sk", I64), fcol("cs_item_sk", I64)])
    grouped = two_phase_agg(
        j2, grouping=[fcol("ss_store_sk", I64)],
        group_fields=[Field("ss_store_sk", I64)],
        aggs=[("store_profit", agg("Sum", fcol("ss_net_profit", F64),
                                   F64), Field("store_profit", F64)),
              ("returns_amt", agg("Sum", fcol("sr_return_amt", F64), F64),
               Field("returns_amt", F64)),
              ("catalog_profit", agg("Sum", fcol("cs_net_profit", F64),
                                     F64), Field("catalog_profit", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("ss_store_sk", I64))], limit=100,
        project=[fcol("ss_store_sk", I64), fcol("store_profit", F64),
                 fcol("returns_amt", F64), fcol("catalog_profit", F64)],
        out=Schema((Field("ss_store_sk", I64),
                    Field("store_profit", F64),
                    Field("returns_amt", F64),
                    Field("catalog_profit", F64))))


@_q("q26a")
def q26a(cat: Catalog) -> ForeignNode:
    """q26: catalog mirror of q07 (promotion-channel averages)."""
    cs = cat.scan("catalog_sales",
                  ["cs_sold_date_sk", "cs_item_sk", "cs_quantity",
                   "cs_sales_price"])
    dd = _dim_date(cat, fcall("EqualTo", fcol("d_year", I32), flit(2000)),
                   ["d_date_sk", "d_year"])
    it = cat.scan("item", ["i_item_sk", "i_item_id"])
    j1 = bhj(cs, dd, fcol("cs_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("cs_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2, grouping=[fcol("i_item_id", STR)],
        group_fields=[Field("i_item_id", STR)],
        aggs=[("agg1", agg("Average", fcall("Cast", fcol("cs_quantity",
                                                         I32), dtype=F64),
                           F64), Field("agg1", F64)),
              ("agg2", agg("Average", fcol("cs_sales_price", F64), F64),
               Field("agg2", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("i_item_id", STR))], limit=100,
        project=[fcol("i_item_id", STR), fcol("agg1", F64),
                 fcol("agg2", F64)],
        out=Schema((Field("i_item_id", STR), Field("agg1", F64),
                    Field("agg2", F64))))


@_q("q29m")
def q29m(cat: Catalog) -> ForeignNode:
    """q29 family: quantity extremes for sold+returned items by item id."""
    ss = cat.scan("store_sales",
                  ["ss_ticket_number", "ss_item_sk", "ss_quantity"])
    sr = cat.scan("store_returns",
                  ["sr_ticket_number", "sr_item_sk", "sr_return_amt"])
    it = cat.scan("item", ["i_item_sk", "i_item_id"])
    j1 = smj(ss, sr,
             [fcol("ss_ticket_number", I64), fcol("ss_item_sk", I64)],
             [fcol("sr_ticket_number", I64), fcol("sr_item_sk", I64)])
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2, grouping=[fcol("i_item_id", STR)],
        group_fields=[Field("i_item_id", STR)],
        aggs=[("min_q", agg("Min", fcol("ss_quantity", I32), I32),
               Field("min_q", I32)),
              ("max_r", agg("Max", fcol("sr_return_amt", F64), F64),
               Field("max_r", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("i_item_id", STR))], limit=100,
        project=[fcol("i_item_id", STR), fcol("min_q", I32),
                 fcol("max_r", F64)],
        out=Schema((Field("i_item_id", STR), Field("min_q", I32),
                    Field("max_r", F64))))


@_q("q33b")
def q33b(cat: Catalog) -> ForeignNode:
    """q33 family: manufacturer revenue across all three channels
    (union) in one month."""
    def channel(table, date_col, item_col, price_col):
        sc = cat.scan(table, [date_col, item_col, price_col])
        dd = _dim_date(
            cat,
            fcall("And", fcall("EqualTo", fcol("d_year", I32), flit(1999)),
                  fcall("EqualTo", fcol("d_moy", I32), flit(3))),
            ["d_date_sk", "d_year", "d_moy"])
        j = bhj(sc, dd, fcol(date_col, I64), fcol("d_date_sk", I64))
        it = cat.scan("item", ["i_item_sk", "i_manufact_id"])
        j2 = bhj(j, it, fcol(item_col, I64), fcol("i_item_sk", I64))
        return fproject(
            j2, [fcol("i_manufact_id", I32),
                 falias(fcol(price_col, F64), "ext_price")],
            Schema((Field("i_manufact_id", I32),
                    Field("ext_price", F64))))
    un = ForeignNode(
        "UnionExec",
        children=(channel("store_sales", "ss_sold_date_sk", "ss_item_sk",
                          "ss_ext_sales_price"),
                  channel("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                          "cs_ext_sales_price"),
                  channel("web_sales", "ws_sold_date_sk", "ws_item_sk",
                          "ws_ext_sales_price")),
        output=Schema((Field("i_manufact_id", I32),
                       Field("ext_price", F64))))
    grouped = two_phase_agg(
        un, grouping=[fcol("i_manufact_id", I32)],
        group_fields=[Field("i_manufact_id", I32)],
        aggs=[("total", agg("Sum", fcol("ext_price", F64), F64),
               Field("total", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("total", F64), asc=False),
                         so(fcol("i_manufact_id", I32))], limit=100,
        project=[fcol("i_manufact_id", I32), fcol("total", F64)],
        out=Schema((Field("i_manufact_id", I32), Field("total", F64))))


@_q("q34c")
def q34c(cat: Catalog) -> ForeignNode:
    """q34 family: busy baskets (5..20 items) early in the month, named
    customers."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_customer_sk",
                   "ss_ticket_number"])
    dd = _dim_date(cat, fcall("LessThanOrEqual", fcol("d_dom", I32),
                              flit(10)),
                   ["d_date_sk", "d_dom"])
    j = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    grouped = two_phase_agg(
        j,
        grouping=[fcol("ss_customer_sk", I64)],
        group_fields=[Field("ss_customer_sk", I64)],
        aggs=[("cnt", agg("Count", fcol("ss_ticket_number", I64), I64),
               Field("cnt", I64))])
    sized = ffilter(
        grouped,
        fcall("And",
              fcall("GreaterThanOrEqual", fcol("cnt", I64), flit(2)),
              fcall("LessThanOrEqual", fcol("cnt", I64), flit(50))))
    cu = cat.scan("customer", ["c_customer_sk", "c_customer_id"])
    named = smj(sized, cu, [fcol("ss_customer_sk", I64)],
                [fcol("c_customer_sk", I64)])
    return take_ordered(
        named,
        orders=[so(fcol("cnt", I64), asc=False),
                so(fcol("c_customer_id", STR))],
        limit=100,
        project=[fcol("c_customer_id", STR), fcol("cnt", I64)],
        out=Schema((Field("c_customer_id", STR), Field("cnt", I64))))


@_q("q38i")
def q38i(cat: Catalog) -> ForeignNode:
    """q38 family: customers active in ALL three channels (semi-join
    intersection), counted."""
    ss = cat.scan("store_sales", ["ss_customer_sk"])
    cs = cat.scan("catalog_sales", ["cs_bill_customer_sk"])
    ws = cat.scan("web_sales", ["ws_bill_customer_sk"])
    in_cs = smj(ss, cs, [fcol("ss_customer_sk", I64)],
                [fcol("cs_bill_customer_sk", I64)], join_type="LeftSemi")
    in_all = smj(in_cs, ws, [fcol("ss_customer_sk", I64)],
                 [fcol("ws_bill_customer_sk", I64)], join_type="LeftSemi")
    dedup = two_phase_agg(
        in_all, grouping=[fcol("ss_customer_sk", I64)],
        group_fields=[Field("ss_customer_sk", I64)], aggs=[])
    return two_phase_agg(
        dedup, grouping=[],
        group_fields=[],
        aggs=[("n", agg("Count", fcol("ss_customer_sk", I64), I64),
               Field("n", I64))])


@_q("q45s")
def q45s(cat: Catalog) -> ForeignNode:
    """q45 family: web revenue by customer address state (IN-list)."""
    ws = cat.scan("web_sales",
                  ["ws_bill_customer_sk", "ws_ext_sales_price"])
    cu = cat.scan("customer", ["c_customer_sk", "c_current_addr_sk"])
    caddr = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    caddr = ffilter(caddr, fcall("In", fcol("ca_state", STR), flit("CA"),
                                 flit("TX"), flit("NY"), flit("FL"),
                                 flit("WA")))
    j1 = smj(ws, cu, [fcol("ws_bill_customer_sk", I64)],
             [fcol("c_customer_sk", I64)])
    j2 = bhj(j1, caddr, fcol("c_current_addr_sk", I64),
             fcol("ca_address_sk", I64))
    grouped = two_phase_agg(
        j2, grouping=[fcol("ca_state", STR)],
        group_fields=[Field("ca_state", STR)],
        aggs=[("rev", agg("Sum", fcol("ws_ext_sales_price", F64), F64),
               Field("rev", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("ca_state", STR))], limit=100,
        project=[fcol("ca_state", STR), fcol("rev", F64)],
        out=Schema((Field("ca_state", STR), Field("rev", F64))))


@_q("q47w")
def q47w(cat: Catalog) -> ForeignNode:
    """q47 family: top revenue months per brand via rank() over monthly
    sums (window-heavy)."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_sales_price"])
    dd = cat.scan("date_dim", ["d_date_sk", "d_year", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_brand"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2,
        grouping=[fcol("i_brand", STR), fcol("d_year", I32),
                  fcol("d_moy", I32)],
        group_fields=[Field("i_brand", STR), Field("d_year", I32),
                      Field("d_moy", I32)],
        aggs=[("sum_sales", agg("Sum", fcol("ss_sales_price", F64), F64),
               Field("sum_sales", F64))])
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,), output=grouped.output,
        attrs={"partitioning": {"mode": "hash", "num_partitions": 4,
                                "expressions": [fcol("i_brand", STR)]}})
    win_out = Schema((Field("i_brand", STR), Field("d_year", I32),
                      Field("d_moy", I32), Field("sum_sales", F64),
                      Field("rk", I32)))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "rk", "fn": "rank", "args": [], "agg": None,
                    "dtype": I32}],
               "partition_spec": [fcol("i_brand", STR)],
               "order_spec": [so(fcol("sum_sales", F64), asc=False),
                              so(fcol("d_year", I32)),
                              so(fcol("d_moy", I32))]})
    top = ffilter(win, fcall("LessThanOrEqual", fcol("rk", I32), flit(3)))
    return take_ordered(
        top,
        orders=[so(fcol("i_brand", STR)), so(fcol("rk", I32))],
        limit=200,
        project=[fcol("i_brand", STR), fcol("d_year", I32),
                 fcol("d_moy", I32), fcol("sum_sales", F64),
                 fcol("rk", I32)],
        out=win_out)


@_q("q48a")
def q48a(cat: Catalog) -> ForeignNode:
    """q48 family: CASE-bucketed revenue by store state (conditional
    aggregation)."""
    ss = cat.scan("store_sales",
                  ["ss_store_sk", "ss_quantity", "ss_sales_price"])
    st = cat.scan("store", ["s_store_sk", "s_state"])
    j = bhj(ss, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    bucketed = fproject(
        j, [fcol("s_state", STR),
            falias(fcall("CaseWhen",
                         fcall("LessThan", fcol("ss_quantity", I32),
                               flit(25)),
                         fcol("ss_sales_price", F64),
                         flit(0.0, F64), dtype=F64),
                   "low_rev"),
            falias(fcall("CaseWhen",
                         fcall("GreaterThanOrEqual",
                               fcol("ss_quantity", I32), flit(75)),
                         fcol("ss_sales_price", F64),
                         flit(0.0, F64), dtype=F64),
                   "high_rev")],
        Schema((Field("s_state", STR), Field("low_rev", F64),
                Field("high_rev", F64))))
    grouped = two_phase_agg(
        bucketed, grouping=[fcol("s_state", STR)],
        group_fields=[Field("s_state", STR)],
        aggs=[("low", agg("Sum", fcol("low_rev", F64), F64),
               Field("low", F64)),
              ("high", agg("Sum", fcol("high_rev", F64), F64),
               Field("high", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("s_state", STR))], limit=100,
        project=[fcol("s_state", STR), fcol("low", F64),
                 fcol("high", F64)],
        out=Schema((Field("s_state", STR), Field("low", F64),
                    Field("high", F64))))


@_q("q50c")
def q50c(cat: Catalog) -> ForeignNode:
    """q50 family: days-to-return latency stats per store (date
    arithmetic on join output)."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_ticket_number", "ss_item_sk",
                   "ss_store_sk"])
    sr = cat.scan("store_returns",
                  ["sr_returned_date_sk", "sr_ticket_number",
                   "sr_item_sk"])
    j = smj(ss, sr,
            [fcol("ss_ticket_number", I64), fcol("ss_item_sk", I64)],
            [fcol("sr_ticket_number", I64), fcol("sr_item_sk", I64)])
    lat = fproject(
        j, [fcol("ss_store_sk", I64),
            falias(fcall("Subtract", fcol("sr_returned_date_sk", I64),
                         fcol("ss_sold_date_sk", I64), dtype=I64),
                   "lag_days")],
        Schema((Field("ss_store_sk", I64), Field("lag_days", I64))))
    grouped = two_phase_agg(
        lat, grouping=[fcol("ss_store_sk", I64)],
        group_fields=[Field("ss_store_sk", I64)],
        aggs=[("n", agg("Count", fcol("lag_days", I64), I64),
               Field("n", I64)),
              ("avg_lag", agg("Average", fcall("Cast",
                                               fcol("lag_days", I64),
                                               dtype=F64), F64),
               Field("avg_lag", F64)),
              ("max_lag", agg("Max", fcol("lag_days", I64), I64),
               Field("max_lag", I64))])
    return take_ordered(
        grouped, orders=[so(fcol("ss_store_sk", I64))], limit=100,
        project=[fcol("ss_store_sk", I64), fcol("n", I64),
                 fcol("avg_lag", F64), fcol("max_lag", I64)],
        out=Schema((Field("ss_store_sk", I64), Field("n", I64),
                    Field("avg_lag", F64), Field("max_lag", I64))))


@_q("q51w")
def q51w(cat: Catalog) -> ForeignNode:
    """q51 family: monthly revenue share of each item's total (window
    whole-partition sum + divide)."""
    ws = cat.scan("web_sales",
                  ["ws_sold_date_sk", "ws_item_sk", "ws_sales_price"])
    dd = cat.scan("date_dim", ["d_date_sk", "d_moy"])
    j = bhj(ws, dd, fcol("ws_sold_date_sk", I64), fcol("d_date_sk", I64))
    monthly = two_phase_agg(
        j, grouping=[fcol("ws_item_sk", I64), fcol("d_moy", I32)],
        group_fields=[Field("ws_item_sk", I64), Field("d_moy", I32)],
        aggs=[("rev", agg("Sum", fcol("ws_sales_price", F64), F64),
               Field("rev", F64))])
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(monthly,), output=monthly.output,
        attrs={"partitioning": {"mode": "hash", "num_partitions": 4,
                                "expressions": [fcol("ws_item_sk", I64)]}})
    win_out = Schema((Field("ws_item_sk", I64), Field("d_moy", I32),
                      Field("rev", F64), Field("total", F64)))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "total", "fn": "agg",
                    "args": [],
                    "agg": agg("Sum", fcol("rev", F64), F64),
                    "dtype": F64}],
               "partition_spec": [fcol("ws_item_sk", I64)],
               "order_spec": []})
    share = fproject(
        win, [fcol("ws_item_sk", I64), fcol("d_moy", I32),
              fcol("rev", F64),
              falias(fcall("Divide", fcol("rev", F64),
                           fcol("total", F64), dtype=F64), "share")],
        Schema((Field("ws_item_sk", I64), Field("d_moy", I32),
                Field("rev", F64), Field("share", F64))))
    return take_ordered(
        share,
        orders=[so(fcol("share", F64), asc=False),
                so(fcol("ws_item_sk", I64)), so(fcol("d_moy", I32))],
        limit=100,
        project=[fcol("ws_item_sk", I64), fcol("d_moy", I32),
                 fcol("rev", F64), fcol("share", F64)],
        out=Schema((Field("ws_item_sk", I64), Field("d_moy", I32),
                    Field("rev", F64), Field("share", F64))))


@_q("q57w")
def q57w(cat: Catalog) -> ForeignNode:
    """q57 family: catalog channel's top months per brand (rank window
    over two-key partition)."""
    cs = cat.scan("catalog_sales",
                  ["cs_sold_date_sk", "cs_item_sk", "cs_sales_price"])
    dd = cat.scan("date_dim", ["d_date_sk", "d_year", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_brand"])
    j1 = bhj(cs, dd, fcol("cs_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("cs_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2,
        grouping=[fcol("i_brand", STR), fcol("d_year", I32),
                  fcol("d_moy", I32)],
        group_fields=[Field("i_brand", STR), Field("d_year", I32),
                      Field("d_moy", I32)],
        aggs=[("sum_sales", agg("Sum", fcol("cs_sales_price", F64), F64),
               Field("sum_sales", F64))])
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,), output=grouped.output,
        attrs={"partitioning": {"mode": "hash", "num_partitions": 4,
                                "expressions": [fcol("i_brand", STR),
                                                fcol("d_year", I32)]}})
    win_out = Schema((Field("i_brand", STR), Field("d_year", I32),
                      Field("d_moy", I32), Field("sum_sales", F64),
                      Field("rn", I32)))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "rn", "fn": "row_number", "args": [],
                    "agg": None, "dtype": I32}],
               "partition_spec": [fcol("i_brand", STR),
                                  fcol("d_year", I32)],
               "order_spec": [so(fcol("sum_sales", F64), asc=False),
                              so(fcol("d_moy", I32))]})
    top = ffilter(win, fcall("EqualTo", fcol("rn", I32), flit(1)))
    return take_ordered(
        top,
        orders=[so(fcol("i_brand", STR)), so(fcol("d_year", I32))],
        limit=200,
        project=[fcol("i_brand", STR), fcol("d_year", I32),
                 fcol("d_moy", I32), fcol("sum_sales", F64)],
        out=Schema((Field("i_brand", STR), Field("d_year", I32),
                    Field("d_moy", I32), Field("sum_sales", F64))))


@_q("q60b")
def q60b(cat: Catalog) -> ForeignNode:
    """q60 family: category-filtered item revenue across channels."""
    def channel(table, item_col, price_col):
        sc = cat.scan(table, [item_col, price_col])
        it = cat.scan("item", ["i_item_sk", "i_item_id", "i_category"])
        it = ffilter(it, fcall("In", fcol("i_category", STR),
                               flit("Music"), flit("Books"),
                               flit("Sports")))
        j = bhj(sc, it, fcol(item_col, I64), fcol("i_item_sk", I64))
        return fproject(
            j, [fcol("i_item_id", STR),
                falias(fcol(price_col, F64), "ext_price")],
            Schema((Field("i_item_id", STR), Field("ext_price", F64))))
    un = ForeignNode(
        "UnionExec",
        children=(channel("store_sales", "ss_item_sk",
                          "ss_ext_sales_price"),
                  channel("catalog_sales", "cs_item_sk",
                          "cs_ext_sales_price"),
                  channel("web_sales", "ws_item_sk",
                          "ws_ext_sales_price")),
        output=Schema((Field("i_item_id", STR), Field("ext_price", F64))))
    grouped = two_phase_agg(
        un, grouping=[fcol("i_item_id", STR)],
        group_fields=[Field("i_item_id", STR)],
        aggs=[("total", agg("Sum", fcol("ext_price", F64), F64),
               Field("total", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("total", F64), asc=False),
                         so(fcol("i_item_id", STR))], limit=100,
        project=[fcol("i_item_id", STR), fcol("total", F64)],
        out=Schema((Field("i_item_id", STR), Field("total", F64))))


@_q("q63w")
def q63w(cat: Catalog) -> ForeignNode:
    """q63 family: manager monthly sales vs their overall monthly average
    (window whole-partition average + comparison filter)."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_sales_price"])
    dd = cat.scan("date_dim", ["d_date_sk", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_manager_id"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2, grouping=[fcol("i_manager_id", I32), fcol("d_moy", I32)],
        group_fields=[Field("i_manager_id", I32), Field("d_moy", I32)],
        aggs=[("sum_sales", agg("Sum", fcol("ss_sales_price", F64), F64),
               Field("sum_sales", F64))])
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,), output=grouped.output,
        attrs={"partitioning": {
            "mode": "hash", "num_partitions": 4,
            "expressions": [fcol("i_manager_id", I32)]}})
    win_out = Schema((Field("i_manager_id", I32), Field("d_moy", I32),
                      Field("sum_sales", F64), Field("avg_monthly", F64)))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "avg_monthly", "fn": "agg", "args": [],
                    "agg": agg("Average", fcol("sum_sales", F64), F64),
                    "dtype": F64}],
               "partition_spec": [fcol("i_manager_id", I32)],
               "order_spec": []})
    above = ffilter(win, fcall("GreaterThan", fcol("sum_sales", F64),
                               fcol("avg_monthly", F64)))
    return take_ordered(
        above,
        orders=[so(fcol("i_manager_id", I32)), so(fcol("d_moy", I32))],
        limit=200,
        project=[fcol("i_manager_id", I32), fcol("d_moy", I32),
                 fcol("sum_sales", F64), fcol("avg_monthly", F64)],
        out=win_out)


@_q("q69a")
def q69a(cat: Catalog) -> ForeignNode:
    """q69 family: store customers with no returns at one store, by
    state (semi + anti join chain).  The anti side is a FILTERED returns
    set so the result stays non-empty at every scale factor (an anti
    join against all of web_sales empties out once every customer has
    bought online)."""
    cu = cat.scan("customer", ["c_customer_sk", "c_current_addr_sk"])
    ss = cat.scan("store_sales", ["ss_customer_sk"])
    sr = cat.scan("store_returns", ["sr_customer_sk", "sr_store_sk"])
    sr = ffilter(sr, fcall("EqualTo", fcol("sr_store_sk", I64), flit(1)))
    in_store = smj(cu, ss, [fcol("c_customer_sk", I64)],
                   [fcol("ss_customer_sk", I64)], join_type="LeftSemi")
    not_web = smj(in_store, sr, [fcol("c_customer_sk", I64)],
                  [fcol("sr_customer_sk", I64)],
                  join_type="LeftAnti")
    caddr = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    j = bhj(not_web, caddr, fcol("c_current_addr_sk", I64),
            fcol("ca_address_sk", I64))
    grouped = two_phase_agg(
        j, grouping=[fcol("ca_state", STR)],
        group_fields=[Field("ca_state", STR)],
        aggs=[("cnt", agg("Count", fcol("c_customer_sk", I64), I64),
               Field("cnt", I64))])
    return take_ordered(
        grouped, orders=[so(fcol("ca_state", STR))], limit=100,
        project=[fcol("ca_state", STR), fcol("cnt", I64)],
        out=Schema((Field("ca_state", STR), Field("cnt", I64))))


@_q("q76u")
def q76u(cat: Catalog) -> ForeignNode:
    """q76 family: channel-tagged union with per-channel counts by
    category (literal channel columns)."""
    def channel(tag, table, item_col, price_col):
        sc = cat.scan(table, [item_col, price_col])
        it = cat.scan("item", ["i_item_sk", "i_category"])
        j = bhj(sc, it, fcol(item_col, I64), fcol("i_item_sk", I64))
        return fproject(
            j, [falias(flit(tag, STR), "channel"),
                fcol("i_category", STR),
                falias(fcol(price_col, F64), "ext_price")],
            Schema((Field("channel", STR), Field("i_category", STR),
                    Field("ext_price", F64))))
    un = ForeignNode(
        "UnionExec",
        children=(channel("store", "store_sales", "ss_item_sk",
                          "ss_ext_sales_price"),
                  channel("catalog", "catalog_sales", "cs_item_sk",
                          "cs_ext_sales_price"),
                  channel("web", "web_sales", "ws_item_sk",
                          "ws_ext_sales_price")),
        output=Schema((Field("channel", STR), Field("i_category", STR),
                       Field("ext_price", F64))))
    grouped = two_phase_agg(
        un, grouping=[fcol("channel", STR), fcol("i_category", STR)],
        group_fields=[Field("channel", STR), Field("i_category", STR)],
        aggs=[("sales_cnt", agg("Count", fcol("ext_price", F64), I64),
               Field("sales_cnt", I64)),
              ("sales_amt", agg("Sum", fcol("ext_price", F64), F64),
               Field("sales_amt", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("channel", STR)), so(fcol("i_category", STR))],
        limit=100,
        project=[fcol("channel", STR), fcol("i_category", STR),
                 fcol("sales_cnt", I64), fcol("sales_amt", F64)],
        out=Schema((Field("channel", STR), Field("i_category", STR),
                    Field("sales_cnt", I64), Field("sales_amt", F64))))


@_q("q79s")
def q79s(cat: Catalog) -> ForeignNode:
    """q79 family: biggest baskets per store through a store join and a
    customer name join."""
    ss = cat.scan("store_sales",
                  ["ss_customer_sk", "ss_ticket_number", "ss_store_sk",
                   "ss_net_profit"])
    st = cat.scan("store", ["s_store_sk", "s_store_name"])
    j1 = bhj(ss, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    grouped = two_phase_agg(
        j1,
        grouping=[fcol("ss_customer_sk", I64), fcol("s_store_name", STR)],
        group_fields=[Field("ss_customer_sk", I64),
                      Field("s_store_name", STR)],
        aggs=[("profit", agg("Sum", fcol("ss_net_profit", F64), F64),
               Field("profit", F64))])
    cu = cat.scan("customer", ["c_customer_sk", "c_customer_id"])
    named = smj(grouped, cu, [fcol("ss_customer_sk", I64)],
                [fcol("c_customer_sk", I64)])
    return take_ordered(
        named,
        orders=[so(fcol("profit", F64), asc=False),
                so(fcol("c_customer_id", STR)),
                so(fcol("s_store_name", STR))],
        limit=100,
        project=[fcol("c_customer_id", STR), fcol("s_store_name", STR),
                 fcol("profit", F64)],
        out=Schema((Field("c_customer_id", STR),
                    Field("s_store_name", STR), Field("profit", F64))))


@_q("q87a")
def q87a(cat: Catalog) -> ForeignNode:
    """q87 family: EXCEPT via anti-join over deduplicated customers,
    globally counted."""
    ss = cat.scan("store_sales", ["ss_customer_sk"])
    cs = cat.scan("catalog_sales", ["cs_bill_customer_sk"])
    dedup = two_phase_agg(
        ss, grouping=[fcol("ss_customer_sk", I64)],
        group_fields=[Field("ss_customer_sk", I64)], aggs=[])
    only_store = smj(dedup, cs, [fcol("ss_customer_sk", I64)],
                     [fcol("cs_bill_customer_sk", I64)],
                     join_type="LeftAnti")
    return two_phase_agg(
        only_store, grouping=[], group_fields=[],
        aggs=[("n", agg("Count", fcol("ss_customer_sk", I64), I64),
               Field("n", I64))])


@_q("q89w")
def q89w(cat: Catalog) -> ForeignNode:
    """q89 family: months deviating above the category's monthly
    average (window average + subtraction)."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_sales_price"])
    dd = cat.scan("date_dim", ["d_date_sk", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_category"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2, grouping=[fcol("i_category", STR), fcol("d_moy", I32)],
        group_fields=[Field("i_category", STR), Field("d_moy", I32)],
        aggs=[("sum_sales", agg("Sum", fcol("ss_sales_price", F64), F64),
               Field("sum_sales", F64))])
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,), output=grouped.output,
        attrs={"partitioning": {
            "mode": "hash", "num_partitions": 4,
            "expressions": [fcol("i_category", STR)]}})
    win_out = Schema((Field("i_category", STR), Field("d_moy", I32),
                      Field("sum_sales", F64), Field("avg_sales", F64)))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "avg_sales", "fn": "agg", "args": [],
                    "agg": agg("Average", fcol("sum_sales", F64), F64),
                    "dtype": F64}],
               "partition_spec": [fcol("i_category", STR)],
               "order_spec": []})
    dev = fproject(
        win, [fcol("i_category", STR), fcol("d_moy", I32),
              fcol("sum_sales", F64), fcol("avg_sales", F64),
              falias(fcall("Subtract", fcol("sum_sales", F64),
                           fcol("avg_sales", F64), dtype=F64), "dev")],
        Schema(tuple(win_out.fields) + (Field("dev", F64),)))
    up = ffilter(dev, fcall("GreaterThan", fcol("dev", F64), flit(0.0)))
    return take_ordered(
        up,
        orders=[so(fcol("dev", F64), asc=False),
                so(fcol("i_category", STR)), so(fcol("d_moy", I32))],
        limit=100,
        project=[fcol("i_category", STR), fcol("d_moy", I32),
                 fcol("sum_sales", F64), fcol("dev", F64)],
        out=Schema((Field("i_category", STR), Field("d_moy", I32),
                    Field("sum_sales", F64), Field("dev", F64))))


@_q("q92f")
def q92f(cat: Catalog) -> ForeignNode:
    """q92 family: sales beating 1.3x their item's average price
    (aggregate self-join)."""
    ws = cat.scan("web_sales", ["ws_item_sk", "ws_ext_sales_price"])
    avg_by_item = two_phase_agg(
        cat.scan("web_sales", ["ws_item_sk", "ws_ext_sales_price"]),
        grouping=[falias(fcol("ws_item_sk", I64), "avg_item_sk")],
        group_fields=[Field("avg_item_sk", I64)],
        aggs=[("avg_price", agg("Average", fcol("ws_ext_sales_price",
                                                F64), F64),
               Field("avg_price", F64))])
    j = bhj(ws, avg_by_item, fcol("ws_item_sk", I64),
            fcol("avg_item_sk", I64))
    hot = ffilter(
        j, fcall("GreaterThan", fcol("ws_ext_sales_price", F64),
                 fcall("Multiply", flit(1.3), fcol("avg_price", F64),
                       dtype=F64)))
    return two_phase_agg(
        hot, grouping=[], group_fields=[],
        aggs=[("excess_rev", agg("Sum", fcol("ws_ext_sales_price", F64),
                                 F64), Field("excess_rev", F64)),
              ("n", agg("Count", fcol("ws_ext_sales_price", F64), I64),
               Field("n", I64))])


@_q("q93s")
def q93s(cat: Catalog) -> ForeignNode:
    """q93 family: actual revenue net of returns via LEFT OUTER join +
    CASE (returned rows subtract their refund)."""
    ss = cat.scan("store_sales",
                  ["ss_ticket_number", "ss_item_sk", "ss_customer_sk",
                   "ss_ext_sales_price"])
    sr = cat.scan("store_returns",
                  ["sr_ticket_number", "sr_item_sk", "sr_return_amt"])
    j = smj(ss, sr,
            [fcol("ss_ticket_number", I64), fcol("ss_item_sk", I64)],
            [fcol("sr_ticket_number", I64), fcol("sr_item_sk", I64)],
            join_type="LeftOuter")
    act = fproject(
        j, [fcol("ss_customer_sk", I64),
            falias(fcall("CaseWhen",
                         fcall("IsNotNull", fcol("sr_return_amt", F64)),
                         fcall("Subtract", fcol("ss_ext_sales_price",
                                                F64),
                               fcol("sr_return_amt", F64), dtype=F64),
                         fcol("ss_ext_sales_price", F64), dtype=F64),
                   "act_sales")],
        Schema((Field("ss_customer_sk", I64), Field("act_sales", F64))))
    grouped = two_phase_agg(
        act, grouping=[fcol("ss_customer_sk", I64)],
        group_fields=[Field("ss_customer_sk", I64)],
        aggs=[("sumsales", agg("Sum", fcol("act_sales", F64), F64),
               Field("sumsales", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("sumsales", F64), asc=False),
                so(fcol("ss_customer_sk", I64))],
        limit=100,
        project=[fcol("ss_customer_sk", I64), fcol("sumsales", F64)],
        out=Schema((Field("ss_customer_sk", I64),
                    Field("sumsales", F64))))


@_q("q36r")
def q36r(cat: Catalog) -> ForeignNode:
    """q36 family: gross-margin rollup over (category, class) with the
    ratio computed post-aggregation."""
    ss = cat.scan("store_sales",
                  ["ss_item_sk", "ss_ext_sales_price", "ss_net_profit"])
    it = cat.scan("item", ["i_item_sk", "i_category", "i_class"])
    j = bhj(ss, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    pre = fproject(
        j, [fcol("i_category", STR), fcol("i_class", STR),
            fcol("ss_ext_sales_price", F64), fcol("ss_net_profit", F64)],
        Schema((Field("i_category", STR), Field("i_class", STR),
                Field("ss_ext_sales_price", F64),
                Field("ss_net_profit", F64))))
    expand_out = Schema((Field("i_category", STR), Field("i_class", STR),
                         Field("ss_ext_sales_price", F64),
                         Field("ss_net_profit", F64),
                         Field("spark_grouping_id", I64)))
    expand = ForeignNode(
        "ExpandExec", children=(pre,), output=expand_out,
        attrs={"projections": [
            [fcol("i_category", STR), fcol("i_class", STR),
             fcol("ss_ext_sales_price", F64), fcol("ss_net_profit", F64),
             flit(0, I64)],
            [fcol("i_category", STR), flit(None, STR),
             fcol("ss_ext_sales_price", F64), fcol("ss_net_profit", F64),
             flit(1, I64)],
            [flit(None, STR), flit(None, STR),
             fcol("ss_ext_sales_price", F64), fcol("ss_net_profit", F64),
             flit(3, I64)]]})
    grouped = two_phase_agg(
        expand,
        grouping=[fcol("i_category", STR), fcol("i_class", STR),
                  fcol("spark_grouping_id", I64)],
        group_fields=[Field("i_category", STR), Field("i_class", STR),
                      Field("spark_grouping_id", I64)],
        aggs=[("profit", agg("Sum", fcol("ss_net_profit", F64), F64),
               Field("profit", F64)),
              ("rev", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("rev", F64))])
    margined = fproject(
        grouped,
        [fcol("i_category", STR), fcol("i_class", STR),
         fcol("spark_grouping_id", I64),
         falias(fcall("Divide", fcol("profit", F64), fcol("rev", F64),
                      dtype=F64), "gross_margin")],
        Schema((Field("i_category", STR), Field("i_class", STR),
                Field("spark_grouping_id", I64),
                Field("gross_margin", F64))))
    return take_ordered(
        margined,
        orders=[so(fcol("spark_grouping_id", I64)),
                so(fcol("gross_margin", F64)),
                so(fcol("i_category", STR), nulls_first=True),
                so(fcol("i_class", STR), nulls_first=True)],
        limit=100,
        project=[fcol("i_category", STR), fcol("i_class", STR),
                 fcol("spark_grouping_id", I64),
                 fcol("gross_margin", F64)],
        out=Schema((Field("i_category", STR), Field("i_class", STR),
                    Field("spark_grouping_id", I64),
                    Field("gross_margin", F64))))


# ---------------------------------------------------------------------------
# multi-channel unions, rollups, aggregate self-joins
# ---------------------------------------------------------------------------

def _channel_scan(cat: Catalog, tag: str, table: str, prefix: str,
                  cols: Sequence[str]) -> ForeignNode:
    """Scan a sales channel and normalize columns to (channel, *cols) —
    the q05/q66/q75/q77 union idiom."""
    pfx_cols = [f"{prefix}_{c}" for c in cols]
    sc = cat.scan(table, pfx_cols)
    fields = [Field("channel", STR)]
    exprs = [falias(flit(tag, STR), "channel")]
    for c, pc in zip(cols, pfx_cols):
        dt = next(f.dtype for f in sc.output.fields if f.name == pc)
        exprs.append(falias(fcol(pc, dt), c))
        fields.append(Field(c, dt))
    return fproject(sc, exprs, Schema(tuple(fields)))


@_q("q05r")
def q05r(cat: Catalog) -> ForeignNode:
    """q05 family: channel rollup — union of the three sales channels,
    Expand on (channel) with a grouping id, sums of sales and profit."""
    chans = [
        _channel_scan(cat, "store channel", "store_sales", "ss",
                      ["ext_sales_price", "net_profit"]),
        _channel_scan(cat, "catalog channel", "catalog_sales", "cs",
                      ["ext_sales_price", "net_profit"]),
        _channel_scan(cat, "web channel", "web_sales", "ws",
                      ["ext_sales_price", "net_profit"]),
    ]
    un_out = chans[0].output
    un = ForeignNode("UnionExec", children=tuple(chans), output=un_out)
    expand_out = Schema(tuple(un_out.fields) +
                        (Field("spark_grouping_id", I64),))
    expand = ForeignNode(
        "ExpandExec", children=(un,), output=expand_out,
        attrs={"projections": [
            [fcol("channel", STR), fcol("ext_sales_price", F64),
             fcol("net_profit", F64), flit(0, I64)],
            [flit(None, STR), fcol("ext_sales_price", F64),
             fcol("net_profit", F64), flit(1, I64)]]})
    grouped = two_phase_agg(
        expand,
        grouping=[fcol("channel", STR), fcol("spark_grouping_id", I64)],
        group_fields=[Field("channel", STR),
                      Field("spark_grouping_id", I64)],
        aggs=[("sales", agg("Sum", fcol("ext_sales_price", F64), F64),
               Field("sales", F64)),
              ("profit", agg("Sum", fcol("net_profit", F64), F64),
               Field("profit", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("spark_grouping_id", I64)),
                so(fcol("channel", STR), nulls_first=True)],
        limit=100,
        project=[fcol("channel", STR), fcol("spark_grouping_id", I64),
                 fcol("sales", F64), fcol("profit", F64)],
        out=Schema((Field("channel", STR),
                    Field("spark_grouping_id", I64),
                    Field("sales", F64), Field("profit", F64))))


@_q("q09c")
def q09c(cat: Catalog) -> ForeignNode:
    """q09 family: quantity-band bucket via nested CASE WHEN, counts and
    average prices per band."""
    ss = cat.scan("store_sales", ["ss_quantity", "ss_sales_price"])
    band = fcall(
        "CaseWhen",
        fcall("LessThanOrEqual", fcol("ss_quantity", I32), flit(20)),
        flit("1-20", STR),
        fcall("CaseWhen",
              fcall("LessThanOrEqual", fcol("ss_quantity", I32),
                    flit(60)),
              flit("21-60", STR), flit("61-100", STR), dtype=STR),
        dtype=STR)
    pre = fproject(
        ss, [falias(band, "band"), fcol("ss_sales_price", F64)],
        Schema((Field("band", STR), Field("ss_sales_price", F64))))
    grouped = two_phase_agg(
        pre, grouping=[fcol("band", STR)],
        group_fields=[Field("band", STR)],
        aggs=[("cnt", agg("Count", fcol("ss_sales_price", F64), I64),
               Field("cnt", I64)),
              ("avg_price", agg("Average", fcol("ss_sales_price", F64),
                                F64),
               Field("avg_price", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("band", STR))], limit=10,
        project=[fcol("band", STR), fcol("cnt", I64),
                 fcol("avg_price", F64)],
        out=Schema((Field("band", STR), Field("cnt", I64),
                    Field("avg_price", F64))))


@_q("q14c")
def q14c(cat: Catalog) -> ForeignNode:
    """q14 family (cross-channel items): store-channel revenue restricted
    to items that also sell on the catalog channel (LeftSemi over the
    catalog item set), grouped by brand."""
    cs_items = two_phase_agg(
        cat.scan("catalog_sales", ["cs_item_sk"]),
        grouping=[fcol("cs_item_sk", I64)],
        group_fields=[Field("cs_item_sk", I64)],
        aggs=[("n", agg("Count", None, I64), Field("n", I64))])
    ss = cat.scan("store_sales", ["ss_item_sk", "ss_ext_sales_price"])
    both = smj(ss, cs_items, [fcol("ss_item_sk", I64)],
               [fcol("cs_item_sk", I64)], join_type="LeftSemi")
    it = cat.scan("item", ["i_item_sk", "i_brand"])
    j = bhj(both, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j, grouping=[fcol("i_brand", STR)],
        group_fields=[Field("i_brand", STR)],
        aggs=[("rev", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("rev", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("rev", F64), asc=False),
                         so(fcol("i_brand", STR))], limit=100,
        project=[fcol("i_brand", STR), fcol("rev", F64)],
        out=Schema((Field("i_brand", STR), Field("rev", F64))))


@_q("q18a")
def q18a(cat: Catalog) -> ForeignNode:
    """q18 family: catalog average quantities by customer state with a
    rollup level."""
    cs = cat.scan("catalog_sales", ["cs_bill_customer_sk", "cs_quantity"])
    cu = cat.scan("customer", ["c_customer_sk", "c_current_addr_sk"])
    ca = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    j1 = bhj(cs, cu, fcol("cs_bill_customer_sk", I64),
             fcol("c_customer_sk", I64))
    j2 = bhj(j1, ca, fcol("c_current_addr_sk", I64),
             fcol("ca_address_sk", I64))
    pre = fproject(
        j2, [fcol("ca_state", STR),
             falias(fcall("Cast", fcol("cs_quantity", I32), dtype=F64),
                    "qty")],
        Schema((Field("ca_state", STR), Field("qty", F64))))
    expand_out = Schema((Field("ca_state", STR), Field("qty", F64),
                         Field("spark_grouping_id", I64)))
    expand = ForeignNode(
        "ExpandExec", children=(pre,), output=expand_out,
        attrs={"projections": [
            [fcol("ca_state", STR), fcol("qty", F64), flit(0, I64)],
            [flit(None, STR), fcol("qty", F64), flit(1, I64)]]})
    grouped = two_phase_agg(
        expand,
        grouping=[fcol("ca_state", STR), fcol("spark_grouping_id", I64)],
        group_fields=[Field("ca_state", STR),
                      Field("spark_grouping_id", I64)],
        aggs=[("avg_qty", agg("Average", fcol("qty", F64), F64),
               Field("avg_qty", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("spark_grouping_id", I64)),
                so(fcol("ca_state", STR), nulls_first=True)],
        limit=100,
        project=[fcol("ca_state", STR), fcol("spark_grouping_id", I64),
                 fcol("avg_qty", F64)],
        out=Schema((Field("ca_state", STR),
                    Field("spark_grouping_id", I64),
                    Field("avg_qty", F64))))


@_q("q23m")
def q23m(cat: Catalog) -> ForeignNode:
    """q23 family: frequent store items (count > 5) restrict web
    revenue via LeftSemi."""
    freq = two_phase_agg(
        cat.scan("store_sales", ["ss_item_sk"]),
        grouping=[fcol("ss_item_sk", I64)],
        group_fields=[Field("ss_item_sk", I64)],
        aggs=[("cnt", agg("Count", None, I64), Field("cnt", I64))])
    freq = ffilter(freq, fcall("GreaterThan", fcol("cnt", I64), flit(5)))
    ws = cat.scan("web_sales", ["ws_item_sk", "ws_ext_sales_price"])
    sel = smj(ws, freq, [fcol("ws_item_sk", I64)],
              [fcol("ss_item_sk", I64)], join_type="LeftSemi")
    total = two_phase_agg(
        sel, grouping=[],
        group_fields=[],
        aggs=[("rev", agg("Sum", fcol("ws_ext_sales_price", F64), F64),
               Field("rev", F64)),
              ("n", agg("Count", fcol("ws_ext_sales_price", F64), I64),
               Field("n", I64))])
    return total


@_q("q31s")
def q31s(cat: Catalog) -> ForeignNode:
    """q31 family: store-vs-web quarterly revenue ratio (two aggregated
    branches joined on quarter)."""
    def by_qoy(table, prefix):
        sc = cat.scan(table, [f"{prefix}_sold_date_sk",
                              f"{prefix}_ext_sales_price"])
        dd = cat.scan("date_dim", ["d_date_sk", "d_qoy"])
        j = bhj(sc, dd, fcol(f"{prefix}_sold_date_sk", I64),
                fcol("d_date_sk", I64))
        return two_phase_agg(
            j, grouping=[fcol("d_qoy", I32)],
            group_fields=[Field("d_qoy", I32)],
            aggs=[(f"{prefix}_rev",
                   agg("Sum", fcol(f"{prefix}_ext_sales_price", F64),
                       F64),
                   Field(f"{prefix}_rev", F64))])
    ssq = by_qoy("store_sales", "ss")
    wsq = fproject(
        by_qoy("web_sales", "ws"),
        [falias(fcol("d_qoy", I32), "wq"), fcol("ws_rev", F64)],
        Schema((Field("wq", I32), Field("ws_rev", F64))))
    j = smj(ssq, wsq, [fcol("d_qoy", I32)], [fcol("wq", I32)],
            out=Schema(tuple(ssq.output.fields) +
                       tuple(wsq.output.fields)))
    ratio = fproject(
        j, [fcol("d_qoy", I32), fcol("ss_rev", F64), fcol("ws_rev", F64),
            falias(fcall("Divide", fcol("ws_rev", F64),
                         fcol("ss_rev", F64), dtype=F64), "web_ratio")],
        Schema((Field("d_qoy", I32), Field("ss_rev", F64),
                Field("ws_rev", F64), Field("web_ratio", F64))))
    return take_ordered(
        ratio, orders=[so(fcol("d_qoy", I32))], limit=10,
        project=[fcol("d_qoy", I32), fcol("ss_rev", F64),
                 fcol("ws_rev", F64), fcol("web_ratio", F64)],
        out=ratio.output)


@_q("q61p")
def q61p(cat: Catalog) -> ForeignNode:
    """q61 family: promotional revenue share — email-channel promo sales
    over all sales (two global aggs joined on a literal key)."""
    ss = cat.scan("store_sales", ["ss_promo_sk", "ss_ext_sales_price"])
    pr = cat.scan("promotion", ["p_promo_sk", "p_channel_email"])
    promo = bhj(ss, pr, fcol("ss_promo_sk", I64),
                fcol("p_promo_sk", I64))
    promo = ffilter(promo, fcall("EqualTo", fcol("p_channel_email", STR),
                                 flit("Y", STR)))

    def keyed_total(child, prefix, col):
        tot = two_phase_agg(
            child, grouping=[], group_fields=[],
            aggs=[(f"{prefix}_rev", agg("Sum", fcol(col, F64), F64),
                   Field(f"{prefix}_rev", F64))])
        key = f"{prefix}_k"
        return fproject(
            tot, [falias(flit(1, I64), key),
                  fcol(f"{prefix}_rev", F64)],
            Schema((Field(key, I64), Field(f"{prefix}_rev", F64))))

    promo_tot = keyed_total(promo, "promo", "ss_ext_sales_price")
    all_tot = keyed_total(
        cat.scan("store_sales", ["ss_promo_sk", "ss_ext_sales_price"]),
        "all", "ss_ext_sales_price")
    j = bhj(promo_tot, all_tot, fcol("promo_k", I64), fcol("all_k", I64))
    return fproject(
        j, [fcol("promo_rev", F64), fcol("all_rev", F64),
            falias(fcall("Multiply",
                         fcall("Divide", fcol("promo_rev", F64),
                               fcol("all_rev", F64), dtype=F64),
                         flit(100.0, F64), dtype=F64), "promo_pct")],
        Schema((Field("promo_rev", F64), Field("all_rev", F64),
                Field("promo_pct", F64))))


@_q("q66w")
def q66w(cat: Catalog) -> ForeignNode:
    """q66 family: web + catalog monthly revenue with a rollup total."""
    def monthly(table, prefix, tag):
        sc = cat.scan(table, [f"{prefix}_sold_date_sk",
                              f"{prefix}_ext_sales_price"])
        dd = cat.scan("date_dim", ["d_date_sk", "d_moy"])
        j = bhj(sc, dd, fcol(f"{prefix}_sold_date_sk", I64),
                fcol("d_date_sk", I64))
        return fproject(
            j, [falias(flit(tag, STR), "channel"), fcol("d_moy", I32),
                falias(fcol(f"{prefix}_ext_sales_price", F64), "rev")],
            Schema((Field("channel", STR), Field("d_moy", I32),
                    Field("rev", F64))))
    un = ForeignNode(
        "UnionExec",
        children=(monthly("web_sales", "ws", "web"),
                  monthly("catalog_sales", "cs", "catalog")),
        output=Schema((Field("channel", STR), Field("d_moy", I32),
                       Field("rev", F64))))
    expand_out = Schema(tuple(un.output.fields) +
                        (Field("spark_grouping_id", I64),))
    expand = ForeignNode(
        "ExpandExec", children=(un,), output=expand_out,
        attrs={"projections": [
            [fcol("channel", STR), fcol("d_moy", I32), fcol("rev", F64),
             flit(0, I64)],
            [fcol("channel", STR), flit(None, I32), fcol("rev", F64),
             flit(1, I64)]]})
    grouped = two_phase_agg(
        expand,
        grouping=[fcol("channel", STR), fcol("d_moy", I32),
                  fcol("spark_grouping_id", I64)],
        group_fields=[Field("channel", STR), Field("d_moy", I32),
                      Field("spark_grouping_id", I64)],
        aggs=[("rev", agg("Sum", fcol("rev", F64), F64),
               Field("rev", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("channel", STR)),
                so(fcol("spark_grouping_id", I64)),
                so(fcol("d_moy", I32), nulls_first=True)],
        limit=100,
        project=[fcol("channel", STR), fcol("d_moy", I32),
                 fcol("spark_grouping_id", I64), fcol("rev", F64)],
        out=Schema((Field("channel", STR), Field("d_moy", I32),
                    Field("spark_grouping_id", I64), Field("rev", F64))))


@_q("q75y")
def q75y(cat: Catalog) -> ForeignNode:
    """q75 family: year-over-year category revenue delta — union of all
    channels aggregated by (year, category), self-joined on year+1."""
    def chan(table, prefix):
        sc = cat.scan(table, [f"{prefix}_sold_date_sk",
                              f"{prefix}_item_sk",
                              f"{prefix}_ext_sales_price"])
        dd = cat.scan("date_dim", ["d_date_sk", "d_year"])
        it = cat.scan("item", ["i_item_sk", "i_category"])
        j1 = bhj(sc, dd, fcol(f"{prefix}_sold_date_sk", I64),
                 fcol("d_date_sk", I64))
        j2 = bhj(j1, it, fcol(f"{prefix}_item_sk", I64),
                 fcol("i_item_sk", I64))
        return fproject(
            j2, [fcol("d_year", I32), fcol("i_category", STR),
                 falias(fcol(f"{prefix}_ext_sales_price", F64), "rev")],
            Schema((Field("d_year", I32), Field("i_category", STR),
                    Field("rev", F64))))
    un = ForeignNode(
        "UnionExec",
        children=(chan("store_sales", "ss"),
                  chan("catalog_sales", "cs"), chan("web_sales", "ws")),
        output=Schema((Field("d_year", I32), Field("i_category", STR),
                       Field("rev", F64))))
    yearly = two_phase_agg(
        un, grouping=[fcol("d_year", I32), fcol("i_category", STR)],
        group_fields=[Field("d_year", I32), Field("i_category", STR)],
        aggs=[("rev", agg("Sum", fcol("rev", F64), F64),
               Field("rev", F64))])
    prev = fproject(
        yearly,
        [falias(fcall("Cast",
                      fcall("Subtract", fcol("d_year", I32), flit(-1)),
                      dtype=I32), "next_year"),
         fcol("i_category", STR), falias(fcol("rev", F64), "prev_rev")],
        Schema((Field("next_year", I32), Field("i_category", STR),
                Field("prev_rev", F64))))
    # NOTE: Subtract(x, -1) = x + 1 keeps the vocabulary to the corpus set
    cur = fproject(
        yearly, [fcol("d_year", I32),
                 falias(fcol("i_category", STR), "cat"),
                 fcol("rev", F64)],
        Schema((Field("d_year", I32), Field("cat", STR),
                Field("rev", F64))))
    j = smj(cur, prev, [fcol("d_year", I32), fcol("cat", STR)],
            [fcol("next_year", I32), fcol("i_category", STR)],
            out=Schema(tuple(cur.output.fields) +
                       tuple(prev.output.fields)))
    delta = fproject(
        j, [fcol("d_year", I32), fcol("cat", STR), fcol("rev", F64),
            fcol("prev_rev", F64),
            falias(fcall("Subtract", fcol("rev", F64),
                         fcol("prev_rev", F64), dtype=F64), "delta")],
        Schema((Field("d_year", I32), Field("cat", STR),
                Field("rev", F64), Field("prev_rev", F64),
                Field("delta", F64))))
    return take_ordered(
        delta,
        orders=[so(fcol("delta", F64)), so(fcol("d_year", I32)),
                so(fcol("cat", STR))],
        limit=100,
        project=[fcol("d_year", I32), fcol("cat", STR),
                 fcol("rev", F64), fcol("prev_rev", F64),
                 fcol("delta", F64)],
        out=delta.output)


@_q("q77r")
def q77r(cat: Catalog) -> ForeignNode:
    """q77 family: per-store net = sales profit minus return losses
    (FULL OUTER of two aggregated branches + null-coalescing CASE)."""
    prof = two_phase_agg(
        cat.scan("store_sales", ["ss_store_sk", "ss_net_profit"]),
        grouping=[fcol("ss_store_sk", I64)],
        group_fields=[Field("ss_store_sk", I64)],
        aggs=[("profit", agg("Sum", fcol("ss_net_profit", F64), F64),
               Field("profit", F64))])
    loss = two_phase_agg(
        cat.scan("store_returns", ["sr_store_sk", "sr_return_amt"]),
        grouping=[fcol("sr_store_sk", I64)],
        group_fields=[Field("sr_store_sk", I64)],
        aggs=[("loss", agg("Sum", fcol("sr_return_amt", F64), F64),
               Field("loss", F64))])
    j = smj(prof, loss, [fcol("ss_store_sk", I64)],
            [fcol("sr_store_sk", I64)], join_type="FullOuter",
            out=Schema(tuple(prof.output.fields) +
                       tuple(loss.output.fields)))
    def nz(col_name):
        return fcall("CaseWhen", fcall("IsNotNull", fcol(col_name, F64)),
                     fcol(col_name, F64), flit(0.0, F64), dtype=F64)
    net = fproject(
        j, [fcol("ss_store_sk", I64), fcol("profit", F64),
            fcol("loss", F64),
            falias(fcall("Subtract", nz("profit"), nz("loss"),
                         dtype=F64), "net")],
        Schema((Field("ss_store_sk", I64), Field("profit", F64),
                Field("loss", F64), Field("net", F64))))
    return take_ordered(
        net,
        orders=[so(fcol("net", F64), asc=False),
                so(fcol("ss_store_sk", I64), nulls_first=True)],
        limit=100,
        project=[fcol("ss_store_sk", I64), fcol("profit", F64),
                 fcol("loss", F64), fcol("net", F64)],
        out=net.output)


@_q("q86r")
def q86r(cat: Catalog) -> ForeignNode:
    """q86 family: web-channel rollup over (category, class) — the
    q36r shape on web_sales."""
    ws = cat.scan("web_sales", ["ws_item_sk", "ws_net_profit"])
    it = cat.scan("item", ["i_item_sk", "i_category", "i_class"])
    j = bhj(ws, it, fcol("ws_item_sk", I64), fcol("i_item_sk", I64))
    pre = fproject(
        j, [fcol("i_category", STR), fcol("i_class", STR),
            fcol("ws_net_profit", F64)],
        Schema((Field("i_category", STR), Field("i_class", STR),
                Field("ws_net_profit", F64))))
    expand_out = Schema(tuple(pre.output.fields) +
                        (Field("spark_grouping_id", I64),))
    expand = ForeignNode(
        "ExpandExec", children=(pre,), output=expand_out,
        attrs={"projections": [
            [fcol("i_category", STR), fcol("i_class", STR),
             fcol("ws_net_profit", F64), flit(0, I64)],
            [fcol("i_category", STR), flit(None, STR),
             fcol("ws_net_profit", F64), flit(1, I64)],
            [flit(None, STR), flit(None, STR),
             fcol("ws_net_profit", F64), flit(3, I64)]]})
    grouped = two_phase_agg(
        expand,
        grouping=[fcol("i_category", STR), fcol("i_class", STR),
                  fcol("spark_grouping_id", I64)],
        group_fields=[Field("i_category", STR), Field("i_class", STR),
                      Field("spark_grouping_id", I64)],
        aggs=[("profit", agg("Sum", fcol("ws_net_profit", F64), F64),
               Field("profit", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("spark_grouping_id", I64)),
                so(fcol("profit", F64), asc=False),
                so(fcol("i_category", STR), nulls_first=True),
                so(fcol("i_class", STR), nulls_first=True)],
        limit=100,
        project=[fcol("i_category", STR), fcol("i_class", STR),
                 fcol("spark_grouping_id", I64), fcol("profit", F64)],
        out=Schema((Field("i_category", STR), Field("i_class", STR),
                    Field("spark_grouping_id", I64),
                    Field("profit", F64))))


@_q("q97o")
def q97o(cat: Catalog) -> ForeignNode:
    """q97 family: store/web customer overlap — FULL OUTER join of the
    two channels' customer sets, CASE-WHEN membership counts."""
    ssc = two_phase_agg(
        cat.scan("store_sales", ["ss_customer_sk"]),
        grouping=[fcol("ss_customer_sk", I64)],
        group_fields=[Field("ss_customer_sk", I64)],
        aggs=[("sn", agg("Count", None, I64), Field("sn", I64))])
    wsc = two_phase_agg(
        cat.scan("web_sales", ["ws_bill_customer_sk"]),
        grouping=[fcol("ws_bill_customer_sk", I64)],
        group_fields=[Field("ws_bill_customer_sk", I64)],
        aggs=[("wn", agg("Count", None, I64), Field("wn", I64))])
    j = smj(ssc, wsc, [fcol("ss_customer_sk", I64)],
            [fcol("ws_bill_customer_sk", I64)], join_type="FullOuter",
            out=Schema(tuple(ssc.output.fields) +
                       tuple(wsc.output.fields)))
    def flag(cond):
        return fcall("CaseWhen", cond, flit(1, I64), flit(0, I64),
                     dtype=I64)
    marked = fproject(
        j, [falias(flag(fcall("And",
                              fcall("IsNotNull", fcol("sn", I64)),
                              fcall("IsNotNull", fcol("wn", I64)))),
                   "both"),
            falias(flag(fcall("IsNotNull", fcol("sn", I64))),
                   "store_only"),
            falias(flag(fcall("IsNotNull", fcol("wn", I64))),
                   "web_only")],
        Schema((Field("both", I64), Field("store_only", I64),
                Field("web_only", I64))))
    return two_phase_agg(
        marked, grouping=[], group_fields=[],
        aggs=[("n_both", agg("Sum", fcol("both", I64), I64),
               Field("n_both", I64)),
              ("n_store", agg("Sum", fcol("store_only", I64), I64),
               Field("n_store", I64)),
              ("n_web", agg("Sum", fcol("web_only", I64), I64),
               Field("n_web", I64))])


@_q("q35a")
def q35a(cat: Catalog) -> ForeignNode:
    """q35 family: customers active on the web, profiled by address
    state (LeftSemi + dim joins + counts)."""
    cu = cat.scan("customer", ["c_customer_sk", "c_current_addr_sk"])
    ws = cat.scan("web_sales", ["ws_bill_customer_sk"])
    active = smj(cu, ws, [fcol("c_customer_sk", I64)],
                 [fcol("ws_bill_customer_sk", I64)],
                 join_type="LeftSemi")
    ca = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    j = bhj(active, ca, fcol("c_current_addr_sk", I64),
            fcol("ca_address_sk", I64))
    grouped = two_phase_agg(
        j, grouping=[fcol("ca_state", STR)],
        group_fields=[Field("ca_state", STR)],
        aggs=[("cnt", agg("Count", None, I64), Field("cnt", I64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("cnt", I64), asc=False),
                so(fcol("ca_state", STR))],
        limit=100,
        project=[fcol("ca_state", STR), fcol("cnt", I64)],
        out=Schema((Field("ca_state", STR), Field("cnt", I64))))


# ---------------------------------------------------------------------------
# window-share ratios, rank windows, customer growth
# ---------------------------------------------------------------------------

def _rev_share_by(cat: Catalog, table: str, prefix: str,
                  part_col: str, sub_col: str):
    """Revenue by (part, sub) with each sub's share of its part's total
    via a whole-partition window sum (q12/q20 idiom)."""
    sc = cat.scan(table, [f"{prefix}_item_sk", f"{prefix}_ext_sales_price"])
    it = cat.scan("item", ["i_item_sk", part_col, sub_col])
    j = bhj(sc, it, fcol(f"{prefix}_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j, grouping=[fcol(part_col, STR), fcol(sub_col, STR)],
        group_fields=[Field(part_col, STR), Field(sub_col, STR)],
        aggs=[("rev", agg("Sum", fcol(f"{prefix}_ext_sales_price", F64),
                          F64),
               Field("rev", F64))])
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,), output=grouped.output,
        attrs={"partitioning": {
            "mode": "hash", "num_partitions": 4,
            "expressions": [fcol(part_col, STR)]}})
    win_out = Schema(tuple(grouped.output.fields) +
                     (Field("part_total", F64),))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "part_total", "fn": "agg", "args": [],
                    "agg": agg("Sum", fcol("rev", F64), F64),
                    "dtype": F64}],
               "partition_spec": [fcol(part_col, STR)],
               "order_spec": []})
    share = fproject(
        win, [fcol(part_col, STR), fcol(sub_col, STR), fcol("rev", F64),
              falias(fcall("Multiply",
                           fcall("Divide", fcol("rev", F64),
                                 fcol("part_total", F64), dtype=F64),
                           flit(100.0, F64), dtype=F64), "revshare")],
        Schema((Field(part_col, STR), Field(sub_col, STR),
                Field("rev", F64), Field("revshare", F64))))
    return take_ordered(
        share,
        orders=[so(fcol(part_col, STR)), so(fcol("revshare", F64),
                                            asc=False),
                so(fcol(sub_col, STR))],
        limit=100,
        project=[fcol(part_col, STR), fcol(sub_col, STR),
                 fcol("rev", F64), fcol("revshare", F64)],
        out=share.output)


@_q("q12w")
def q12w(cat: Catalog) -> ForeignNode:
    """q12 family: web class revenue share within its category."""
    return _rev_share_by(cat, "web_sales", "ws", "i_category", "i_class")


@_q("q20c")
def q20c(cat: Catalog) -> ForeignNode:
    """q20 family: catalog class revenue share within its category."""
    return _rev_share_by(cat, "catalog_sales", "cs", "i_category",
                         "i_class")


@_q("q02w")
def q02w(cat: Catalog) -> ForeignNode:
    """q02 family: day-of-week revenue share across store+web."""
    def chan(table, prefix):
        sc = cat.scan(table, [f"{prefix}_sold_date_sk",
                              f"{prefix}_ext_sales_price"])
        dd = cat.scan("date_dim", ["d_date_sk", "d_day_name"])
        j = bhj(sc, dd, fcol(f"{prefix}_sold_date_sk", I64),
                fcol("d_date_sk", I64))
        return fproject(
            j, [fcol("d_day_name", STR),
                falias(fcol(f"{prefix}_ext_sales_price", F64), "rev")],
            Schema((Field("d_day_name", STR), Field("rev", F64))))
    un = ForeignNode(
        "UnionExec",
        children=(chan("store_sales", "ss"), chan("web_sales", "ws")),
        output=Schema((Field("d_day_name", STR), Field("rev", F64))))
    daily = two_phase_agg(
        un, grouping=[fcol("d_day_name", STR)],
        group_fields=[Field("d_day_name", STR)],
        aggs=[("rev", agg("Sum", fcol("rev", F64), F64),
               Field("rev", F64))])
    single = ForeignNode(
        "ShuffleExchangeExec", children=(daily,), output=daily.output,
        attrs={"partitioning": {"mode": "single", "num_partitions": 1}})
    win_out = Schema(tuple(daily.output.fields) + (Field("total", F64),))
    win = ForeignNode(
        "WindowExec", children=(single,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "total", "fn": "agg", "args": [],
                    "agg": agg("Sum", fcol("rev", F64), F64),
                    "dtype": F64}],
               "partition_spec": [], "order_spec": []})
    share = fproject(
        win, [fcol("d_day_name", STR), fcol("rev", F64),
              falias(fcall("Divide", fcol("rev", F64),
                           fcol("total", F64), dtype=F64), "share")],
        Schema((Field("d_day_name", STR), Field("rev", F64),
                Field("share", F64))))
    return take_ordered(
        share, orders=[so(fcol("d_day_name", STR))], limit=10,
        project=[fcol("d_day_name", STR), fcol("rev", F64),
                 fcol("share", F64)],
        out=share.output)


@_q("q08a")
def q08a(cat: Catalog) -> ForeignNode:
    """q08 family: store revenue restricted to stores in states that
    actually have customers (LeftSemi against the address dim)."""
    ss = cat.scan("store_sales", ["ss_store_sk", "ss_ext_sales_price"])
    st = cat.scan("store", ["s_store_sk", "s_store_name", "s_state"])
    j = bhj(ss, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    ca_states = two_phase_agg(
        cat.scan("customer_address", ["ca_state"]),
        grouping=[fcol("ca_state", STR)],
        group_fields=[Field("ca_state", STR)],
        aggs=[("n", agg("Count", None, I64), Field("n", I64))])
    sel = smj(j, ca_states, [fcol("s_state", STR)],
              [fcol("ca_state", STR)], join_type="LeftSemi")
    grouped = two_phase_agg(
        sel, grouping=[fcol("s_store_name", STR)],
        group_fields=[Field("s_store_name", STR)],
        aggs=[("rev", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("rev", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("rev", F64), asc=False),
                so(fcol("s_store_name", STR))],
        limit=100,
        project=[fcol("s_store_name", STR), fcol("rev", F64)],
        out=Schema((Field("s_store_name", STR), Field("rev", F64))))


@_q("q11y")
def q11y(cat: Catalog) -> ForeignNode:
    """q11/q74 family: customers whose web spend grew year-over-year
    (per-customer-year aggs self-joined on year+1)."""
    ws = cat.scan("web_sales", ["ws_bill_customer_sk", "ws_sold_date_sk",
                                "ws_ext_sales_price"])
    dd = cat.scan("date_dim", ["d_date_sk", "d_year"])
    j = bhj(ws, dd, fcol("ws_sold_date_sk", I64), fcol("d_date_sk", I64))
    yearly = two_phase_agg(
        j, grouping=[fcol("ws_bill_customer_sk", I64),
                     fcol("d_year", I32)],
        group_fields=[Field("ws_bill_customer_sk", I64),
                      Field("d_year", I32)],
        aggs=[("spend", agg("Sum", fcol("ws_ext_sales_price", F64), F64),
               Field("spend", F64))])
    prev = fproject(
        yearly,
        [falias(fcol("ws_bill_customer_sk", I64), "pc"),
         falias(fcall("Cast", fcall("Subtract", fcol("d_year", I32),
                                    flit(-1)), dtype=I32), "ny"),
         falias(fcol("spend", F64), "prev_spend")],
        Schema((Field("pc", I64), Field("ny", I32),
                Field("prev_spend", F64))))
    grown = smj(yearly, prev,
                [fcol("ws_bill_customer_sk", I64), fcol("d_year", I32)],
                [fcol("pc", I64), fcol("ny", I32)],
                out=Schema(tuple(yearly.output.fields) +
                           tuple(prev.output.fields)))
    up = ffilter(grown, fcall("GreaterThan", fcol("spend", F64),
                              fcol("prev_spend", F64)))
    total = two_phase_agg(
        up, grouping=[fcol("d_year", I32)],
        group_fields=[Field("d_year", I32)],
        aggs=[("n_grown", agg("Count", None, I64), Field("n_grown", I64))])
    return take_ordered(
        total, orders=[so(fcol("d_year", I32))], limit=10,
        project=[fcol("d_year", I32), fcol("n_grown", I64)],
        out=Schema((Field("d_year", I32), Field("n_grown", I64))))


@_q("q67r")
def q67r(cat: Catalog) -> ForeignNode:
    """q67 family: top revenue rows per category via a rank window over
    a (category, class, moy) rollup."""
    ss = cat.scan("store_sales", ["ss_item_sk", "ss_sold_date_sk",
                                  "ss_ext_sales_price"])
    dd = cat.scan("date_dim", ["d_date_sk", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_category", "i_class"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    pre = fproject(
        j2, [fcol("i_category", STR), fcol("i_class", STR),
             fcol("d_moy", I32), fcol("ss_ext_sales_price", F64)],
        Schema((Field("i_category", STR), Field("i_class", STR),
                Field("d_moy", I32), Field("ss_ext_sales_price", F64))))
    expand_out = Schema(tuple(pre.output.fields) +
                        (Field("spark_grouping_id", I64),))
    expand = ForeignNode(
        "ExpandExec", children=(pre,), output=expand_out,
        attrs={"projections": [
            [fcol("i_category", STR), fcol("i_class", STR),
             fcol("d_moy", I32), fcol("ss_ext_sales_price", F64),
             flit(0, I64)],
            [fcol("i_category", STR), fcol("i_class", STR),
             flit(None, I32), fcol("ss_ext_sales_price", F64),
             flit(1, I64)],
            [fcol("i_category", STR), flit(None, STR), flit(None, I32),
             fcol("ss_ext_sales_price", F64), flit(3, I64)]]})
    grouped = two_phase_agg(
        expand,
        grouping=[fcol("i_category", STR), fcol("i_class", STR),
                  fcol("d_moy", I32), fcol("spark_grouping_id", I64)],
        group_fields=[Field("i_category", STR), Field("i_class", STR),
                      Field("d_moy", I32),
                      Field("spark_grouping_id", I64)],
        aggs=[("rev", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("rev", F64))])
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,),
        output=grouped.output,
        attrs={"partitioning": {
            "mode": "hash", "num_partitions": 4,
            "expressions": [fcol("i_category", STR)]}})
    win_out = Schema(tuple(grouped.output.fields) + (Field("rk", I64),))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "rk", "fn": "rank", "args": [],
                    "dtype": I64}],
               "partition_spec": [fcol("i_category", STR)],
               "order_spec": [so(fcol("rev", F64), asc=False)]})
    top = ffilter(win, fcall("LessThanOrEqual", fcol("rk", I64),
                             flit(5)))
    return take_ordered(
        top,
        orders=[so(fcol("i_category", STR), nulls_first=True),
                so(fcol("rk", I64)),
                so(fcol("i_class", STR), nulls_first=True),
                so(fcol("d_moy", I32), nulls_first=True)],
        limit=100,
        project=[fcol("i_category", STR), fcol("i_class", STR),
                 fcol("d_moy", I32), fcol("spark_grouping_id", I64),
                 fcol("rev", F64), fcol("rk", I64)],
        out=Schema((Field("i_category", STR), Field("i_class", STR),
                    Field("d_moy", I32), Field("spark_grouping_id", I64),
                    Field("rev", F64), Field("rk", I64))))


@_q("q70r")
def q70r(cat: Catalog) -> ForeignNode:
    """q70 family: state profit rollup ranked by a whole-rollup-level
    rank window."""
    ss = cat.scan("store_sales", ["ss_store_sk", "ss_net_profit"])
    st = cat.scan("store", ["s_store_sk", "s_state"])
    j = bhj(ss, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    pre = fproject(
        j, [fcol("s_state", STR), fcol("ss_net_profit", F64)],
        Schema((Field("s_state", STR), Field("ss_net_profit", F64))))
    expand_out = Schema(tuple(pre.output.fields) +
                        (Field("spark_grouping_id", I64),))
    expand = ForeignNode(
        "ExpandExec", children=(pre,), output=expand_out,
        attrs={"projections": [
            [fcol("s_state", STR), fcol("ss_net_profit", F64),
             flit(0, I64)],
            [flit(None, STR), fcol("ss_net_profit", F64),
             flit(1, I64)]]})
    grouped = two_phase_agg(
        expand,
        grouping=[fcol("s_state", STR), fcol("spark_grouping_id", I64)],
        group_fields=[Field("s_state", STR),
                      Field("spark_grouping_id", I64)],
        aggs=[("profit", agg("Sum", fcol("ss_net_profit", F64), F64),
               Field("profit", F64))])
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,),
        output=grouped.output,
        attrs={"partitioning": {
            "mode": "hash", "num_partitions": 4,
            "expressions": [fcol("spark_grouping_id", I64)]}})
    win_out = Schema(tuple(grouped.output.fields) +
                     (Field("rank_in_level", I64),))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "rank_in_level", "fn": "rank", "args": [],
                    "dtype": I64}],
               "partition_spec": [fcol("spark_grouping_id", I64)],
               "order_spec": [so(fcol("profit", F64), asc=False)]})
    return take_ordered(
        win,
        orders=[so(fcol("spark_grouping_id", I64)),
                so(fcol("rank_in_level", I64)),
                so(fcol("s_state", STR), nulls_first=True)],
        limit=100,
        project=[fcol("s_state", STR), fcol("spark_grouping_id", I64),
                 fcol("profit", F64), fcol("rank_in_level", I64)],
        out=win_out)


@_q("q88c")
def q88c(cat: Catalog) -> ForeignNode:
    """q88 family: one row of global band counts (nested CASE flags
    summed)."""
    ss = cat.scan("store_sales", ["ss_quantity", "ss_sales_price"])
    def flag(cond):
        return fcall("CaseWhen", cond, flit(1, I64), flit(0, I64),
                     dtype=I64)
    marked = fproject(
        ss, [falias(flag(fcall("LessThanOrEqual",
                               fcol("ss_quantity", I32), flit(20))),
                    "b1"),
             falias(flag(fcall("And",
                               fcall("GreaterThan",
                                     fcol("ss_quantity", I32), flit(20)),
                               fcall("LessThanOrEqual",
                                     fcol("ss_quantity", I32),
                                     flit(60)))), "b2"),
             falias(flag(fcall("GreaterThan", fcol("ss_quantity", I32),
                               flit(60))), "b3")],
        Schema((Field("b1", I64), Field("b2", I64), Field("b3", I64))))
    return two_phase_agg(
        marked, grouping=[], group_fields=[],
        aggs=[("n1", agg("Sum", fcol("b1", I64), I64), Field("n1", I64)),
              ("n2", agg("Sum", fcol("b2", I64), I64), Field("n2", I64)),
              ("n3", agg("Sum", fcol("b3", I64), I64), Field("n3", I64))])


@_q("q44r")
def q44r(cat: Catalog) -> ForeignNode:
    """q44 family: best and worst items by average profit via two rank
    windows joined on rank."""
    base = two_phase_agg(
        cat.scan("store_sales", ["ss_item_sk", "ss_net_profit"]),
        grouping=[fcol("ss_item_sk", I64)],
        group_fields=[Field("ss_item_sk", I64)],
        aggs=[("avg_profit", agg("Average", fcol("ss_net_profit", F64),
                                 F64),
               Field("avg_profit", F64))])

    def ranked(src, name, asc):
        single = ForeignNode(
            "ShuffleExchangeExec", children=(src,), output=src.output,
            attrs={"partitioning": {"mode": "single",
                                    "num_partitions": 1}})
        win_out = Schema(tuple(src.output.fields) + (Field(name, I64),))
        return ForeignNode(
            "WindowExec", children=(single,), output=win_out,
            attrs={"window_exprs": [
                       {"name": name, "fn": "row_number", "args": [],
                        "dtype": I64}],
                   "partition_spec": [],
                   "order_spec": [so(fcol("avg_profit", F64), asc=asc)]})

    best = fproject(
        ranked(base, "rk", False),
        [falias(fcol("ss_item_sk", I64), "best_item"), fcol("rk", I64)],
        Schema((Field("best_item", I64), Field("rk", I64))))
    worst = fproject(
        ranked(base, "wrk", True),
        [falias(fcol("ss_item_sk", I64), "worst_item"),
         fcol("wrk", I64)],
        Schema((Field("worst_item", I64), Field("wrk", I64))))
    best10 = ffilter(best, fcall("LessThanOrEqual", fcol("rk", I64),
                                 flit(10)))
    worst10 = ffilter(worst, fcall("LessThanOrEqual", fcol("wrk", I64),
                                   flit(10)))
    j = smj(best10, worst10, [fcol("rk", I64)], [fcol("wrk", I64)],
            out=Schema(tuple(best10.output.fields) +
                       tuple(worst10.output.fields)))
    return take_ordered(
        j, orders=[so(fcol("rk", I64))], limit=10,
        project=[fcol("rk", I64), fcol("best_item", I64),
                 fcol("worst_item", I64)],
        out=Schema((Field("rk", I64), Field("best_item", I64),
                    Field("worst_item", I64))))


@_q("q59w")
def q59w(cat: Catalog) -> ForeignNode:
    """q59 family: store weekly revenue by day name pivoted via CASE
    sums."""
    ss = cat.scan("store_sales", ["ss_store_sk", "ss_sold_date_sk",
                                  "ss_ext_sales_price"])
    dd = cat.scan("date_dim", ["d_date_sk", "d_day_name"])
    j = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))

    def day_rev(day, out):
        return falias(
            fcall("CaseWhen",
                  fcall("EqualTo", fcol("d_day_name", STR),
                        flit(day, STR)),
                  fcol("ss_ext_sales_price", F64), flit(0.0, F64),
                  dtype=F64), out)
    pre = fproject(
        j, [fcol("ss_store_sk", I64), day_rev("Monday", "mon"),
            day_rev("Friday", "fri"), day_rev("Sunday", "sun")],
        Schema((Field("ss_store_sk", I64), Field("mon", F64),
                Field("fri", F64), Field("sun", F64))))
    grouped = two_phase_agg(
        pre, grouping=[fcol("ss_store_sk", I64)],
        group_fields=[Field("ss_store_sk", I64)],
        aggs=[("mon_rev", agg("Sum", fcol("mon", F64), F64),
               Field("mon_rev", F64)),
              ("fri_rev", agg("Sum", fcol("fri", F64), F64),
               Field("fri_rev", F64)),
              ("sun_rev", agg("Sum", fcol("sun", F64), F64),
               Field("sun_rev", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("ss_store_sk", I64))], limit=100,
        project=[fcol("ss_store_sk", I64), fcol("mon_rev", F64),
                 fcol("fri_rev", F64), fcol("sun_rev", F64)],
        out=Schema((Field("ss_store_sk", I64), Field("mon_rev", F64),
                    Field("fri_rev", F64), Field("sun_rev", F64))))


# ---------------------------------------------------------------------------
# cross-channel growth, exists-profiles, discount and return-ratio families
# ---------------------------------------------------------------------------

@_q("q04y")
def q04y(cat: Catalog) -> ForeignNode:
    """q04 family: customers whose store spend grew faster than their
    web spend year-over-year (two per-channel growth branches joined)."""
    def yearly(table, prefix, cust_col, out):
        sc = cat.scan(table, [cust_col, f"{prefix}_sold_date_sk",
                              f"{prefix}_ext_sales_price"])
        dd = cat.scan("date_dim", ["d_date_sk", "d_year"])
        j = bhj(sc, dd, fcol(f"{prefix}_sold_date_sk", I64),
                fcol("d_date_sk", I64))
        g = two_phase_agg(
            j, grouping=[fcol(cust_col, I64), fcol("d_year", I32)],
            group_fields=[Field(cust_col, I64), Field("d_year", I32)],
            aggs=[(out, agg("Sum", fcol(f"{prefix}_ext_sales_price",
                                        F64), F64),
                   Field(out, F64))])
        return g, cust_col
    ssy, ss_c = yearly("store_sales", "ss", "ss_customer_sk", "s_spend")
    wsy, ws_c = yearly("web_sales", "ws", "ws_bill_customer_sk",
                       "w_spend")
    # right side's (cust, year) renamed via projection to avoid
    # duplicate column names
    wsy_renamed = fproject(
        wsy, [falias(fcol(ws_c, I64), "wc"),
              falias(fcol("d_year", I32), "wyear"),
              fcol("w_spend", F64)],
        Schema((Field("wc", I64), Field("wyear", I32),
                Field("w_spend", F64))))
    both = smj(ssy, wsy_renamed,
               [fcol(ss_c, I64), fcol("d_year", I32)],
               [fcol("wc", I64), fcol("wyear", I32)],
               out=Schema(tuple(ssy.output.fields) +
                          tuple(wsy_renamed.output.fields)))
    fast = ffilter(both, fcall("GreaterThan", fcol("s_spend", F64),
                               fcol("w_spend", F64)))
    total = two_phase_agg(
        fast, grouping=[fcol("d_year", I32)],
        group_fields=[Field("d_year", I32)],
        aggs=[("n", agg("Count", None, I64), Field("n", I64))])
    return take_ordered(
        total, orders=[so(fcol("d_year", I32))], limit=10,
        project=[fcol("d_year", I32), fcol("n", I64)],
        out=Schema((Field("d_year", I32), Field("n", I64))))


@_q("q10x")
def q10x(cat: Catalog) -> ForeignNode:
    """q10 family: customer counts by birth country for customers active
    on BOTH catalog and web channels (two LeftSemi restrictions)."""
    cu = cat.scan("customer", ["c_customer_sk", "c_birth_country"])
    cs = cat.scan("catalog_sales", ["cs_bill_customer_sk"])
    ws = cat.scan("web_sales", ["ws_bill_customer_sk"])
    on_cs = smj(cu, cs, [fcol("c_customer_sk", I64)],
                [fcol("cs_bill_customer_sk", I64)], join_type="LeftSemi")
    on_both = smj(on_cs, ws, [fcol("c_customer_sk", I64)],
                  [fcol("ws_bill_customer_sk", I64)],
                  join_type="LeftSemi")
    grouped = two_phase_agg(
        on_both, grouping=[fcol("c_birth_country", STR)],
        group_fields=[Field("c_birth_country", STR)],
        aggs=[("cnt", agg("Count", None, I64), Field("cnt", I64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("cnt", I64), asc=False),
                so(fcol("c_birth_country", STR))],
        limit=100,
        project=[fcol("c_birth_country", STR), fcol("cnt", I64)],
        out=Schema((Field("c_birth_country", STR), Field("cnt", I64))))


@_q("q28b")
def q28b(cat: Catalog) -> ForeignNode:
    """q28 family: one row of per-band average prices over three
    quantity bands (CASE-masked averages)."""
    ss = cat.scan("store_sales", ["ss_quantity", "ss_sales_price"])
    def band_price(lo, hi, out):
        cond = fcall("And",
                     fcall("GreaterThan", fcol("ss_quantity", I32),
                           flit(lo)),
                     fcall("LessThanOrEqual", fcol("ss_quantity", I32),
                           flit(hi)))
        return falias(fcall("CaseWhen", cond,
                            fcol("ss_sales_price", F64),
                            flit(None, F64), dtype=F64), out)
    pre = fproject(
        ss, [band_price(0, 25, "p1"), band_price(25, 60, "p2"),
             band_price(60, 100, "p3")],
        Schema((Field("p1", F64), Field("p2", F64), Field("p3", F64))))
    return two_phase_agg(
        pre, grouping=[], group_fields=[],
        aggs=[("avg1", agg("Average", fcol("p1", F64), F64),
               Field("avg1", F64)),
              ("avg2", agg("Average", fcol("p2", F64), F64),
               Field("avg2", F64)),
              ("avg3", agg("Average", fcol("p3", F64), F64),
               Field("avg3", F64))])


@_q("q32e")
def q32e(cat: Catalog) -> ForeignNode:
    """q32/q92 family on catalog: excess-discount — revenue of sales
    beating 1.3x their item's average (aggregate self-join)."""
    cs = cat.scan("catalog_sales", ["cs_item_sk", "cs_ext_sales_price"])
    avg_by_item = two_phase_agg(
        cat.scan("catalog_sales", ["cs_item_sk", "cs_ext_sales_price"]),
        grouping=[fcol("cs_item_sk", I64)],
        group_fields=[Field("cs_item_sk", I64)],
        aggs=[("avg_price", agg("Average", fcol("cs_ext_sales_price",
                                                F64), F64),
               Field("avg_price", F64))])
    avg_renamed = fproject(
        avg_by_item, [falias(fcol("cs_item_sk", I64), "ai"),
                      fcol("avg_price", F64)],
        Schema((Field("ai", I64), Field("avg_price", F64))))
    j = smj(cs, avg_renamed, [fcol("cs_item_sk", I64)],
            [fcol("ai", I64)],
            out=Schema(tuple(cs.output.fields) +
                       tuple(avg_renamed.output.fields)))
    hot = ffilter(j, fcall(
        "GreaterThan", fcol("cs_ext_sales_price", F64),
        fcall("Multiply", flit(1.3, F64), fcol("avg_price", F64),
              dtype=F64)))
    return two_phase_agg(
        hot, grouping=[], group_fields=[],
        aggs=[("excess_rev", agg("Sum", fcol("cs_ext_sales_price", F64),
                                 F64),
               Field("excess_rev", F64)),
              ("n", agg("Count", fcol("cs_ext_sales_price", F64), I64),
               Field("n", I64))])


@_q("q37i")
def q37i(cat: Catalog) -> ForeignNode:
    """q37/q82 family: items in a price band that actually sell on the
    catalog channel (LeftSemi), listed by brand."""
    it = cat.scan("item", ["i_item_sk", "i_brand", "i_current_price"])
    banded = ffilter(it, fcall(
        "And",
        fcall("GreaterThanOrEqual", fcol("i_current_price", F64),
              flit(20.0)),
        fcall("LessThanOrEqual", fcol("i_current_price", F64),
              flit(50.0))))
    cs = cat.scan("catalog_sales", ["cs_item_sk"])
    sold = smj(banded, cs, [fcol("i_item_sk", I64)],
               [fcol("cs_item_sk", I64)], join_type="LeftSemi")
    grouped = two_phase_agg(
        sold, grouping=[fcol("i_brand", STR)],
        group_fields=[Field("i_brand", STR)],
        aggs=[("n_items", agg("Count", None, I64), Field("n_items", I64)),
              ("avg_price", agg("Average", fcol("i_current_price", F64),
                                F64),
               Field("avg_price", F64))])
    return take_ordered(
        grouped, orders=[so(fcol("i_brand", STR))], limit=100,
        project=[fcol("i_brand", STR), fcol("n_items", I64),
                 fcol("avg_price", F64)],
        out=Schema((Field("i_brand", STR), Field("n_items", I64),
                    Field("avg_price", F64))))


@_q("q49r")
def q49r(cat: Catalog) -> ForeignNode:
    """q49 family: worst return ratios — per-item return amount over
    sales, top offenders via a rank window."""
    sold = two_phase_agg(
        cat.scan("store_sales", ["ss_item_sk", "ss_ext_sales_price"]),
        grouping=[fcol("ss_item_sk", I64)],
        group_fields=[Field("ss_item_sk", I64)],
        aggs=[("rev", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("rev", F64))])
    ret = two_phase_agg(
        cat.scan("store_returns", ["sr_item_sk", "sr_return_amt"]),
        grouping=[fcol("sr_item_sk", I64)],
        group_fields=[Field("sr_item_sk", I64)],
        aggs=[("ret_amt", agg("Sum", fcol("sr_return_amt", F64), F64),
               Field("ret_amt", F64))])
    j = smj(ret, sold, [fcol("sr_item_sk", I64)],
            [fcol("ss_item_sk", I64)],
            out=Schema(tuple(ret.output.fields) +
                       tuple(sold.output.fields)))
    ratio = fproject(
        j, [fcol("sr_item_sk", I64), fcol("ret_amt", F64),
            fcol("rev", F64),
            falias(fcall("Divide", fcol("ret_amt", F64),
                         fcol("rev", F64), dtype=F64), "ratio")],
        Schema((Field("sr_item_sk", I64), Field("ret_amt", F64),
                Field("rev", F64), Field("ratio", F64))))
    single = ForeignNode(
        "ShuffleExchangeExec", children=(ratio,), output=ratio.output,
        attrs={"partitioning": {"mode": "single", "num_partitions": 1}})
    win_out = Schema(tuple(ratio.output.fields) + (Field("rk", I64),))
    win = ForeignNode(
        "WindowExec", children=(single,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "rk", "fn": "rank", "args": [], "dtype": I64}],
               "partition_spec": [],
               "order_spec": [so(fcol("ratio", F64), asc=False)]})
    worst = ffilter(win, fcall("LessThanOrEqual", fcol("rk", I64),
                               flit(20)))
    return take_ordered(
        worst, orders=[so(fcol("rk", I64)), so(fcol("sr_item_sk", I64))],
        limit=100,
        project=[fcol("rk", I64), fcol("sr_item_sk", I64),
                 fcol("ratio", F64)],
        out=Schema((Field("rk", I64), Field("sr_item_sk", I64),
                    Field("ratio", F64))))


@_q("q54s")
def q54s(cat: Catalog) -> ForeignNode:
    """q54 family: store revenue from customers acquired on the web or
    catalog channels (union of channel customer sets, LeftSemi)."""
    webc = fproject(
        cat.scan("web_sales", ["ws_bill_customer_sk"]),
        [falias(fcol("ws_bill_customer_sk", I64), "ck")],
        Schema((Field("ck", I64),)))
    catc = fproject(
        cat.scan("catalog_sales", ["cs_bill_customer_sk"]),
        [falias(fcol("cs_bill_customer_sk", I64), "ck")],
        Schema((Field("ck", I64),)))
    un = ForeignNode("UnionExec", children=(webc, catc),
                     output=Schema((Field("ck", I64),)))
    acquirers = two_phase_agg(
        un, grouping=[fcol("ck", I64)],
        group_fields=[Field("ck", I64)],
        aggs=[("n", agg("Count", None, I64), Field("n", I64))])
    ss = cat.scan("store_sales", ["ss_customer_sk",
                                  "ss_ext_sales_price"])
    sel = smj(ss, acquirers, [fcol("ss_customer_sk", I64)],
              [fcol("ck", I64)], join_type="LeftSemi")
    return two_phase_agg(
        sel, grouping=[], group_fields=[],
        aggs=[("rev", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("rev", F64)),
              ("n", agg("Count", fcol("ss_ext_sales_price", F64), I64),
               Field("n", I64))])


@_q("q72p")
def q72p(cat: Catalog) -> ForeignNode:
    """q72 family: store sales LEFT OUTER promotion — promo vs no-promo
    revenue split."""
    ss = cat.scan("store_sales", ["ss_promo_sk", "ss_ext_sales_price"])
    pr = cat.scan("promotion", ["p_promo_sk", "p_channel_event"])
    pr_y = ffilter(pr, fcall("EqualTo", fcol("p_channel_event", STR),
                             flit("Y", STR)))
    j = bhj(ss, pr_y, fcol("ss_promo_sk", I64), fcol("p_promo_sk", I64),
            join_type="LeftOuter")
    marked = fproject(
        j, [falias(fcall("CaseWhen",
                         fcall("IsNotNull", fcol("p_channel_event", STR)),
                         flit("promo", STR), flit("no promo", STR),
                         dtype=STR), "bucket"),
            fcol("ss_ext_sales_price", F64)],
        Schema((Field("bucket", STR), Field("ss_ext_sales_price", F64))))
    grouped = two_phase_agg(
        marked, grouping=[fcol("bucket", STR)],
        group_fields=[Field("bucket", STR)],
        aggs=[("rev", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("rev", F64)),
              ("n", agg("Count", fcol("ss_ext_sales_price", F64), I64),
               Field("n", I64))])
    return take_ordered(
        grouped, orders=[so(fcol("bucket", STR))], limit=10,
        project=[fcol("bucket", STR), fcol("rev", F64), fcol("n", I64)],
        out=Schema((Field("bucket", STR), Field("rev", F64),
                    Field("n", I64))))


@_q("q81r")
def q81r(cat: Catalog) -> ForeignNode:
    """q81/q30 family: customers whose returns exceed 1.2x their state's
    average return (agg self-join on state)."""
    ret = cat.scan("store_returns", ["sr_customer_sk", "sr_return_amt"])
    cu = cat.scan("customer", ["c_customer_sk", "c_current_addr_sk"])
    ca = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    j1 = bhj(ret, cu, fcol("sr_customer_sk", I64),
             fcol("c_customer_sk", I64))
    j2 = bhj(j1, ca, fcol("c_current_addr_sk", I64),
             fcol("ca_address_sk", I64))
    per_cust = two_phase_agg(
        j2, grouping=[fcol("sr_customer_sk", I64), fcol("ca_state", STR)],
        group_fields=[Field("sr_customer_sk", I64),
                      Field("ca_state", STR)],
        aggs=[("amt", agg("Sum", fcol("sr_return_amt", F64), F64),
               Field("amt", F64))])
    by_state = two_phase_agg(
        per_cust, grouping=[fcol("ca_state", STR)],
        group_fields=[Field("ca_state", STR)],
        aggs=[("state_avg", agg("Average", fcol("amt", F64), F64),
               Field("state_avg", F64))])
    by_state_r = fproject(
        by_state, [falias(fcol("ca_state", STR), "st"),
                   fcol("state_avg", F64)],
        Schema((Field("st", STR), Field("state_avg", F64))))
    j3 = smj(per_cust, by_state_r, [fcol("ca_state", STR)],
             [fcol("st", STR)],
             out=Schema(tuple(per_cust.output.fields) +
                        tuple(by_state_r.output.fields)))
    heavy = ffilter(j3, fcall(
        "GreaterThan", fcol("amt", F64),
        fcall("Multiply", flit(1.2, F64), fcol("state_avg", F64),
              dtype=F64)))
    return take_ordered(
        heavy,
        orders=[so(fcol("amt", F64), asc=False),
                so(fcol("sr_customer_sk", I64))],
        limit=100,
        project=[fcol("sr_customer_sk", I64), fcol("ca_state", STR),
                 fcol("amt", F64), fcol("state_avg", F64)],
        out=Schema((Field("sr_customer_sk", I64), Field("ca_state", STR),
                    Field("amt", F64), Field("state_avg", F64))))


@_q("q41d")
def q41d(cat: Catalog) -> ForeignNode:
    """q41 family: distinct brand/class combinations in a price band
    (dedup via group-by)."""
    it = cat.scan("item", ["i_brand", "i_class", "i_current_price"])
    banded = ffilter(it, fcall(
        "And",
        fcall("GreaterThanOrEqual", fcol("i_current_price", F64),
              flit(30.0)),
        fcall("LessThanOrEqual", fcol("i_current_price", F64),
              flit(70.0))))
    distinct = two_phase_agg(
        banded, grouping=[fcol("i_brand", STR), fcol("i_class", STR)],
        group_fields=[Field("i_brand", STR), Field("i_class", STR)],
        aggs=[("n", agg("Count", None, I64), Field("n", I64))])
    return take_ordered(
        distinct,
        orders=[so(fcol("i_brand", STR)), so(fcol("i_class", STR))],
        limit=100,
        project=[fcol("i_brand", STR), fcol("i_class", STR)],
        out=Schema((Field("i_brand", STR), Field("i_class", STR))))


# ---------------------------------------------------------------------------
# inventory / warehouse / ship-lag / demographics families
# (tpcds-queries/q21,q39,q40,q46,q62,q73,q82,q99)
# ---------------------------------------------------------------------------

_INV_PIVOT = 2450815 + 1000     # mid-window d_date_sk pivot


def _case(cond: ForeignExpr, then: ForeignExpr, other: ForeignExpr,
          dtype: DataType) -> ForeignExpr:
    return fcall("CaseWhen", cond, then, other, dtype=dtype)


@_q("q21i")
def q21i(cat: Catalog) -> ForeignNode:
    """q21 family: per warehouse x item, inventory held before vs after a
    pivot date inside a 60-day window, kept when the ratio stays within
    [2/3, 3/2]."""
    inv = cat.scan("inventory", ["inv_date_sk", "inv_item_sk",
                                 "inv_warehouse_sk",
                                 "inv_quantity_on_hand"])
    wh = cat.scan("warehouse", ["w_warehouse_sk", "w_warehouse_name"])
    it = cat.scan("item", ["i_item_sk", "i_item_id", "i_current_price"])
    it = ffilter(it, fcall(
        "And",
        fcall("GreaterThanOrEqual", fcol("i_current_price", F64),
              flit(0.99)),
        fcall("LessThanOrEqual", fcol("i_current_price", F64),
              flit(80.0))))
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("GreaterThanOrEqual", fcol("d_date_sk", I64),
                    flit(_INV_PIVOT - 30)),
              fcall("LessThanOrEqual", fcol("d_date_sk", I64),
                    flit(_INV_PIVOT + 30))),
        ["d_date_sk"])
    j1 = bhj(inv, wh, fcol("inv_warehouse_sk", I64),
             fcol("w_warehouse_sk", I64))
    j2 = bhj(j1, it, fcol("inv_item_sk", I64), fcol("i_item_sk", I64))
    j3 = bhj(j2, dd, fcol("inv_date_sk", I64), fcol("d_date_sk", I64))
    qty = fcall("Cast", fcol("inv_quantity_on_hand", I32), dtype=F64)
    before = _case(fcall("LessThan", fcol("inv_date_sk", I64),
                         flit(_INV_PIVOT)), qty, flit(0.0), F64)
    after = _case(fcall("GreaterThanOrEqual", fcol("inv_date_sk", I64),
                        flit(_INV_PIVOT)), qty, flit(0.0), F64)
    grouped = two_phase_agg(
        j3,
        grouping=[fcol("w_warehouse_name", STR), fcol("i_item_id", STR)],
        group_fields=[Field("w_warehouse_name", STR),
                      Field("i_item_id", STR)],
        aggs=[("inv_before", agg("Sum", before, F64),
               Field("inv_before", F64)),
              ("inv_after", agg("Sum", after, F64),
               Field("inv_after", F64))])
    ratio = fcall("Divide", fcol("inv_after", F64),
                  fcol("inv_before", F64))
    kept = ffilter(grouped, fcall(
        "And",
        fcall("GreaterThanOrEqual", ratio, flit(2.0 / 3.0)),
        fcall("LessThanOrEqual", ratio, flit(3.0 / 2.0))))
    out = Schema((Field("w_warehouse_name", STR), Field("i_item_id", STR),
                  Field("inv_before", F64), Field("inv_after", F64)))
    return take_ordered(
        kept,
        orders=[so(fcol("w_warehouse_name", STR)),
                so(fcol("i_item_id", STR))],
        limit=100,
        project=[fcol("w_warehouse_name", STR), fcol("i_item_id", STR),
                 fcol("inv_before", F64), fcol("inv_after", F64)],
        out=out)


@_q("q39v")
def q39v(cat: Catalog) -> ForeignNode:
    """q39 family: monthly inventory mean/stddev per item x warehouse for
    two consecutive months, self-joined on (warehouse, item) — the
    StddevSamp-bearing query."""
    def month_stats(moy: int, suffix: str) -> ForeignNode:
        inv = cat.scan("inventory", ["inv_date_sk", "inv_item_sk",
                                     "inv_warehouse_sk",
                                     "inv_quantity_on_hand"])
        dd = _dim_date(
            cat,
            fcall("And",
                  fcall("EqualTo", fcol("d_moy", I32), flit(moy)),
                  fcall("EqualTo", fcol("d_year", I32), flit(2000))),
            ["d_date_sk", "d_moy", "d_year"])
        j = bhj(inv, dd, fcol("inv_date_sk", I64), fcol("d_date_sk", I64))
        qty = fcall("Cast", fcol("inv_quantity_on_hand", I32), dtype=F64)
        grouped = two_phase_agg(
            j,
            grouping=[fcol("inv_warehouse_sk", I64),
                      fcol("inv_item_sk", I64)],
            group_fields=[Field("inv_warehouse_sk", I64),
                          Field("inv_item_sk", I64)],
            aggs=[("mean", agg("Average", qty, F64), Field("mean", F64)),
                  ("sdev", agg("StddevSamp", qty, F64),
                   Field("sdev", F64))])
        out = Schema((Field(f"w{suffix}", I64), Field(f"i{suffix}", I64),
                      Field(f"mean{suffix}", F64),
                      Field(f"sdev{suffix}", F64)))
        renamed = fproject(
            grouped,
            [falias(fcol("inv_warehouse_sk", I64), f"w{suffix}"),
             falias(fcol("inv_item_sk", I64), f"i{suffix}"),
             falias(fcol("mean", F64), f"mean{suffix}"),
             falias(fcol("sdev", F64), f"sdev{suffix}")],
            out)
        # official q39: keep item-months whose coefficient of variation
        # (stdev/mean) exceeds a threshold; 0.4 keeps the generated
        # uniform-quantity corpus non-empty where the official 1.0 would
        # filter everything
        cov = fcall("Divide", fcol(f"sdev{suffix}", F64),
                    fcol(f"mean{suffix}", F64))
        return ffilter(renamed, fcall("GreaterThan", cov, flit(0.4)))

    m1 = month_stats(1, "1")
    m2 = month_stats(2, "2")
    j = smj(m1, m2, [fcol("w1", I64), fcol("i1", I64)],
            [fcol("w2", I64), fcol("i2", I64)])
    out = Schema((Field("w1", I64), Field("i1", I64),
                  Field("mean1", F64), Field("sdev1", F64),
                  Field("mean2", F64), Field("sdev2", F64)))
    return take_ordered(
        j,
        orders=[so(fcol("w1", I64)), so(fcol("i1", I64)),
                so(fcol("mean1", F64)), so(fcol("mean2", F64))],
        limit=100,
        project=[fcol("w1", I64), fcol("i1", I64), fcol("mean1", F64),
                 fcol("sdev1", F64), fcol("mean2", F64),
                 fcol("sdev2", F64)],
        out=out)


@_q("q40c")
def q40c(cat: Catalog) -> ForeignNode:
    """q40 family: catalog sales net of returns (left-outer SMJ on
    order+item) by warehouse state, split before/after a pivot date."""
    cs = cat.scan("catalog_sales",
                  ["cs_sold_date_sk", "cs_item_sk", "cs_order_number",
                   "cs_warehouse_sk", "cs_sales_price"])
    crt = cat.scan("catalog_returns",
                   ["cr_order_number", "cr_item_sk", "cr_return_amount"])
    j0 = smj(cs, crt,
             [fcol("cs_order_number", I64), fcol("cs_item_sk", I64)],
             [fcol("cr_order_number", I64), fcol("cr_item_sk", I64)],
             join_type="LeftOuter")
    wh = cat.scan("warehouse", ["w_warehouse_sk", "w_state"])
    it = cat.scan("item", ["i_item_sk", "i_item_id", "i_current_price"])
    it = ffilter(it, fcall(
        "And",
        fcall("GreaterThanOrEqual", fcol("i_current_price", F64),
              flit(0.99)),
        fcall("LessThanOrEqual", fcol("i_current_price", F64),
              flit(150.0))))
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("GreaterThanOrEqual", fcol("d_date_sk", I64),
                    flit(_INV_PIVOT - 30)),
              fcall("LessThanOrEqual", fcol("d_date_sk", I64),
                    flit(_INV_PIVOT + 30))),
        ["d_date_sk"])
    j1 = bhj(j0, wh, fcol("cs_warehouse_sk", I64),
             fcol("w_warehouse_sk", I64))
    j2 = bhj(j1, it, fcol("cs_item_sk", I64), fcol("i_item_sk", I64))
    j3 = bhj(j2, dd, fcol("cs_sold_date_sk", I64), fcol("d_date_sk", I64))
    net = fcall("Subtract", fcol("cs_sales_price", F64),
                fcall("Coalesce", fcol("cr_return_amount", F64),
                      flit(0.0), dtype=F64))
    before = _case(fcall("LessThan", fcol("cs_sold_date_sk", I64),
                         flit(_INV_PIVOT)), net, flit(0.0), F64)
    after = _case(fcall("GreaterThanOrEqual", fcol("cs_sold_date_sk", I64),
                        flit(_INV_PIVOT)), net, flit(0.0), F64)
    grouped = two_phase_agg(
        j3,
        grouping=[fcol("w_state", STR), fcol("i_item_id", STR)],
        group_fields=[Field("w_state", STR), Field("i_item_id", STR)],
        aggs=[("sales_before", agg("Sum", before, F64),
               Field("sales_before", F64)),
              ("sales_after", agg("Sum", after, F64),
               Field("sales_after", F64))])
    out = Schema((Field("w_state", STR), Field("i_item_id", STR),
                  Field("sales_before", F64), Field("sales_after", F64)))
    return take_ordered(
        grouped,
        orders=[so(fcol("w_state", STR)), so(fcol("i_item_id", STR))],
        limit=100,
        project=[fcol("w_state", STR), fcol("i_item_id", STR),
                 fcol("sales_before", F64), fcol("sales_after", F64)],
        out=out)


def _ship_lag_buckets(sold: str, ship: str,
                      group_cols, group_fields, cat_scans) -> ForeignNode:
    """Shared q62/q99 shape: join a sales fact to warehouse/ship_mode/
    (site|call_center)/date and histogram ship-lag into 30-day buckets."""
    node = cat_scans
    lag = fcall("Subtract", fcol(ship, I64), fcol(sold, I64))
    one, zero = flit(1), flit(0)

    def bucket(name, cond):
        return (name, agg("Sum", _case(cond, one, zero, I64), I64),
                Field(name, I64))

    grouped = two_phase_agg(
        node, grouping=group_cols, group_fields=group_fields,
        aggs=[bucket("d30", fcall("LessThanOrEqual", lag, flit(30))),
              bucket("d60", fcall("And",
                                  fcall("GreaterThan", lag, flit(30)),
                                  fcall("LessThanOrEqual", lag,
                                        flit(60)))),
              bucket("d90", fcall("And",
                                  fcall("GreaterThan", lag, flit(60)),
                                  fcall("LessThanOrEqual", lag,
                                        flit(90)))),
              bucket("d120", fcall("And",
                                   fcall("GreaterThan", lag, flit(90)),
                                   fcall("LessThanOrEqual", lag,
                                         flit(120)))),
              bucket("dmore", fcall("GreaterThan", lag, flit(120)))])
    out = Schema(tuple(group_fields) +
                 (Field("d30", I64), Field("d60", I64), Field("d90", I64),
                  Field("d120", I64), Field("dmore", I64)))
    return take_ordered(
        grouped,
        orders=[so(fcol(f.name, f.dtype)) for f in group_fields],
        limit=100,
        project=[fcol(f.name, f.dtype) for f in group_fields] +
                [fcol("d30", I64), fcol("d60", I64), fcol("d90", I64),
                 fcol("d120", I64), fcol("dmore", I64)],
        out=out)


@_q("q62w")
def q62w(cat: Catalog) -> ForeignNode:
    """q62 family: web-sales ship-lag histogram by warehouse x ship mode x
    web site."""
    ws = cat.scan("web_sales",
                  ["ws_sold_date_sk", "ws_ship_date_sk", "ws_warehouse_sk",
                   "ws_ship_mode_sk", "ws_web_site_sk"])
    wh = cat.scan("warehouse", ["w_warehouse_sk", "w_warehouse_name"])
    sm = cat.scan("ship_mode", ["sm_ship_mode_sk", "sm_type"])
    web = cat.scan("web_site", ["web_site_sk", "web_name"])
    dd = _dim_date(cat, fcall("EqualTo", fcol("d_year", I32), flit(2000)),
                   ["d_date_sk", "d_year"])
    j1 = bhj(ws, wh, fcol("ws_warehouse_sk", I64),
             fcol("w_warehouse_sk", I64))
    j2 = bhj(j1, sm, fcol("ws_ship_mode_sk", I64),
             fcol("sm_ship_mode_sk", I64))
    j3 = bhj(j2, web, fcol("ws_web_site_sk", I64), fcol("web_site_sk", I64))
    j4 = bhj(j3, dd, fcol("ws_ship_date_sk", I64), fcol("d_date_sk", I64))
    return _ship_lag_buckets(
        "ws_sold_date_sk", "ws_ship_date_sk",
        [fcol("w_warehouse_name", STR), fcol("sm_type", STR),
         fcol("web_name", STR)],
        [Field("w_warehouse_name", STR), Field("sm_type", STR),
         Field("web_name", STR)],
        j4)


@_q("q99c")
def q99c(cat: Catalog) -> ForeignNode:
    """q99 family: catalog-sales ship-lag histogram by warehouse x ship
    mode x call center."""
    cs = cat.scan("catalog_sales",
                  ["cs_sold_date_sk", "cs_ship_date_sk", "cs_warehouse_sk",
                   "cs_ship_mode_sk", "cs_call_center_sk"])
    wh = cat.scan("warehouse", ["w_warehouse_sk", "w_warehouse_name"])
    sm = cat.scan("ship_mode", ["sm_ship_mode_sk", "sm_type"])
    cc = cat.scan("call_center", ["cc_call_center_sk", "cc_name"])
    dd = _dim_date(cat, fcall("EqualTo", fcol("d_year", I32), flit(2000)),
                   ["d_date_sk", "d_year"])
    j1 = bhj(cs, wh, fcol("cs_warehouse_sk", I64),
             fcol("w_warehouse_sk", I64))
    j2 = bhj(j1, sm, fcol("cs_ship_mode_sk", I64),
             fcol("sm_ship_mode_sk", I64))
    j3 = bhj(j2, cc, fcol("cs_call_center_sk", I64),
             fcol("cc_call_center_sk", I64))
    j4 = bhj(j3, dd, fcol("cs_ship_date_sk", I64), fcol("d_date_sk", I64))
    return _ship_lag_buckets(
        "cs_sold_date_sk", "cs_ship_date_sk",
        [fcol("w_warehouse_name", STR), fcol("sm_type", STR),
         fcol("cc_name", STR)],
        [Field("w_warehouse_name", STR), Field("sm_type", STR),
         Field("cc_name", STR)],
        j4)


@_q("q73h")
def q73h(cat: Catalog) -> ForeignNode:
    """q73 family: tickets with 1-5 line items bought by high-potential
    households, joined back to the customer."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_store_sk", "ss_hdemo_sk",
                   "ss_customer_sk", "ss_ticket_number"])
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("GreaterThanOrEqual", fcol("d_dom", I32), flit(1)),
              fcall("LessThanOrEqual", fcol("d_dom", I32), flit(2))),
        ["d_date_sk", "d_dom"])
    st = cat.scan("store", ["s_store_sk", "s_state"])
    hd = cat.scan("household_demographics",
                  ["hd_demo_sk", "hd_buy_potential", "hd_vehicle_count"])
    hd = ffilter(hd, fcall(
        "And",
        fcall("In", fcol("hd_buy_potential", STR), flit(">10000"),
              flit("Unknown")),
        fcall("GreaterThan", fcol("hd_vehicle_count", I32), flit(0))))
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    j3 = bhj(j2, hd, fcol("ss_hdemo_sk", I64), fcol("hd_demo_sk", I64))
    grouped = two_phase_agg(
        j3,
        grouping=[fcol("ss_ticket_number", I64),
                  fcol("ss_customer_sk", I64)],
        group_fields=[Field("ss_ticket_number", I64),
                      Field("ss_customer_sk", I64)],
        aggs=[("cnt", agg("Count", None, I64), Field("cnt", I64))])
    sized = ffilter(grouped, fcall(
        "And",
        fcall("GreaterThanOrEqual", fcol("cnt", I64), flit(1)),
        fcall("LessThanOrEqual", fcol("cnt", I64), flit(5))))
    cu = cat.scan("customer", ["c_customer_sk", "c_customer_id"])
    j4 = bhj(sized, cu, fcol("ss_customer_sk", I64),
             fcol("c_customer_sk", I64))
    out = Schema((Field("c_customer_id", STR),
                  Field("ss_ticket_number", I64), Field("cnt", I64)))
    return take_ordered(
        j4,
        orders=[so(fcol("cnt", I64), asc=False),
                so(fcol("c_customer_id", STR)),
                so(fcol("ss_ticket_number", I64))],
        limit=100,
        project=[fcol("c_customer_id", STR),
                 fcol("ss_ticket_number", I64), fcol("cnt", I64)],
        out=out)


@_q("q46s")
def q46s(cat: Catalog) -> ForeignNode:
    """q46 family: weekend sales by dependent-heavy households where the
    bought-at address state differs from the customer's current state
    (double customer_address join with aliasing)."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_store_sk", "ss_hdemo_sk",
                   "ss_addr_sk", "ss_customer_sk", "ss_ticket_number",
                   "ss_ext_sales_price"])
    dd = _dim_date(cat, fcall("In", fcol("d_day_name", STR),
                              flit("Friday"), flit("Saturday"),
                              flit("Sunday")),
                   ["d_date_sk", "d_day_name"])
    hd = cat.scan("household_demographics",
                  ["hd_demo_sk", "hd_dep_count", "hd_vehicle_count"])
    hd = ffilter(hd, fcall(
        "Or",
        fcall("EqualTo", fcol("hd_dep_count", I32), flit(4)),
        fcall("EqualTo", fcol("hd_vehicle_count", I32), flit(3))))
    ca1 = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, hd, fcol("ss_hdemo_sk", I64), fcol("hd_demo_sk", I64))
    j3 = bhj(j2, ca1, fcol("ss_addr_sk", I64), fcol("ca_address_sk", I64))
    bought = fproject(
        j3,
        [fcol("ss_customer_sk", I64), fcol("ss_ticket_number", I64),
         fcol("ss_ext_sales_price", F64),
         falias(fcol("ca_state", STR), "bought_state")],
        Schema((Field("ss_customer_sk", I64),
                Field("ss_ticket_number", I64),
                Field("ss_ext_sales_price", F64),
                Field("bought_state", STR))))
    grouped = two_phase_agg(
        bought,
        grouping=[fcol("ss_ticket_number", I64),
                  fcol("ss_customer_sk", I64),
                  fcol("bought_state", STR)],
        group_fields=[Field("ss_ticket_number", I64),
                      Field("ss_customer_sk", I64),
                      Field("bought_state", STR)],
        aggs=[("amt", agg("Sum", fcol("ss_ext_sales_price", F64), F64),
               Field("amt", F64))])
    cu = cat.scan("customer", ["c_customer_sk", "c_customer_id",
                               "c_current_addr_sk"])
    ca2 = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    j4 = bhj(grouped, cu, fcol("ss_customer_sk", I64),
             fcol("c_customer_sk", I64))
    j5 = bhj(j4, ca2, fcol("c_current_addr_sk", I64),
             fcol("ca_address_sk", I64))
    moved = ffilter(j5, fcall(
        "Not", fcall("EqualTo", fcol("bought_state", STR),
                     fcol("ca_state", STR))))
    out = Schema((Field("c_customer_id", STR),
                  Field("bought_state", STR), Field("ca_state", STR),
                  Field("amt", F64)))
    return take_ordered(
        moved,
        orders=[so(fcol("c_customer_id", STR)),
                so(fcol("amt", F64), asc=False),
                so(fcol("bought_state", STR))],
        limit=100,
        project=[fcol("c_customer_id", STR), fcol("bought_state", STR),
                 fcol("ca_state", STR), fcol("amt", F64)],
        out=out)


@_q("q82i")
def q82i(cat: Catalog) -> ForeignNode:
    """q82 family: items in a price band with mid-range inventory that
    actually sold, deduped via group-by."""
    it = cat.scan("item", ["i_item_sk", "i_item_id", "i_class",
                           "i_current_price"])
    it = ffilter(it, fcall(
        "And",
        fcall("GreaterThanOrEqual", fcol("i_current_price", F64),
              flit(20.0)),
        fcall("LessThanOrEqual", fcol("i_current_price", F64),
              flit(50.0))))
    inv = cat.scan("inventory", ["inv_date_sk", "inv_item_sk",
                                 "inv_quantity_on_hand"])
    inv = ffilter(inv, fcall(
        "And",
        fcall("GreaterThanOrEqual", fcol("inv_quantity_on_hand", I32),
              flit(100)),
        fcall("LessThanOrEqual", fcol("inv_quantity_on_hand", I32),
              flit(500))))
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("GreaterThanOrEqual", fcol("d_date_sk", I64),
                    flit(_INV_PIVOT)),
              fcall("LessThanOrEqual", fcol("d_date_sk", I64),
                    flit(_INV_PIVOT + 60))),
        ["d_date_sk"])
    j1 = bhj(inv, it, fcol("inv_item_sk", I64), fcol("i_item_sk", I64))
    j2 = bhj(j1, dd, fcol("inv_date_sk", I64), fcol("d_date_sk", I64))
    ss = cat.scan("store_sales", ["ss_item_sk"])
    j3 = smj(j2, ss, [fcol("i_item_sk", I64)], [fcol("ss_item_sk", I64)],
             join_type="LeftSemi")
    dedup = two_phase_agg(
        j3,
        grouping=[fcol("i_item_id", STR), fcol("i_class", STR),
                  fcol("i_current_price", F64)],
        group_fields=[Field("i_item_id", STR), Field("i_class", STR),
                      Field("i_current_price", F64)],
        aggs=[])
    out = Schema((Field("i_item_id", STR), Field("i_class", STR),
                  Field("i_current_price", F64)))
    return take_ordered(
        dedup,
        orders=[so(fcol("i_item_id", STR))],
        limit=100,
        project=[fcol("i_item_id", STR), fcol("i_class", STR),
                 fcol("i_current_price", F64)],
        out=out)


# ---------------------------------------------------------------------------
# returns / demographics / order-exists families
# (tpcds-queries/q24,q30,q83,q84,q85,q90,q91,q94,q95)
# ---------------------------------------------------------------------------

@_q("q30w")
def q30w(cat: Catalog) -> ForeignNode:
    """q30 family: customers whose WEB returns exceed 1.2x their state's
    average (the web_returns twin of q81), joined back to the customer
    id."""
    ret = cat.scan("web_returns",
                   ["wr_returning_customer_sk", "wr_return_amt"])
    cu = cat.scan("customer", ["c_customer_sk", "c_customer_id",
                               "c_current_addr_sk"])
    ca = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    j1 = bhj(ret, cu, fcol("wr_returning_customer_sk", I64),
             fcol("c_customer_sk", I64))
    j2 = bhj(j1, ca, fcol("c_current_addr_sk", I64),
             fcol("ca_address_sk", I64))
    per_cust = two_phase_agg(
        j2, grouping=[fcol("c_customer_id", STR), fcol("ca_state", STR)],
        group_fields=[Field("c_customer_id", STR),
                      Field("ca_state", STR)],
        aggs=[("amt", agg("Sum", fcol("wr_return_amt", F64), F64),
               Field("amt", F64))])
    by_state = two_phase_agg(
        per_cust, grouping=[fcol("ca_state", STR)],
        group_fields=[Field("ca_state", STR)],
        aggs=[("state_avg", agg("Average", fcol("amt", F64), F64),
               Field("state_avg", F64))])
    by_state_r = fproject(
        by_state, [falias(fcol("ca_state", STR), "st"),
                   fcol("state_avg", F64)],
        Schema((Field("st", STR), Field("state_avg", F64))))
    j3 = smj(per_cust, by_state_r, [fcol("ca_state", STR)],
             [fcol("st", STR)],
             out=Schema(tuple(per_cust.output.fields) +
                        tuple(by_state_r.output.fields)))
    heavy = ffilter(j3, fcall(
        "GreaterThan", fcol("amt", F64),
        fcall("Multiply", flit(1.2, F64), fcol("state_avg", F64),
              dtype=F64)))
    return take_ordered(
        heavy,
        orders=[so(fcol("amt", F64), asc=False),
                so(fcol("c_customer_id", STR))],
        limit=100,
        project=[fcol("c_customer_id", STR), fcol("ca_state", STR),
                 fcol("amt", F64), fcol("state_avg", F64)],
        out=Schema((Field("c_customer_id", STR), Field("ca_state", STR),
                    Field("amt", F64), Field("state_avg", F64))))


@_q("q24s")
def q24s(cat: Catalog) -> ForeignNode:
    """q24 family: net paid on returned tickets per customer x store x
    item class, kept when above 5% of the overall average (global window
    average + filter)."""
    ss = cat.scan("store_sales",
                  ["ss_ticket_number", "ss_item_sk", "ss_store_sk",
                   "ss_customer_sk", "ss_sales_price"])
    sr = cat.scan("store_returns", ["sr_ticket_number", "sr_item_sk"])
    j0 = smj(ss, sr,
             [fcol("ss_ticket_number", I64), fcol("ss_item_sk", I64)],
             [fcol("sr_ticket_number", I64), fcol("sr_item_sk", I64)])
    st = cat.scan("store", ["s_store_sk", "s_store_name"])
    it = cat.scan("item", ["i_item_sk", "i_class"])
    cu = cat.scan("customer", ["c_customer_sk", "c_customer_id"])
    j1 = bhj(j0, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    j3 = bhj(j2, cu, fcol("ss_customer_sk", I64),
             fcol("c_customer_sk", I64))
    grouped = two_phase_agg(
        j3,
        grouping=[fcol("c_customer_id", STR), fcol("s_store_name", STR),
                  fcol("i_class", STR)],
        group_fields=[Field("c_customer_id", STR),
                      Field("s_store_name", STR), Field("i_class", STR)],
        aggs=[("netpaid", agg("Sum", fcol("ss_sales_price", F64), F64),
               Field("netpaid", F64))])
    single = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,), output=grouped.output,
        attrs={"partitioning": {"mode": "single", "num_partitions": 1}})
    win_out = Schema(tuple(grouped.output.fields) +
                     (Field("overall_avg", F64),))
    win = ForeignNode(
        "WindowExec", children=(single,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "overall_avg", "fn": "agg", "args": [],
                    "agg": agg("Average", fcol("netpaid", F64), F64),
                    "dtype": F64}],
               "partition_spec": [], "order_spec": []})
    heavy = ffilter(win, fcall(
        "GreaterThan", fcol("netpaid", F64),
        fcall("Multiply", flit(0.05, F64), fcol("overall_avg", F64),
              dtype=F64)))
    return take_ordered(
        heavy,
        orders=[so(fcol("c_customer_id", STR)),
                so(fcol("netpaid", F64), asc=False),
                so(fcol("s_store_name", STR)), so(fcol("i_class", STR))],
        limit=100,
        project=[fcol("c_customer_id", STR), fcol("s_store_name", STR),
                 fcol("i_class", STR), fcol("netpaid", F64)],
        out=Schema((Field("c_customer_id", STR),
                    Field("s_store_name", STR), Field("i_class", STR),
                    Field("netpaid", F64))))


@_q("q83r")
def q83r(cat: Catalog) -> ForeignNode:
    """q83 family: per-item return amounts across the three return
    channels, each expressed as a share of the channel-total average
    (three aggs SMJ-joined on item id)."""
    def channel(table: str, item_col: str, amt_col: str,
                suffix: str) -> ForeignNode:
        ret = cat.scan(table, [item_col, amt_col])
        it = cat.scan("item", ["i_item_sk", "i_item_id"])
        j = bhj(ret, it, fcol(item_col, I64), fcol("i_item_sk", I64))
        grouped = two_phase_agg(
            j, grouping=[fcol("i_item_id", STR)],
            group_fields=[Field("i_item_id", STR)],
            aggs=[(f"amt{suffix}", agg("Sum", fcol(amt_col, F64), F64),
                   Field(f"amt{suffix}", F64))])
        return fproject(
            grouped,
            [falias(fcol("i_item_id", STR), f"id{suffix}"),
             fcol(f"amt{suffix}", F64)],
            Schema((Field(f"id{suffix}", STR),
                    Field(f"amt{suffix}", F64))))

    sr = channel("store_returns", "sr_item_sk", "sr_return_amt", "_s")
    cr = channel("catalog_returns", "cr_item_sk", "cr_return_amount",
                 "_c")
    wr = channel("web_returns", "wr_item_sk", "wr_return_amt", "_w")
    j1 = smj(sr, cr, [fcol("id_s", STR)], [fcol("id_c", STR)],
             out=Schema(tuple(sr.output.fields) +
                        tuple(cr.output.fields)))
    j2 = smj(j1, wr, [fcol("id_s", STR)], [fcol("id_w", STR)],
             out=Schema(tuple(j1.output.fields) +
                        tuple(wr.output.fields)))
    total = fcall("Add", fcall("Add", fcol("amt_s", F64),
                               fcol("amt_c", F64)),
                  fcol("amt_w", F64))
    third = fcall("Divide", total, flit(3.0))
    proj_out = Schema((Field("item_id", STR), Field("sr_share", F64),
                       Field("cr_share", F64), Field("wr_share", F64)))
    shares = fproject(
        j2,
        [falias(fcol("id_s", STR), "item_id"),
         falias(fcall("Divide", fcol("amt_s", F64), third), "sr_share"),
         falias(fcall("Divide", fcol("amt_c", F64), third), "cr_share"),
         falias(fcall("Divide", fcol("amt_w", F64), third), "wr_share")],
        proj_out)
    return take_ordered(
        shares,
        orders=[so(fcol("item_id", STR)),
                so(fcol("sr_share", F64), asc=False)],
        limit=100,
        project=[fcol("item_id", STR), fcol("sr_share", F64),
                 fcol("cr_share", F64), fcol("wr_share", F64)],
        out=proj_out)


@_q("q84d")
def q84d(cat: Catalog) -> ForeignNode:
    """q84 family: returning customers from one state in an income band,
    resolved through the demographics chain (customer -> address ->
    household demo -> income band -> customer demo -> store_returns)."""
    cu = cat.scan("customer",
                  ["c_customer_sk", "c_customer_id", "c_current_addr_sk",
                   "c_current_cdemo_sk", "c_current_hdemo_sk"])
    ca = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    ca = ffilter(ca, fcall("EqualTo", fcol("ca_state", STR), flit("CA")))
    hd = cat.scan("household_demographics",
                  ["hd_demo_sk", "hd_income_band_sk"])
    ib = cat.scan("income_band",
                  ["ib_income_band_sk", "ib_lower_bound",
                   "ib_upper_bound"])
    ib = ffilter(ib, fcall(
        "And",
        fcall("GreaterThanOrEqual", fcol("ib_lower_bound", I32),
              flit(30_000)),
        fcall("LessThanOrEqual", fcol("ib_upper_bound", I32),
              flit(100_000))))
    cd = cat.scan("customer_demographics", ["cd_demo_sk"])
    sr = cat.scan("store_returns", ["sr_cdemo_sk"])
    j1 = bhj(cu, ca, fcol("c_current_addr_sk", I64),
             fcol("ca_address_sk", I64))
    j2 = bhj(j1, hd, fcol("c_current_hdemo_sk", I64),
             fcol("hd_demo_sk", I64))
    j3 = bhj(j2, ib, fcol("hd_income_band_sk", I64),
             fcol("ib_income_band_sk", I64))
    j4 = bhj(j3, cd, fcol("c_current_cdemo_sk", I64),
             fcol("cd_demo_sk", I64))
    j5 = smj(j4, sr, [fcol("cd_demo_sk", I64)], [fcol("sr_cdemo_sk", I64)],
             join_type="LeftSemi")
    dedup = two_phase_agg(
        j5, grouping=[fcol("c_customer_id", STR)],
        group_fields=[Field("c_customer_id", STR)],
        aggs=[])
    return take_ordered(
        dedup, orders=[so(fcol("c_customer_id", STR))], limit=100,
        project=[fcol("c_customer_id", STR)],
        out=Schema((Field("c_customer_id", STR),)))


@_q("q85r")
def q85r(cat: Catalog) -> ForeignNode:
    """q85 family: reasons for web returns by matching demographics,
    averaged per reason description."""
    ws = cat.scan("web_sales",
                  ["ws_item_sk", "ws_order_number", "ws_quantity",
                   "ws_web_page_sk"])
    wr = cat.scan("web_returns",
                  ["wr_item_sk", "wr_order_number", "wr_refunded_cdemo_sk",
                   "wr_refunded_addr_sk", "wr_reason_sk",
                   "wr_refunded_cash", "wr_fee"])
    j0 = smj(ws, wr,
             [fcol("ws_order_number", I64), fcol("ws_item_sk", I64)],
             [fcol("wr_order_number", I64), fcol("wr_item_sk", I64)])
    wp = cat.scan("web_page", ["wp_web_page_sk"])
    cd = cat.scan("customer_demographics",
                  ["cd_demo_sk", "cd_marital_status",
                   "cd_education_status"])
    cd = ffilter(cd, fcall(
        "Or",
        fcall("And",
              fcall("EqualTo", fcol("cd_marital_status", STR), flit("M")),
              fcall("EqualTo", fcol("cd_education_status", STR),
                    flit("4 yr Degree"))),
        fcall("And",
              fcall("EqualTo", fcol("cd_marital_status", STR), flit("S")),
              fcall("EqualTo", fcol("cd_education_status", STR),
                    flit("College")))))
    ca = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    ca = ffilter(ca, fcall("In", fcol("ca_state", STR), flit("CA"),
                           flit("TX"), flit("NY")))
    rs = cat.scan("reason", ["r_reason_sk", "r_reason_desc"])
    j1 = bhj(j0, wp, fcol("ws_web_page_sk", I64),
             fcol("wp_web_page_sk", I64))
    j2 = bhj(j1, cd, fcol("wr_refunded_cdemo_sk", I64),
             fcol("cd_demo_sk", I64))
    j3 = bhj(j2, ca, fcol("wr_refunded_addr_sk", I64),
             fcol("ca_address_sk", I64))
    j4 = bhj(j3, rs, fcol("wr_reason_sk", I64), fcol("r_reason_sk", I64))
    grouped = two_phase_agg(
        j4, grouping=[fcol("r_reason_desc", STR)],
        group_fields=[Field("r_reason_desc", STR)],
        aggs=[("avg_qty", agg("Average", fcall(
                   "Cast", fcol("ws_quantity", I32), dtype=F64), F64),
               Field("avg_qty", F64)),
              ("avg_cash", agg("Average", fcol("wr_refunded_cash", F64),
                               F64),
               Field("avg_cash", F64)),
              ("avg_fee", agg("Average", fcol("wr_fee", F64), F64),
               Field("avg_fee", F64))])
    out = Schema((Field("r_reason_desc", STR), Field("avg_qty", F64),
                  Field("avg_cash", F64), Field("avg_fee", F64)))
    return take_ordered(
        grouped,
        orders=[so(fcol("r_reason_desc", STR))],
        limit=100,
        project=[fcol("r_reason_desc", STR), fcol("avg_qty", F64),
                 fcol("avg_cash", F64), fcol("avg_fee", F64)],
        out=out)


@_q("q90r")
def q90r(cat: Catalog) -> ForeignNode:
    """q90 family: ratio of morning to evening web sales for
    dependent-heavy households (two global counts joined on a literal
    key)."""
    def slot(h_lo: int, h_hi: int, name: str) -> ForeignNode:
        ws = cat.scan("web_sales",
                      ["ws_sold_time_sk", "ws_ship_hdemo_sk",
                       "ws_web_page_sk"])
        td = cat.scan("time_dim", ["t_time_sk", "t_hour"])
        td = ffilter(td, fcall(
            "And",
            fcall("GreaterThanOrEqual", fcol("t_hour", I32), flit(h_lo)),
            fcall("LessThanOrEqual", fcol("t_hour", I32), flit(h_hi))))
        hd = cat.scan("household_demographics",
                      ["hd_demo_sk", "hd_dep_count"])
        hd = ffilter(hd, fcall("EqualTo", fcol("hd_dep_count", I32),
                               flit(6)))
        wp = cat.scan("web_page", ["wp_web_page_sk", "wp_char_count"])
        wp = ffilter(wp, fcall(
            "And",
            fcall("GreaterThanOrEqual", fcol("wp_char_count", I32),
                  flit(100)),
            fcall("LessThanOrEqual", fcol("wp_char_count", I32),
                  flit(8000))))
        j1 = bhj(ws, td, fcol("ws_sold_time_sk", I64),
                 fcol("t_time_sk", I64))
        j2 = bhj(j1, hd, fcol("ws_ship_hdemo_sk", I64),
                 fcol("hd_demo_sk", I64))
        j3 = bhj(j2, wp, fcol("ws_web_page_sk", I64),
                 fcol("wp_web_page_sk", I64))
        counted = two_phase_agg(
            j3, grouping=[], group_fields=[],
            aggs=[(name, agg("Count", None, I64), Field(name, I64))])
        return fproject(
            counted,
            [falias(flit(1, I64), f"k_{name}"), fcol(name, I64)],
            Schema((Field(f"k_{name}", I64), Field(name, I64))))

    am = slot(8, 9, "amc")
    pm = slot(19, 20, "pmc")
    j = bhj(am, pm, fcol("k_amc", I64), fcol("k_pmc", I64))
    out = Schema((Field("am_pm_ratio", F64),))
    ratio = fproject(
        j,
        [falias(fcall("Divide",
                      fcall("Cast", fcol("amc", I64), dtype=F64),
                      fcall("Cast", fcol("pmc", I64), dtype=F64)),
                "am_pm_ratio")],
        out)
    return take_ordered(
        ratio, orders=[so(fcol("am_pm_ratio", F64))], limit=10,
        project=[fcol("am_pm_ratio", F64)], out=out)


@_q("q91c")
def q91c(cat: Catalog) -> ForeignNode:
    """q91 family: call-center catalog-return losses by demographic
    segment."""
    cr = cat.scan("catalog_returns",
                  ["cr_returned_date_sk", "cr_returning_customer_sk",
                   "cr_call_center_sk", "cr_net_loss"])
    cc = cat.scan("call_center",
                  ["cc_call_center_sk", "cc_name", "cc_manager"])
    dd = _dim_date(cat, fcall("EqualTo", fcol("d_year", I32), flit(2000)),
                   ["d_date_sk", "d_year"])
    cu = cat.scan("customer",
                  ["c_customer_sk", "c_current_cdemo_sk",
                   "c_current_hdemo_sk", "c_current_addr_sk"])
    cd = cat.scan("customer_demographics",
                  ["cd_demo_sk", "cd_marital_status",
                   "cd_education_status"])
    cd = ffilter(cd, fcall(
        "And",
        fcall("In", fcol("cd_marital_status", STR), flit("M"),
              flit("W")),
        fcall("In", fcol("cd_education_status", STR), flit("Unknown"),
              flit("Advanced Degree"), flit("College"))))
    hd = cat.scan("household_demographics",
                  ["hd_demo_sk", "hd_buy_potential"])
    ca = cat.scan("customer_address", ["ca_address_sk", "ca_gmt_offset"])
    ca = ffilter(ca, fcall("In", fcol("ca_gmt_offset", F64),
                           flit(-5.0), flit(-6.0), flit(-7.0)))
    j1 = bhj(cr, cc, fcol("cr_call_center_sk", I64),
             fcol("cc_call_center_sk", I64))
    j2 = bhj(j1, dd, fcol("cr_returned_date_sk", I64),
             fcol("d_date_sk", I64))
    j3 = bhj(j2, cu, fcol("cr_returning_customer_sk", I64),
             fcol("c_customer_sk", I64))
    j4 = bhj(j3, cd, fcol("c_current_cdemo_sk", I64),
             fcol("cd_demo_sk", I64))
    j5 = bhj(j4, hd, fcol("c_current_hdemo_sk", I64),
             fcol("hd_demo_sk", I64))
    j6 = bhj(j5, ca, fcol("c_current_addr_sk", I64),
             fcol("ca_address_sk", I64))
    grouped = two_phase_agg(
        j6,
        grouping=[fcol("cc_name", STR), fcol("cc_manager", STR),
                  fcol("cd_marital_status", STR),
                  fcol("cd_education_status", STR)],
        group_fields=[Field("cc_name", STR), Field("cc_manager", STR),
                      Field("cd_marital_status", STR),
                      Field("cd_education_status", STR)],
        aggs=[("loss", agg("Sum", fcol("cr_net_loss", F64), F64),
               Field("loss", F64))])
    out = Schema((Field("cc_name", STR), Field("cc_manager", STR),
                  Field("cd_marital_status", STR),
                  Field("cd_education_status", STR), Field("loss", F64)))
    return take_ordered(
        grouped,
        orders=[so(fcol("loss", F64), asc=False),
                so(fcol("cc_name", STR))],
        limit=100,
        project=[fcol("cc_name", STR), fcol("cc_manager", STR),
                 fcol("cd_marital_status", STR),
                 fcol("cd_education_status", STR), fcol("loss", F64)],
        out=out)


def _multi_warehouse_orders(cat: Catalog, alias: str) -> ForeignNode:
    """Orders shipped from more than one warehouse (the EXISTS in
    q94/q95, rewritten as dedup -> count -> filter the way Spark's
    optimizer lowers the correlated subquery)."""
    ws = cat.scan("web_sales", ["ws_order_number", "ws_warehouse_sk"])
    pairs = two_phase_agg(
        ws,
        grouping=[fcol("ws_order_number", I64),
                  fcol("ws_warehouse_sk", I64)],
        group_fields=[Field("ws_order_number", I64),
                      Field("ws_warehouse_sk", I64)],
        aggs=[])
    counts = two_phase_agg(
        pairs, grouping=[fcol("ws_order_number", I64)],
        group_fields=[Field("ws_order_number", I64)],
        aggs=[("n_wh", agg("Count", None, I64), Field("n_wh", I64))])
    multi = ffilter(counts, fcall("GreaterThanOrEqual",
                                  fcol("n_wh", I64), flit(2)))
    return fproject(multi, [falias(fcol("ws_order_number", I64), alias)],
                    Schema((Field(alias, I64),)))


def _order_stats(base: ForeignNode) -> ForeignNode:
    """Order-level rollup then the single-row summary q94/q95 report."""
    per_order = two_phase_agg(
        base, grouping=[fcol("ws_order_number", I64)],
        group_fields=[Field("ws_order_number", I64)],
        aggs=[("ship_cost", agg("Sum", fcol("ws_ext_sales_price", F64),
                                F64),
               Field("ship_cost", F64)),
              ("profit", agg("Sum", fcol("ws_net_profit", F64), F64),
               Field("profit", F64))])
    return two_phase_agg(
        per_order, grouping=[], group_fields=[],
        aggs=[("order_count", agg("Count", None, I64),
               Field("order_count", I64)),
              ("total_ship", agg("Sum", fcol("ship_cost", F64), F64),
               Field("total_ship", F64)),
              ("total_profit", agg("Sum", fcol("profit", F64), F64),
               Field("total_profit", F64))])


@_q("q94n")
def q94n(cat: Catalog) -> ForeignNode:
    """q94 family: multi-warehouse web orders NOT returned (semi on the
    rewritten exists, anti on web_returns), summarized."""
    ws = cat.scan("web_sales",
                  ["ws_order_number", "ws_ship_date_sk", "ws_ship_addr_sk",
                   "ws_web_site_sk", "ws_ext_sales_price",
                   "ws_net_profit"])
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("GreaterThanOrEqual", fcol("d_date_sk", I64),
                    flit(_INV_PIVOT)),
              fcall("LessThanOrEqual", fcol("d_date_sk", I64),
                    flit(_INV_PIVOT + 60))),
        ["d_date_sk"])
    ca = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    ca = ffilter(ca, fcall("EqualTo", fcol("ca_state", STR), flit("TX")))
    web = cat.scan("web_site", ["web_site_sk"])
    j1 = bhj(ws, dd, fcol("ws_ship_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, ca, fcol("ws_ship_addr_sk", I64),
             fcol("ca_address_sk", I64))
    j3 = bhj(j2, web, fcol("ws_web_site_sk", I64), fcol("web_site_sk", I64))
    multi = _multi_warehouse_orders(cat, "mo")
    j4 = smj(j3, multi, [fcol("ws_order_number", I64)], [fcol("mo", I64)],
             join_type="LeftSemi")
    wr = cat.scan("web_returns", ["wr_order_number"])
    j5 = smj(j4, wr, [fcol("ws_order_number", I64)],
             [fcol("wr_order_number", I64)], join_type="LeftAnti")
    total = _order_stats(j5)
    out = Schema((Field("order_count", I64), Field("total_ship", F64),
                  Field("total_profit", F64)))
    return take_ordered(
        total, orders=[so(fcol("order_count", I64))], limit=10,
        project=[fcol("order_count", I64), fcol("total_ship", F64),
                 fcol("total_profit", F64)],
        out=out)


@_q("q95w")
def q95w(cat: Catalog) -> ForeignNode:
    """q95 family: multi-warehouse web orders that WERE returned (semi on
    both the rewritten exists and web_returns), summarized."""
    ws = cat.scan("web_sales",
                  ["ws_order_number", "ws_ship_date_sk", "ws_ship_addr_sk",
                   "ws_web_site_sk", "ws_ext_sales_price",
                   "ws_net_profit"])
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("GreaterThanOrEqual", fcol("d_date_sk", I64),
                    flit(_INV_PIVOT)),
              fcall("LessThanOrEqual", fcol("d_date_sk", I64),
                    flit(_INV_PIVOT + 60))),
        ["d_date_sk"])
    ca = cat.scan("customer_address", ["ca_address_sk", "ca_state"])
    ca = ffilter(ca, fcall("EqualTo", fcol("ca_state", STR), flit("TX")))
    j1 = bhj(ws, dd, fcol("ws_ship_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, ca, fcol("ws_ship_addr_sk", I64),
             fcol("ca_address_sk", I64))
    multi = _multi_warehouse_orders(cat, "mo")
    j3 = smj(j2, multi, [fcol("ws_order_number", I64)], [fcol("mo", I64)],
             join_type="LeftSemi")
    wr = cat.scan("web_returns", ["wr_order_number"])
    j4 = smj(j3, wr, [fcol("ws_order_number", I64)],
             [fcol("wr_order_number", I64)], join_type="LeftSemi")
    total = _order_stats(j4)
    out = Schema((Field("order_count", I64), Field("total_ship", F64),
                  Field("total_profit", F64)))
    return take_ordered(
        total, orders=[so(fcol("order_count", I64))], limit=10,
        project=[fcol("order_count", I64), fcol("total_ship", F64),
                 fcol("total_profit", F64)],
        out=out)


# ---------------------------------------------------------------------------
# cross-channel / rollup capstones
# (tpcds-queries/q53,q56,q58,q64,q74,q78,q80)
# ---------------------------------------------------------------------------

@_q("q53m")
def q53m(cat: Catalog) -> ForeignNode:
    """q53 family: quarterly manufacturer sales vs their overall average
    (the q63/q89 window shape keyed by manufacturer x quarter)."""
    ss = cat.scan("store_sales",
                  ["ss_sold_date_sk", "ss_item_sk", "ss_sales_price"])
    dd = cat.scan("date_dim", ["d_date_sk", "d_qoy"])
    it = cat.scan("item", ["i_item_sk", "i_manufact_id"])
    j1 = bhj(ss, dd, fcol("ss_sold_date_sk", I64), fcol("d_date_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j2, grouping=[fcol("i_manufact_id", I32), fcol("d_qoy", I32)],
        group_fields=[Field("i_manufact_id", I32), Field("d_qoy", I32)],
        aggs=[("sum_sales", agg("Sum", fcol("ss_sales_price", F64), F64),
               Field("sum_sales", F64))])
    repart = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,), output=grouped.output,
        attrs={"partitioning": {
            "mode": "hash", "num_partitions": 4,
            "expressions": [fcol("i_manufact_id", I32)]}})
    win_out = Schema((Field("i_manufact_id", I32), Field("d_qoy", I32),
                      Field("sum_sales", F64), Field("avg_quarterly",
                                                     F64)))
    win = ForeignNode(
        "WindowExec", children=(repart,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "avg_quarterly", "fn": "agg", "args": [],
                    "agg": agg("Average", fcol("sum_sales", F64), F64),
                    "dtype": F64}],
               "partition_spec": [fcol("i_manufact_id", I32)],
               "order_spec": []})
    above = ffilter(win, fcall("GreaterThan", fcol("sum_sales", F64),
                               fcol("avg_quarterly", F64)))
    return take_ordered(
        above,
        orders=[so(fcol("avg_quarterly", F64), asc=False),
                so(fcol("sum_sales", F64), asc=False),
                so(fcol("i_manufact_id", I32)), so(fcol("d_qoy", I32))],
        limit=100,
        project=[fcol("i_manufact_id", I32), fcol("d_qoy", I32),
                 fcol("sum_sales", F64), fcol("avg_quarterly", F64)],
        out=win_out)


def _channel_item_rev(cat: Catalog, table: str, date_col: str,
                      item_col: str, cust_col: str, price_col: str,
                      suffix: str, via_customer: bool = True
                      ) -> ForeignNode:
    """Shared q56/q58 shape: one channel's revenue per item id for
    customers in the home timezone."""
    cols = [date_col, item_col, price_col]
    if via_customer:
        cols.append(cust_col)
    f = cat.scan(table, cols)
    dd = _dim_date(
        cat,
        fcall("And",
              fcall("EqualTo", fcol("d_year", I32), flit(2000)),
              fcall("EqualTo", fcol("d_moy", I32), flit(2))),
        ["d_date_sk", "d_year", "d_moy"])
    it = cat.scan("item", ["i_item_sk", "i_item_id"])
    j = bhj(f, dd, fcol(date_col, I64), fcol("d_date_sk", I64))
    if via_customer:
        cu = cat.scan("customer", ["c_customer_sk", "c_current_addr_sk"])
        ca = cat.scan("customer_address",
                      ["ca_address_sk", "ca_gmt_offset"])
        ca = ffilter(ca, fcall("EqualTo", fcol("ca_gmt_offset", F64),
                               flit(-5.0)))
        j = bhj(j, cu, fcol(cust_col, I64), fcol("c_customer_sk", I64))
        j = bhj(j, ca, fcol("c_current_addr_sk", I64),
                fcol("ca_address_sk", I64))
    j = bhj(j, it, fcol(item_col, I64), fcol("i_item_sk", I64))
    grouped = two_phase_agg(
        j, grouping=[fcol("i_item_id", STR)],
        group_fields=[Field("i_item_id", STR)],
        aggs=[(f"rev{suffix}", agg("Sum", fcol(price_col, F64), F64),
               Field(f"rev{suffix}", F64))])
    return fproject(
        grouped,
        [falias(fcol("i_item_id", STR), f"id{suffix}"),
         fcol(f"rev{suffix}", F64)],
        Schema((Field(f"id{suffix}", STR), Field(f"rev{suffix}", F64))))


@_q("q56s")
def q56s(cat: Catalog) -> ForeignNode:
    """q56 family: per-item revenue summed across the three channels for
    home-timezone customers (per-channel aggs unioned then re-agged)."""
    ss = _channel_item_rev(cat, "store_sales", "ss_sold_date_sk",
                           "ss_item_sk", "ss_customer_sk",
                           "ss_ext_sales_price", "_u")
    cs = _channel_item_rev(cat, "catalog_sales", "cs_sold_date_sk",
                           "cs_item_sk", "cs_bill_customer_sk",
                           "cs_ext_sales_price", "_u")
    ws = _channel_item_rev(cat, "web_sales", "ws_sold_date_sk",
                           "ws_item_sk", "ws_bill_customer_sk",
                           "ws_ext_sales_price", "_u")
    union = ForeignNode("UnionExec", children=(ss, cs, ws),
                        output=ss.output)
    total = two_phase_agg(
        union, grouping=[fcol("id_u", STR)],
        group_fields=[Field("id_u", STR)],
        aggs=[("total_rev", agg("Sum", fcol("rev_u", F64), F64),
               Field("total_rev", F64))])
    out = Schema((Field("id_u", STR), Field("total_rev", F64)))
    return take_ordered(
        total,
        orders=[so(fcol("total_rev", F64), asc=False),
                so(fcol("id_u", STR))],
        limit=100,
        project=[fcol("id_u", STR), fcol("total_rev", F64)],
        out=out)


@_q("q58s")
def q58s(cat: Catalog) -> ForeignNode:
    """q58 family: items whose revenue in EACH channel stays within 10%
    of the cross-channel average (three aggs SMJ-joined + band filter)."""
    ss = _channel_item_rev(cat, "store_sales", "ss_sold_date_sk",
                           "ss_item_sk", "ss_customer_sk",
                           "ss_ext_sales_price", "_ss",
                           via_customer=False)
    cs = _channel_item_rev(cat, "catalog_sales", "cs_sold_date_sk",
                           "cs_item_sk", "cs_bill_customer_sk",
                           "cs_ext_sales_price", "_cs",
                           via_customer=False)
    ws = _channel_item_rev(cat, "web_sales", "ws_sold_date_sk",
                           "ws_item_sk", "ws_bill_customer_sk",
                           "ws_ext_sales_price", "_ws",
                           via_customer=False)
    j1 = smj(ss, cs, [fcol("id_ss", STR)], [fcol("id_cs", STR)],
             out=Schema(tuple(ss.output.fields) +
                        tuple(cs.output.fields)))
    j2 = smj(j1, ws, [fcol("id_ss", STR)], [fcol("id_ws", STR)],
             out=Schema(tuple(j1.output.fields) +
                        tuple(ws.output.fields)))
    average = fcall(
        "Divide",
        fcall("Add", fcall("Add", fcol("rev_ss", F64),
                           fcol("rev_cs", F64)),
              fcol("rev_ws", F64)),
        flit(3.0))

    def in_band(c):
        # official q58 keeps channels within 10% of the average; the
        # generated corpus sizes channels 4:2:1 by construction, so the
        # family keeps the band-filter shape with a wider [0.2, 2.0] band
        return fcall(
            "And",
            fcall("GreaterThanOrEqual", c,
                  fcall("Multiply", flit(0.2, F64), average, dtype=F64)),
            fcall("LessThanOrEqual", c,
                  fcall("Multiply", flit(2.0, F64), average, dtype=F64)))

    steady = ffilter(j2, fcall(
        "And",
        fcall("And", in_band(fcol("rev_ss", F64)),
              in_band(fcol("rev_cs", F64))),
        in_band(fcol("rev_ws", F64))))
    out = Schema((Field("id_ss", STR), Field("rev_ss", F64),
                  Field("rev_cs", F64), Field("rev_ws", F64)))
    return take_ordered(
        steady,
        orders=[so(fcol("id_ss", STR)),
                so(fcol("rev_ss", F64), asc=False)],
        limit=100,
        project=[fcol("id_ss", STR), fcol("rev_ss", F64),
                 fcol("rev_cs", F64), fcol("rev_ws", F64)],
        out=out)


@_q("q64x")
def q64x(cat: Catalog) -> ForeignNode:
    """q64 family (reduced): items returned in store then cross-sold on
    the catalog channel — ss joined to sr, per-item store stats SMJ-joined
    to per-item catalog stats, dims on top."""
    ss = cat.scan("store_sales",
                  ["ss_ticket_number", "ss_item_sk", "ss_store_sk",
                   "ss_sales_price"])
    sr = cat.scan("store_returns", ["sr_ticket_number", "sr_item_sk"])
    returned = smj(ss, sr,
                   [fcol("ss_ticket_number", I64), fcol("ss_item_sk", I64)],
                   [fcol("sr_ticket_number", I64),
                    fcol("sr_item_sk", I64)])
    store_stats = two_phase_agg(
        returned, grouping=[fcol("ss_item_sk", I64)],
        group_fields=[Field("ss_item_sk", I64)],
        aggs=[("store_rev", agg("Sum", fcol("ss_sales_price", F64), F64),
               Field("store_rev", F64)),
              ("n_ret", agg("Count", None, I64), Field("n_ret", I64))])
    cs = cat.scan("catalog_sales",
                  ["cs_item_sk", "cs_order_number", "cs_sales_price"])
    cr = cat.scan("catalog_returns", ["cr_order_number", "cr_item_sk"])
    kept = smj(cs, cr,
               [fcol("cs_order_number", I64), fcol("cs_item_sk", I64)],
               [fcol("cr_order_number", I64), fcol("cr_item_sk", I64)],
               join_type="LeftAnti")
    cat_stats = two_phase_agg(
        kept, grouping=[fcol("cs_item_sk", I64)],
        group_fields=[Field("cs_item_sk", I64)],
        aggs=[("cat_rev", agg("Sum", fcol("cs_sales_price", F64), F64),
               Field("cat_rev", F64))])
    j = smj(store_stats, cat_stats, [fcol("ss_item_sk", I64)],
            [fcol("cs_item_sk", I64)],
            out=Schema(tuple(store_stats.output.fields) +
                       tuple(cat_stats.output.fields)))
    it = cat.scan("item", ["i_item_sk", "i_item_id", "i_current_price"])
    j2 = bhj(j, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    richer = ffilter(j2, fcall("GreaterThan", fcol("cat_rev", F64),
                               fcol("store_rev", F64)))
    out = Schema((Field("i_item_id", STR), Field("i_current_price", F64),
                  Field("store_rev", F64), Field("cat_rev", F64),
                  Field("n_ret", I64)))
    return take_ordered(
        richer,
        orders=[so(fcol("i_item_id", STR))],
        limit=100,
        project=[fcol("i_item_id", STR), fcol("i_current_price", F64),
                 fcol("store_rev", F64), fcol("cat_rev", F64),
                 fcol("n_ret", I64)],
        out=out)


@_q("q74y")
def q74y(cat: Catalog) -> ForeignNode:
    """q74 family: customers whose web spend grew faster year-over-year
    than their store spend (two channel aggs with CaseWhen year pivots,
    SMJ-joined)."""
    def channel_pivot(table: str, date_col: str, cust_col: str,
                      price_col: str, suffix: str) -> ForeignNode:
        f = cat.scan(table, [date_col, cust_col, price_col])
        dd = _dim_date(cat, fcall("In", fcol("d_year", I32), flit(2000),
                                  flit(2001)),
                       ["d_date_sk", "d_year"])
        j = bhj(f, dd, fcol(date_col, I64), fcol("d_date_sk", I64))
        y1 = _case(fcall("EqualTo", fcol("d_year", I32), flit(2000)),
                   fcol(price_col, F64), flit(0.0), F64)
        y2 = _case(fcall("EqualTo", fcol("d_year", I32), flit(2001)),
                   fcol(price_col, F64), flit(0.0), F64)
        grouped = two_phase_agg(
            j, grouping=[fcol(cust_col, I64)],
            group_fields=[Field(cust_col, I64)],
            aggs=[(f"y1{suffix}", agg("Sum", y1, F64),
                   Field(f"y1{suffix}", F64)),
                  (f"y2{suffix}", agg("Sum", y2, F64),
                   Field(f"y2{suffix}", F64))])
        pos = ffilter(grouped, fcall(
            "And",
            fcall("GreaterThan", fcol(f"y1{suffix}", F64), flit(0.0)),
            fcall("GreaterThan", fcol(f"y2{suffix}", F64), flit(0.0))))
        # the ratio is rounded so cross-engine float jitter cannot
        # reorder near-tied rows: ties become EXACT and the
        # c_customer_id sort key then breaks them deterministically
        return fproject(
            pos,
            [falias(fcol(cust_col, I64), f"c{suffix}"),
             falias(fcall("Round",
                          fcall("Divide", fcol(f"y2{suffix}", F64),
                                fcol(f"y1{suffix}", F64)),
                          flit(6), dtype=F64), f"growth{suffix}")],
            Schema((Field(f"c{suffix}", I64),
                    Field(f"growth{suffix}", F64))))

    store = channel_pivot("store_sales", "ss_sold_date_sk",
                          "ss_customer_sk", "ss_ext_sales_price", "_s")
    web = channel_pivot("web_sales", "ws_sold_date_sk",
                        "ws_bill_customer_sk", "ws_ext_sales_price",
                        "_w")
    j = smj(store, web, [fcol("c_s", I64)], [fcol("c_w", I64)],
            out=Schema(tuple(store.output.fields) +
                       tuple(web.output.fields)))
    faster = ffilter(j, fcall("GreaterThan", fcol("growth_w", F64),
                              fcol("growth_s", F64)))
    cu = cat.scan("customer", ["c_customer_sk", "c_customer_id"])
    j2 = bhj(faster, cu, fcol("c_s", I64), fcol("c_customer_sk", I64))
    out = Schema((Field("c_customer_id", STR), Field("growth_s", F64),
                  Field("growth_w", F64)))
    return take_ordered(
        j2,
        orders=[so(fcol("growth_w", F64), asc=False),
                so(fcol("c_customer_id", STR))],
        limit=100,
        project=[fcol("c_customer_id", STR), fcol("growth_s", F64),
                 fcol("growth_w", F64)],
        out=out)


@_q("q78n")
def q78n(cat: Catalog) -> ForeignNode:
    """q78 family: per (year, item) sales kept after anti-joining returns
    in all three channels; store revenue ratioed against web+catalog."""
    def channel(table, date_col, item_col, price_col, anti, akeys, bkeys,
                suffix):
        f = cat.scan(table, [date_col, item_col, price_col] + akeys)
        r = cat.scan(anti, bkeys)
        j0 = smj(f, r, [fcol(k, I64) for k in akeys],
                 [fcol(k, I64) for k in bkeys], join_type="LeftAnti")
        dd = cat.scan("date_dim", ["d_date_sk", "d_year"])
        j1 = bhj(j0, dd, fcol(date_col, I64), fcol("d_date_sk", I64))
        grouped = two_phase_agg(
            j1, grouping=[fcol("d_year", I32), fcol(item_col, I64)],
            group_fields=[Field("d_year", I32), Field(item_col, I64)],
            aggs=[(f"rev{suffix}", agg("Sum", fcol(price_col, F64), F64),
                   Field(f"rev{suffix}", F64))])
        return fproject(
            grouped,
            [falias(fcol("d_year", I32), f"y{suffix}"),
             falias(fcol(item_col, I64), f"i{suffix}"),
             fcol(f"rev{suffix}", F64)],
            Schema((Field(f"y{suffix}", I32), Field(f"i{suffix}", I64),
                    Field(f"rev{suffix}", F64))))

    ss = channel("store_sales", "ss_sold_date_sk", "ss_item_sk",
                 "ss_sales_price", "store_returns",
                 ["ss_ticket_number"], ["sr_ticket_number"], "_s")
    ws = channel("web_sales", "ws_sold_date_sk", "ws_item_sk",
                 "ws_sales_price", "web_returns",
                 ["ws_order_number"], ["wr_order_number"], "_w")
    cs = channel("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                 "cs_sales_price", "catalog_returns",
                 ["cs_order_number"], ["cr_order_number"], "_c")
    j1 = smj(ss, ws, [fcol("y_s", I32), fcol("i_s", I64)],
             [fcol("y_w", I32), fcol("i_w", I64)],
             out=Schema(tuple(ss.output.fields) +
                        tuple(ws.output.fields)))
    j2 = smj(j1, cs, [fcol("y_s", I32), fcol("i_s", I64)],
             [fcol("y_c", I32), fcol("i_c", I64)],
             out=Schema(tuple(j1.output.fields) +
                        tuple(cs.output.fields)))
    ratio = fcall("Divide", fcol("rev_s", F64),
                  fcall("Add", fcol("rev_w", F64), fcol("rev_c", F64)))
    proj_out = Schema((Field("y_s", I32), Field("i_s", I64),
                       Field("rev_s", F64), Field("rev_w", F64),
                       Field("rev_c", F64), Field("store_ratio", F64)))
    projected = fproject(
        j2,
        [fcol("y_s", I32), fcol("i_s", I64), fcol("rev_s", F64),
         fcol("rev_w", F64), fcol("rev_c", F64),
         falias(ratio, "store_ratio")],
        proj_out)
    return take_ordered(
        projected,
        orders=[so(fcol("store_ratio", F64), asc=False),
                so(fcol("y_s", I32)), so(fcol("i_s", I64))],
        limit=100,
        project=[fcol("y_s", I32), fcol("i_s", I64), fcol("rev_s", F64),
                 fcol("rev_w", F64), fcol("rev_c", F64),
                 fcol("store_ratio", F64)],
        out=proj_out)


@_q("q80s")
def q80s(cat: Catalog) -> ForeignNode:
    """q80 family: sales / returns / net profit per channel id with a
    rollup over (channel, id) — union of three channel aggs into an
    ExpandExec grouping set."""
    def channel(fact, date_col, item_col, promo_col, id_join):
        id_table, id_fk, id_sk, id_col = id_join
        cols = [date_col, item_col, promo_col, id_fk,
                fact[1], fact[2], fact[3]]
        f = cat.scan(fact[0], cols)
        dd = _dim_date(cat, fcall("EqualTo", fcol("d_year", I32),
                                  flit(2000)),
                       ["d_date_sk", "d_year"])
        pr = cat.scan("promotion", ["p_promo_sk", "p_channel_email"])
        pr = ffilter(pr, fcall("EqualTo", fcol("p_channel_email", STR),
                               flit("N")))
        idt = cat.scan(id_table, [id_sk, id_col])
        j = bhj(f, dd, fcol(date_col, I64), fcol("d_date_sk", I64))
        j = bhj(j, pr, fcol(promo_col, I64), fcol("p_promo_sk", I64))
        j = bhj(j, idt, fcol(id_fk, I64), fcol(id_sk, I64))
        grouped = two_phase_agg(
            j, grouping=[fcol(id_col, STR)],
            group_fields=[Field(id_col, STR)],
            aggs=[("sales", agg("Sum", fcol(fact[1], F64), F64),
                   Field("sales", F64)),
                  ("qty", agg("Sum", fcall(
                      "Cast", fcol(fact[2], I32), dtype=F64), F64),
                   Field("qty", F64)),
                  ("profit", agg("Sum", fcol(fact[3], F64), F64),
                   Field("profit", F64))])
        return fproject(
            grouped,
            [falias(flit(fact[4]), "channel"),
             falias(fcol(id_col, STR), "id"),
             fcol("sales", F64), fcol("qty", F64), fcol("profit", F64)],
            Schema((Field("channel", STR), Field("id", STR),
                    Field("sales", F64), Field("qty", F64),
                    Field("profit", F64))))

    ss = channel(("store_sales", "ss_ext_sales_price", "ss_quantity",
                  "ss_net_profit", "store channel"),
                 "ss_sold_date_sk", "ss_item_sk", "ss_promo_sk",
                 ("store", "ss_store_sk", "s_store_sk", "s_store_id"))
    cs = channel(("catalog_sales", "cs_ext_sales_price", "cs_quantity",
                  "cs_net_profit", "catalog channel"),
                 "cs_sold_date_sk", "cs_item_sk", "cs_promo_sk",
                 ("catalog_page", "cs_catalog_page_sk",
                  "cp_catalog_page_sk", "cp_catalog_page_id"))
    ws = channel(("web_sales", "ws_ext_sales_price", "ws_quantity",
                  "ws_net_profit", "web channel"),
                 "ws_sold_date_sk", "ws_item_sk", "ws_promo_sk",
                 ("web_site", "ws_web_site_sk", "web_site_sk",
                  "web_site_id"))
    union = ForeignNode("UnionExec", children=(ss, cs, ws),
                        output=ss.output)
    expand_out = Schema(tuple(union.output.fields) +
                        (Field("spark_grouping_id", I64),))
    expand = ForeignNode(
        "ExpandExec", children=(union,), output=expand_out,
        attrs={"projections": [
            [fcol("channel", STR), fcol("id", STR), fcol("sales", F64),
             fcol("qty", F64), fcol("profit", F64), flit(0, I64)],
            [fcol("channel", STR), flit(None, STR), fcol("sales", F64),
             fcol("qty", F64), fcol("profit", F64), flit(1, I64)],
            [flit(None, STR), flit(None, STR), fcol("sales", F64),
             fcol("qty", F64), fcol("profit", F64), flit(3, I64)]]})
    rolled = two_phase_agg(
        expand,
        grouping=[fcol("channel", STR), fcol("id", STR),
                  fcol("spark_grouping_id", I64)],
        group_fields=[Field("channel", STR), Field("id", STR),
                      Field("spark_grouping_id", I64)],
        aggs=[("total_sales", agg("Sum", fcol("sales", F64), F64),
               Field("total_sales", F64)),
              ("total_qty", agg("Sum", fcol("qty", F64), F64),
               Field("total_qty", F64)),
              ("total_profit", agg("Sum", fcol("profit", F64), F64),
               Field("total_profit", F64))])
    out = Schema((Field("channel", STR), Field("id", STR),
                  Field("spark_grouping_id", I64),
                  Field("total_sales", F64), Field("total_qty", F64),
                  Field("total_profit", F64)))
    return take_ordered(
        rolled,
        orders=[so(fcol("channel", STR)), so(fcol("id", STR)),
                so(fcol("spark_grouping_id", I64))],
        limit=100,
        project=[fcol("channel", STR), fcol("id", STR),
                 fcol("spark_grouping_id", I64), fcol("total_sales", F64),
                 fcol("total_qty", F64), fcol("total_profit", F64)],
        out=out)


# ---------------------------------------------------------------------------
# second variants of the four families the reference ships twice
# (tpcds-queries/ has q14a+q14b, q23a+q23b, q24a+q24b, q39a+q39b -> the
# corpus carries both shapes too: 99 families + these 4 = 103 entries)
# ---------------------------------------------------------------------------

@_q("q14u")
def q14u(cat: Catalog) -> ForeignNode:
    """q14 second variant (q14a shape): union-all of the three sales
    channels aggregated by brand, kept where channel-brand revenue beats
    the cross-channel average (global window avg over the union)."""
    def channel(tag, table, item_col, price_col):
        sc = cat.scan(table, [item_col, price_col])
        it = cat.scan("item", ["i_item_sk", "i_brand"])
        j = bhj(sc, it, fcol(item_col, I64), fcol("i_item_sk", I64))
        return fproject(
            j, [falias(flit(tag, STR), "channel"),
                fcol("i_brand", STR),
                falias(fcol(price_col, F64), "ext_price")],
            Schema((Field("channel", STR), Field("i_brand", STR),
                    Field("ext_price", F64))))
    un = ForeignNode(
        "UnionExec",
        children=(channel("store", "store_sales", "ss_item_sk",
                          "ss_ext_sales_price"),
                  channel("catalog", "catalog_sales", "cs_item_sk",
                          "cs_ext_sales_price"),
                  channel("web", "web_sales", "ws_item_sk",
                          "ws_ext_sales_price")),
        output=Schema((Field("channel", STR), Field("i_brand", STR),
                       Field("ext_price", F64))))
    grouped = two_phase_agg(
        un, grouping=[fcol("channel", STR), fcol("i_brand", STR)],
        group_fields=[Field("channel", STR), Field("i_brand", STR)],
        aggs=[("sales", agg("Sum", fcol("ext_price", F64), F64),
               Field("sales", F64))])
    single = ForeignNode(
        "ShuffleExchangeExec", children=(grouped,), output=grouped.output,
        attrs={"partitioning": {"mode": "single", "num_partitions": 1}})
    win_out = Schema(tuple(grouped.output.fields) +
                     (Field("avg_sales", F64),))
    win = ForeignNode(
        "WindowExec", children=(single,), output=win_out,
        attrs={"window_exprs": [
                   {"name": "avg_sales", "fn": "agg", "args": [],
                    "agg": agg("Average", fcol("sales", F64), F64),
                    "dtype": F64}],
               "partition_spec": [], "order_spec": []})
    heavy = ffilter(win, fcall("GreaterThan", fcol("sales", F64),
                               fcol("avg_sales", F64)))
    return take_ordered(
        heavy,
        orders=[so(fcol("channel", STR)), so(fcol("i_brand", STR))],
        limit=100,
        project=[fcol("channel", STR), fcol("i_brand", STR),
                 fcol("sales", F64)],
        out=Schema((Field("channel", STR), Field("i_brand", STR),
                    Field("sales", F64))))


@_q("q23c")
def q23c(cat: Catalog) -> ForeignNode:
    """q23 second variant (q23b shape): catalog + web revenue of frequent
    store items, grouped PER CUSTOMER (vs q23m's single scalar) and
    unioned across the two channels."""
    freq = two_phase_agg(
        cat.scan("store_sales", ["ss_item_sk"]),
        grouping=[fcol("ss_item_sk", I64)],
        group_fields=[Field("ss_item_sk", I64)],
        aggs=[("cnt", agg("Count", None, I64), Field("cnt", I64))])
    freq = ffilter(freq, fcall("GreaterThan", fcol("cnt", I64), flit(5)))

    def channel(table, item_col, cust_col, qty_col, price_col):
        sc = cat.scan(table, [item_col, cust_col, qty_col, price_col])
        sel = smj(sc, freq, [fcol(item_col, I64)],
                  [fcol("ss_item_sk", I64)], join_type="LeftSemi")
        cu = cat.scan("customer", ["c_customer_sk", "c_customer_id"])
        j = bhj(sel, cu, fcol(cust_col, I64), fcol("c_customer_sk", I64))
        pre = fproject(
            j, [fcol("c_customer_id", STR),
                falias(fcall("Multiply",
                             fcall("Cast", fcol(qty_col, I32), dtype=F64),
                             fcol(price_col, F64), dtype=F64), "sales")],
            Schema((Field("c_customer_id", STR), Field("sales", F64))))
        return two_phase_agg(
            pre, grouping=[fcol("c_customer_id", STR)],
            group_fields=[Field("c_customer_id", STR)],
            aggs=[("sales", agg("Sum", fcol("sales", F64), F64),
                   Field("sales", F64))])
    un = ForeignNode(
        "UnionExec",
        children=(channel("catalog_sales", "cs_item_sk",
                          "cs_bill_customer_sk", "cs_quantity",
                          "cs_sales_price"),
                  channel("web_sales", "ws_item_sk",
                          "ws_bill_customer_sk", "ws_quantity",
                          "ws_sales_price")),
        output=Schema((Field("c_customer_id", STR), Field("sales", F64))))
    return take_ordered(
        un, orders=[so(fcol("c_customer_id", STR)),
                    so(fcol("sales", F64), asc=False)],
        limit=100,
        project=[fcol("c_customer_id", STR), fcol("sales", F64)],
        out=Schema((Field("c_customer_id", STR), Field("sales", F64))))


@_q("q24c")
def q24c(cat: Catalog) -> ForeignNode:
    """q24 second variant (q24b shape: the literal-delta twin of q24s) —
    net paid on returned tickets restricted to ONE item class before
    aggregation, grouped by customer x store."""
    ss = cat.scan("store_sales",
                  ["ss_ticket_number", "ss_item_sk", "ss_store_sk",
                   "ss_customer_sk", "ss_sales_price"])
    sr = cat.scan("store_returns", ["sr_ticket_number", "sr_item_sk"])
    j0 = smj(ss, sr,
             [fcol("ss_ticket_number", I64), fcol("ss_item_sk", I64)],
             [fcol("sr_ticket_number", I64), fcol("sr_item_sk", I64)])
    st = cat.scan("store", ["s_store_sk", "s_store_name"])
    it = cat.scan("item", ["i_item_sk", "i_class"])
    it = ffilter(it, fcall("EqualTo", fcol("i_class", STR),
                           flit("class#7")))
    cu = cat.scan("customer", ["c_customer_sk", "c_customer_id"])
    j1 = bhj(j0, st, fcol("ss_store_sk", I64), fcol("s_store_sk", I64))
    j2 = bhj(j1, it, fcol("ss_item_sk", I64), fcol("i_item_sk", I64))
    j3 = bhj(j2, cu, fcol("ss_customer_sk", I64),
             fcol("c_customer_sk", I64))
    grouped = two_phase_agg(
        j3,
        grouping=[fcol("c_customer_id", STR), fcol("s_store_name", STR)],
        group_fields=[Field("c_customer_id", STR),
                      Field("s_store_name", STR)],
        aggs=[("netpaid", agg("Sum", fcol("ss_sales_price", F64), F64),
               Field("netpaid", F64))])
    return take_ordered(
        grouped,
        orders=[so(fcol("netpaid", F64), asc=False),
                so(fcol("c_customer_id", STR)),
                so(fcol("s_store_name", STR))],
        limit=100,
        project=[fcol("c_customer_id", STR), fcol("s_store_name", STR),
                 fcol("netpaid", F64)],
        out=Schema((Field("c_customer_id", STR),
                    Field("s_store_name", STR), Field("netpaid", F64))))


@_q("q39w")
def q39w(cat: Catalog) -> ForeignNode:
    """q39 second variant (q39b shape): identical to q39v except the
    first month additionally requires cov > a tighter threshold
    (reference delta: q39b.sql adds `inv1.cov > 1.5`)."""
    def month_stats(moy: int, suffix: str, cov_min: float) -> ForeignNode:
        inv = cat.scan("inventory", ["inv_date_sk", "inv_item_sk",
                                     "inv_warehouse_sk",
                                     "inv_quantity_on_hand"])
        dd = _dim_date(
            cat,
            fcall("And",
                  fcall("EqualTo", fcol("d_moy", I32), flit(moy)),
                  fcall("EqualTo", fcol("d_year", I32), flit(2000))),
            ["d_date_sk", "d_moy", "d_year"])
        j = bhj(inv, dd, fcol("inv_date_sk", I64), fcol("d_date_sk", I64))
        qty = fcall("Cast", fcol("inv_quantity_on_hand", I32), dtype=F64)
        grouped = two_phase_agg(
            j,
            grouping=[fcol("inv_warehouse_sk", I64),
                      fcol("inv_item_sk", I64)],
            group_fields=[Field("inv_warehouse_sk", I64),
                          Field("inv_item_sk", I64)],
            aggs=[("mean", agg("Average", qty, F64), Field("mean", F64)),
                  ("sdev", agg("StddevSamp", qty, F64),
                   Field("sdev", F64))])
        out = Schema((Field(f"w{suffix}", I64), Field(f"i{suffix}", I64),
                      Field(f"mean{suffix}", F64),
                      Field(f"sdev{suffix}", F64)))
        renamed = fproject(
            grouped,
            [falias(fcol("inv_warehouse_sk", I64), f"w{suffix}"),
             falias(fcol("inv_item_sk", I64), f"i{suffix}"),
             falias(fcol("mean", F64), f"mean{suffix}"),
             falias(fcol("sdev", F64), f"sdev{suffix}")],
            out)
        cov = fcall("Divide", fcol(f"sdev{suffix}", F64),
                    fcol(f"mean{suffix}", F64))
        return ffilter(renamed,
                       fcall("GreaterThan", cov, flit(cov_min)))

    # side 1 carries the extra tightened cov predicate; the generated
    # corpus' uniform quantities put cov around 0.5-0.6, so 0.52/0.4
    # keeps both the filter meaningful and the result non-empty
    m1 = month_stats(1, "1", 0.52)
    m2 = month_stats(2, "2", 0.4)
    j = smj(m1, m2, [fcol("w1", I64), fcol("i1", I64)],
            [fcol("w2", I64), fcol("i2", I64)])
    out = Schema((Field("w1", I64), Field("i1", I64),
                  Field("mean1", F64), Field("sdev1", F64),
                  Field("mean2", F64), Field("sdev2", F64)))
    return take_ordered(
        j,
        orders=[so(fcol("w1", I64)), so(fcol("i1", I64)),
                so(fcol("mean1", F64)), so(fcol("mean2", F64))],
        limit=100,
        project=[fcol("w1", I64), fcol("i1", I64), fcol("mean1", F64),
                 fcol("sdev1", F64), fcol("mean2", F64),
                 fcol("sdev2", F64)],
        out=out)

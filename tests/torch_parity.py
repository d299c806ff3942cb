"""Shared inputs for the parity tests of auron_tpu_torch against auron_tpu.

Both engines get the same numpy columns, made from a seed: the JAX
package as pyarrow RecordBatches, the port as (arrays, validities) pairs
(or the same RecordBatches).  Plans are built with the JAX package's IR
builders and shipped to both engines as serialized TaskDefinition bytes.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest
import torch

from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS

F64, I64, I32 = JDT.float64(), JDT.int64(), JDT.int32()
SRC_SCHEMA = JS.of(JF("ss_customer_sk", I64), JF("ss_quantity", I32),
                   JF("ss_sales_price", F64))
AGG_NAMES = ("sum_sales", "cnt_sales")
STATE_SCHEMA = JS.of(JF("ss_customer_sk", I64),
                     JF("sum_sales#sum", F64),
                     JF("cnt_sales#count", I64, nullable=False))


def make_sales(n: int, seed: int, n_keys: int = 500, null_frac: float = 0.05):
    """store_sales-shaped columns: key, quantity, price, each with nulls;
    key 7 has only null prices, so its sum is null and its count 0."""
    rng = np.random.default_rng(seed)
    sk = rng.integers(1, n_keys + 1, n, dtype=np.int64)
    qty = rng.integers(1, 101, n, dtype=np.int32)
    price = np.round(rng.random(n) * 200.0, 2)
    valid = [rng.random(n) >= null_frac for _ in range(3)]
    valid[2] &= sk != 7
    return [sk, qty, price], valid


def chunks(cols, valid, size: int):
    """(arrays, validities) pairs of `size` rows (views)."""
    n = len(cols[0])
    return [([c[s:s + size] for c in cols], [v[s:s + size] for v in valid])
            for s in range(0, n, size)]


def to_arrow(arrays, validities, schema=SRC_SCHEMA) -> pa.RecordBatch:
    from auron_tpu.ir.schema import to_arrow_type
    return pa.RecordBatch.from_arrays(
        [pa.array(a, type=to_arrow_type(f.dtype), mask=~v)
         for a, v, f in zip(arrays, validities, schema.fields)],
        names=list(schema.names()))


def sales_aggs():
    return (JE.AggExpr(fn="sum", children=(JE.col("sales"),),
                       return_type=F64),
            JE.AggExpr(fn="count", children=(JE.col("sales"),),
                       return_type=I64))


def projection(child):
    return JP.Projection(
        child=child,
        exprs=(JE.col("ss_customer_sk"),
               JE.BinaryExpr(left=JE.Cast(child=JE.col("ss_quantity"),
                                          dtype=F64),
                             op="*", right=JE.col("ss_sales_price"))),
        names=("ss_customer_sk", "sales"))


def partial_agg(child, skipping: bool = False):
    return JP.Agg(child=child, exec_mode="partial",
                  grouping=(JE.col("ss_customer_sk"),),
                  grouping_names=("ss_customer_sk",), aggs=sales_aggs(),
                  agg_names=AGG_NAMES, supports_partial_skipping=skipping)


def final_agg(child):
    return JP.Agg(child=child, exec_mode="final",
                  grouping=(JE.col("ss_customer_sk"),),
                  grouping_names=("ss_customer_sk",), aggs=sales_aggs(),
                  agg_names=AGG_NAMES)


def map_plan(n_parts: int):
    return JP.RssShuffleWriter(
        child=partial_agg(projection(
            JP.FFIReader(schema=SRC_SCHEMA, resource_id="store_sales"))),
        partitioning=JP.Partitioning(
            mode="hash", num_partitions=n_parts,
            expressions=(JE.col("ss_customer_sk"),)),
        rss_resource_id="shuffle_writer")


def reduce_plan():
    return final_agg(JP.IpcReader(schema=STATE_SCHEMA,
                                  resource_id="shuffle_read"))


def jax_columns(batches, names):
    """{name: (data, validity)} of JAX result RecordBatches."""
    out = {}
    for name in names:
        arrs = [rb.column(rb.schema.get_field_index(name)) for rb in batches]
        if not arrs:
            out[name] = (np.zeros(0), np.zeros(0, bool))
            continue
        col = pa.chunked_array(arrs).combine_chunks()
        valid = np.asarray(col.is_valid())
        if pa.types.is_date32(col.type):
            col = col.cast(pa.int32())
        elif pa.types.is_timestamp(col.type):
            col = col.cast(pa.int64())
        fill = False if pa.types.is_boolean(col.type) else 0
        out[name] = (np.asarray(col.fill_null(fill).to_numpy(
            zero_copy_only=False)), valid)
    return out


def keyed_rows(cols, key: str, names):
    """{key or None: tuple of (value or None) per name}, nulls as None."""
    kd, kv = cols[key]
    rows = {}
    for i in range(len(kd)):
        k = int(kd[i]) if kv[i] else None
        if k in rows:
            raise AssertionError(f"key {k} appears twice")
        rows[k] = tuple(cols[n][0][i].item() if cols[n][1][i] else None
                        for n in names)
    return rows


def assert_same_groups(got, exp, float_names=("sum_sales",),
                       names=("sum_sales", "cnt_sales")):
    """Unordered tables keyed on ss_customer_sk: same keys, ints exact,
    floats to relative 1e-9 (the engines sum in different orders)."""
    g = keyed_rows(got, "ss_customer_sk", names)
    e = keyed_rows(exp, "ss_customer_sk", names)
    assert set(g) == set(e)
    for k in e:
        for name, gv, ev in zip(names, g[k], e[k]):
            if ev is None or gv is None:
                assert gv is None and ev is None, (k, name, gv, ev)
            elif name in float_names:
                assert abs(gv - ev) <= 1e-9 * abs(ev), (k, name, gv, ev)
            else:
                assert gv == ev, (k, name, gv, ev)


# -- the global-sort stage pair ----------------------------------------------

SORT_NAMES = ("ss_customer_sk", "ss_quantity", "ss_sales_price")
# ORDER BY ss_sales_price DESC NULLS LAST, ss_customer_sk ASC NULLS FIRST
SORT_ORDERS = (("ss_sales_price", False, False),
               ("ss_customer_sk", True, True))


def sort_exprs():
    return tuple(JE.SortExpr(child=JE.col(name), asc=asc, nulls_first=nf)
                 for name, asc, nf in SORT_ORDERS)


def sort_map_plan(n_parts: int, bounds):
    """FFIReader -> Projection -> RssShuffleWriter(range, bounds)."""
    return JP.RssShuffleWriter(
        child=JP.Projection(
            child=JP.FFIReader(schema=SRC_SCHEMA, resource_id="store_sales"),
            exprs=tuple(JE.col(n) for n in SORT_NAMES), names=SORT_NAMES),
        partitioning=JP.Partitioning(
            mode="range", num_partitions=n_parts, sort_orders=sort_exprs(),
            range_bounds=bounds),
        rss_resource_id="shuffle_writer")


def sort_reduce_plan(fetch_limit=None, fetch_offset=0):
    """IpcReader -> Sort."""
    return JP.Sort(child=JP.IpcReader(schema=SRC_SCHEMA,
                                      resource_id="shuffle_read"),
                   sort_exprs=sort_exprs(), fetch_limit=fetch_limit,
                   fetch_offset=fetch_offset)


# -- one task through both engines -------------------------------------------

def plan_source(plan):
    """The resource id of a plan's leaf reader."""
    while not hasattr(plan, "resource_id"):
        plan = plan.child
    return plan.resource_id


def run_both(plan, jax_items, port_items, resources=None):
    """The same serialized TaskDefinition through auron_tpu and
    auron_tpu_torch (on the CPU), the leaf reader fed `jax_items` and
    `port_items`; `resources` adds (id, jax value, port value) triples.
    Returns (port ExecutionResult, JAX ExecutionResult)."""
    from auron_tpu.ir import serde as jserde
    from auron_tpu.runtime.executor import execute_task_bytes as jax_execute
    from auron_tpu.runtime.resources import ResourceRegistry as JaxResources
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    data = jserde.serialize(JP.TaskDefinition(plan=plan), codec="zlib")
    jres, res = JaxResources(), ResourceRegistry()
    jres.put(plan_source(plan), jax_items)
    res.put(plan_source(plan), port_items)
    for rid, jv, pv in resources or ():
        jres.put(rid, jv)
        res.put(rid, pv)
    port = execute_task_bytes(data, res, device="cpu")
    return port, jax_execute(data, jres)


def assert_same_rows(got, exp, names, float_rel=0.0):
    """Ordered tables: the same validity everywhere, the same values
    under it (floats to relative `float_rel`, 0 = bit for bit)."""
    for name in names:
        gd, gv = got[name]
        ed, ev = exp[name]
        np.testing.assert_array_equal(gv, ev, err_msg=name)
        gd, ed = gd[gv], ed[ev].astype(gd.dtype)
        if gd.dtype.kind == "f" and float_rel:
            np.testing.assert_allclose(gd, ed, rtol=float_rel, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(gd, ed, err_msg=name)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for a module that imports this fixture:
    its CPU runs are thousands of small ops, and the test workers'
    threads would otherwise contend for the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- a convert provider that claims the parquet scans --------------------------

def scan_provider(converters):
    """The port's `ScanSourceProvider` for either package (`converters`
    is its frontend.converters module): it claims every
    FileSourceScanExec as an FFIReader of the scan's output, one
    partition a file group, over a ForeignSource that wraps the scan
    for the session's foreign engine to read.  The JAX package has no
    such provider, so it gets the same one built over its own classes."""
    if hasattr(converters, "ScanSourceProvider"):
        return converters.ScanSourceProvider()
    from importlib import import_module
    plan = import_module(converters.__name__.replace("frontend.converters",
                                                     "ir.plan"))

    class ScanProvider(converters.ConvertProvider):
        def is_supported(self, node):
            return node.op == "FileSourceScanExec"

        def convert(self, node, children, ctx):
            rid = ctx.fresh("scan")
            ctx.sources[rid] = converters.ForeignSource(
                rid=rid, node=converters.ForeignWrap(node=node))
            return ctx.set_parts(
                plan.FFIReader(schema=node.output, resource_id=rid),
                len(node.attrs["file_groups"]))
    return ScanProvider()

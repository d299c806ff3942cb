"""String columns through whole stages, auron_tpu_torch against auron_tpu,
as the JAX package's converter lowers the plans over `it/datagen.py`
data at a small scale factor:
- TPC-DS q09c whole: a nested CASE into a string band, partial Count and
  Average by the band -> hash(4) on the string; final -> Sort(fetch 10)
  -> single; Sort(fetch 10) -> Projection;
- TPC-DS q41d whole: Filter -> partial Count by (i_brand, i_class) ->
  hash(4) on both strings; final -> Sort(fetch 100) -> single; Sort ->
  Projection;
- q01's customer exchange: the customer scan straight into hash(4) by
  c_customer_sk, c_customer_id carried;
- q01's take-ordered above its sort-merge join, by (c_customer_id,
  sr_store_sk, ctr_total_return DESC): the join swapped for an FFIReader
  of its output rows, as the pyarrow oracle computes them.
Every task goes to both engines as the same serialized TaskDefinition
bytes, and the stages chain through each engine's own in-process
shuffle.  Results are compared with `it/compare.py::compare_tables`,
against each other and against the oracle (`it/oracle.py::
PyArrowEngine`).  Also: a group-by whose batches differ in string width
(the same key forms one group), and that the plans chip_smoke.py runs in
phases 16 and 17 serialize to the converter's JSON.
"""

import dataclasses
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.it import compare, datagen, queries
from auron_tpu_torch.ops import kernels_cuda as K

import chip_smoke
from test_torch_corpus_aggs import _foreign, _oracle_table
from test_torch_corpus_aggs import _splits as table_splits
from test_torch_corpus_stages import (
    _Jax, _Port, _convert, _ipc_rids, _jax_json, _port_json, _run_exchange,
    _scan_of, _splits, _swap_job, _task, out_schema, swap_leaves,
)

SF = 0.01
N_SPLITS = 4          # map tasks over the join's output


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


def _jobs_by_rid(ctx):
    return {j.rid: j for j in ctx.exchanges.values()}


def _take_ordered_parts(name, cat):
    """(converted root, stage-1 job, stage-2 job) of q09c or q41d."""
    _, root, ctx = _convert(name, cat)
    by_rid = _jobs_by_rid(ctx)
    j2 = by_rid[_ipc_rids(root)[0]]
    j1 = by_rid[_ipc_rids(j2.child)[0]]
    return root, j1, j2


def run_query(E, name, cat):
    """q09c or q41d whole in engine E: (result table, map metrics)."""
    root, j1, j2 = _take_ordered_parts(name, cat)
    metrics = []
    b1 = _run_exchange(E, _swap_job(j1, "scan"), 1,
                       [{"scan": b} for b in _splits(_scan_of(j1.child))],
                       metrics)
    b2 = _run_exchange(E, j2, 2, [{j1.rid: E.blocks(b1)}] * len(b1), metrics)
    res = E.registry()
    res.put(j2.rid, E.blocks(b2))
    out = E.run(_task(root, 3, 0, 1), res)
    return E.table([out], out_schema(root)), metrics


def _customer_job(cat):
    _, _, ctx = _convert("q01", cat)
    [job] = [j for j in ctx.exchanges.values()
             if j.child.kind == "parquet_scan"
             and j.child.schema.names()[0] == "c_customer_sk"]
    return job


def _partition_tables(E, blocks, job):
    """Each reduce partition's rows of an exchange, read back through an
    IpcReader task of engine E."""
    res = E.registry()
    res.put(job.rid, E.blocks(blocks))
    reader = JP.IpcReader(schema=job.schema, resource_id=job.rid)
    return [E.table([E.run(_task(reader, 3, p, len(blocks)), res)],
                    job.schema) for p in range(len(blocks))]


def run_customer_exchange(E, cat):
    job = _customer_job(cat)
    metrics = []
    blocks = _run_exchange(E, _swap_job(job, "scan"), 1,
                           [{"scan": b} for b in _splits(job.child)],
                           metrics)
    return _partition_tables(E, blocks, job), metrics


def swap_smj(node, schema, rid="join"):
    """The plan with its sort-merge join an FFIReader of the join's
    output rows."""
    if node.kind == "sort_merge_join":
        return JP.FFIReader(schema=schema, resource_id=rid)
    kids = {f.name: swap_smj(getattr(node, f.name), schema, rid)
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), JP.PlanNode)}
    return dataclasses.replace(node, **kids) if kids else node


def q01_top_parts(cat):
    """(converted root, take-ordered job with the join swapped, foreign
    sort-merge join)."""
    plan, root, ctx = _convert("q01", cat)
    job = _jobs_by_rid(ctx)[_ipc_rids(root)[0]]
    [smj] = _foreign(plan, "SortMergeJoinExec")
    return root, dataclasses.replace(
        job, child=swap_smj(job.child, job.schema)), smj


def run_q01_top(E, cat):
    root, job, smj = q01_top_parts(cat)
    join = _oracle_table(smj)
    metrics = []
    blocks = _run_exchange(E, job, 2, [{"join": s} for s in
                                       table_splits(join, N_SPLITS)], metrics)
    res = E.registry()
    res.put(job.rid, E.blocks(blocks))
    out = E.run(_task(root, 3, 0, 1), res)
    return E.table([out], out_schema(root)), metrics, join


def _assert_writers_used_the_histogram(port_maps):
    assert all(m.get("sizes_by_hist", 0) == m.get("shuffle_write_batches", 0)
               for m in port_maps)
    assert sum(m.get("sizes_by_hist", 0) for m in port_maps) >= 1


@pytest.mark.parametrize("name", ["q09c", "q41d"])
def test_string_queries_match(name, catalog):
    K.reset_launches()
    port, port_maps = run_query(_Port, name, catalog)
    ref, _ = run_query(_Jax, name, catalog)
    orc = _oracle_table(queries.build(name, catalog))
    assert port.num_rows > 0
    assert compare.compare_tables(port, orc, ordered=True) is None
    assert compare.compare_tables(port, ref, ordered=True) is None
    # on the CPU the wrappers run their plain versions, never a kernel
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}
    _assert_writers_used_the_histogram(port_maps)


def test_q09c_bands(catalog):
    """Three rows in band order, the counts summing to the priced rows."""
    port, _ = run_query(_Port, "q09c", catalog)
    assert port.column("band").to_pylist() == ["1-20", "21-60", "61-100"]
    scan = _scan_of(_take_ordered_parts("q09c", catalog)[1].child)
    rows = pa.Table.from_batches([b for s in _splits(scan) for b in s])
    assert sum(port.column("cnt").to_pylist()) == \
        rows.column("ss_sales_price").drop_null().length()


def test_customer_exchange_matches(catalog):
    """Every partition holds the same rows in both engines, the union is
    the customer table, and each partition's keys hash there."""
    K.reset_launches()
    port, port_maps = run_customer_exchange(_Port, catalog)
    ref, _ = run_customer_exchange(_Jax, catalog)
    job = _customer_job(catalog)
    scan = pa.Table.from_batches([b for s in _splits(job.child) for b in s])
    assert len(port) == job.partitioning.num_partitions
    for p, (g, e) in enumerate(zip(port, ref)):
        assert g.num_rows > 0
        assert compare.compare_tables(g, e, ordered=False) is None, p
        sk = torch.from_numpy(g.column("c_customer_sk").to_numpy())
        pid = K.hash_partition_ids_i64_plain(
            sk, torch.ones(len(sk), dtype=torch.bool), len(port))
        assert bool((pid == p).all())
    assert compare.compare_tables(pa.concat_tables(port), scan,
                                  ordered=False) is None
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}
    _assert_writers_used_the_histogram(port_maps)


def test_q01_take_ordered_matches(catalog):
    K.reset_launches()
    port, port_maps, join = run_q01_top(_Port, catalog)
    ref, _, _ = run_q01_top(_Jax, catalog)
    orc = _oracle_table(queries.build("q01", catalog))
    assert 0 < port.num_rows <= 100
    assert compare.compare_tables(port, orc, ordered=True) is None
    assert compare.compare_tables(port, ref, ordered=True) is None
    # Spark's order of the same rows, as Python sorts them
    rows = join.to_pylist()
    rows.sort(key=lambda r: (r["c_customer_id"].encode(), r["sr_store_sk"],
                             -r["ctr_total_return"]))
    assert port.column("c_customer_id").to_pylist() == \
        [r["c_customer_id"] for r in rows[:100]]
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}
    _assert_writers_used_the_histogram(port_maps)


# -- a group-by whose batches differ in string width -------------------------

def _width_batches(seed, short_only):
    """Record batches of (k string, v int64): keys of at most 8 bytes
    alternating (unless `short_only`) with batches of keys up to 40
    bytes, the same keys in both, nulls in both columns."""
    rng = np.random.default_rng(seed)
    short = ["", "a", "ab", "ab\x00", "é", "zz", "Z", "日本"]
    long = short + ["a" * 9, "ab" * 10, "é" * 20, "x\x00" * 20, "ab\x00c" * 8]
    out = []
    for j in range(6):
        pool = short if short_only or j % 2 == 0 else long
        n = 300
        k = [pool[i] for i in rng.integers(0, len(pool), n)]
        kmask = rng.random(n) < 0.05
        v = rng.integers(-50, 50, n)
        vmask = rng.random(n) < 0.05
        out.append(pa.RecordBatch.from_arrays(
            [pa.array(k, type=pa.string(), mask=kmask),
             pa.array(v, type=pa.int64(), mask=vmask)], names=["k", "v"]))
    return out


def _width_job():
    i64 = JDT.int64()
    key = (JE.col("k"),)
    aggs = (JE.AggExpr(fn="count", children=(JE.col("v"),), return_type=i64),
            JE.AggExpr(fn="sum", children=(JE.col("v"),), return_type=i64))

    def agg(child, mode):
        return JP.Agg(child=child, exec_mode=mode, grouping=key,
                      grouping_names=("k",), aggs=aggs, agg_names=("n", "s"))
    src = JP.FFIReader(schema=JS.of(JF("k", JDT.string()), JF("v", i64)),
                       resource_id="src")
    states = JS.of(JF("k", JDT.string()), JF("n#count", i64, nullable=False),
                   JF("s#sum", i64))
    job = types.SimpleNamespace(
        rid="widths", child=agg(src, "partial"),
        partitioning=JP.Partitioning(mode="hash", num_partitions=4,
                                     expressions=key))
    return job, agg(JP.IpcReader(schema=states, resource_id="widths"),
                    "final")


def run_widths(E):
    job, reduce_plan = _width_job()
    inputs = [{"src": _width_batches(0, short_only=True)},
              {"src": _width_batches(1, short_only=False)}]
    blocks = _run_exchange(E, job, 1, inputs, [])
    res = E.registry()
    res.put(job.rid, E.blocks(blocks))
    outs = [E.run(_task(reduce_plan, 2, p, 4), res) for p in range(4)]
    return E.table(outs, out_schema(reduce_plan)), blocks


def test_groups_across_string_widths_match_the_reference():
    port, blocks = run_widths(_Port)
    ref, _ = run_widths(_Jax)
    assert compare.compare_tables(port, ref, ordered=False) is None
    # the reduce side got blocks of more than one width
    assert len({b.columns[0].width for part in blocks for b in part}) > 1
    keys = port.column("k").to_pylist()
    assert len(keys) == len(set(keys))
    exp = {}
    for seed, short_only in ((0, True), (1, False)):
        for rb in _width_batches(seed, short_only):
            for k, v in zip(rb.column(0).to_pylist(),
                            rb.column(1).to_pylist()):
                n, s = exp.get(k, (0, None))
                exp[k] = (n + (v is not None),
                          s if v is None else (s or 0) + v)
    got = {k: (n, s) for k, n, s in zip(keys, port.column("n").to_pylist(),
                                        port.column("s").to_pylist())}
    assert got == exp


# -- the card's plans are the converter's ------------------------------------

def _conv(job, child, scan_rid):
    return JP.RssShuffleWriter(
        child=swap_leaves(child, scan_rid, "shuffle_read"),
        partitioning=job.partitioning, rss_resource_id="shuffle_writer")


def test_chip_smoke_string_plans_are_the_converters(catalog):
    """Each plan chip_smoke.py runs in phases 16 and 17, built with the
    port's IR, serializes to the JSON of the plan the converter lowers,
    with the scan (or the join) an FFIReader under the card's resource
    ids."""
    for name, rid, built in (("q09c", "store_sales", chip_smoke.q09c_plans),
                             ("q41d", "item", chip_smoke.q41d_plans)):
        root, j1, j2 = _take_ordered_parts(name, catalog)
        s1, s2, s3 = built()
        assert _port_json(s1) == _jax_json(_conv(j1, j1.child, rid))
        assert _port_json(s2) == _jax_json(_conv(j2, j2.child, rid))
        assert _port_json(s3) == _jax_json(swap_leaves(root, rid,
                                                       "shuffle_read"))
    job = _customer_job(catalog)
    assert _port_json(chip_smoke.q01_customer_plan()) == \
        _jax_json(_conv(job, job.child, "customer"))
    root, job, _ = q01_top_parts(catalog)
    stage, top = chip_smoke.q01_top_plans()
    assert _port_json(stage) == _jax_json(_conv(job, job.child, "join"))
    assert _port_json(top) == _jax_json(swap_leaves(root, "join",
                                                    "shuffle_read"))

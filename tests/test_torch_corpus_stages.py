"""TPC-DS q96 and q88c whole, and the three aggregate stages of q01's
threshold subtree, through auron_tpu_torch and auron_tpu: the plans as
the JAX package's converter lowers them (`strategy.apply` +
`converters.convert_recursively`) over `it/datagen.py` data at a small
scale factor, with each parquet scan leaf swapped for an FFIReader fed
the same record batches.  Every task goes to both engines as the same
serialized TaskDefinition bytes; the stages chain through each engine's
own in-process shuffle.  Results are compared with
`it/compare.py::compare_tables`, and both with the pyarrow oracle
(`it/oracle.py::PyArrowEngine`), which decides a disagreement.

Also: the plans chip_smoke.py builds with the port's IR serialize to the
converter's JSON once the scan leaf is swapped, so the card runs what
the JAX package would ship.
"""

import dataclasses

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from auron_tpu import config as jconfig
from auron_tpu.frontend import converters, strategy
from auron_tpu.frontend.converters import ConvertContext
from auron_tpu.frontend.session import AuronSession
from auron_tpu.frontend.session import PartitionedBlocks as JaxBlocks
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.ir.schema import to_arrow_type
from auron_tpu.it import compare, datagen, queries
from auron_tpu.it.oracle import PyArrowEngine
from auron_tpu.ops.shuffle.writer import InProcessShuffleService as JaxShuffle
from auron_tpu.runtime.executor import execute_task_bytes as jax_execute
from auron_tpu.runtime.resources import ResourceRegistry as JaxResources
from auron_tpu_torch.ir import serde
from auron_tpu_torch.ops import kernels_cuda as K
from auron_tpu_torch.ops.shuffle.writer import (
    InProcessShuffleService, PartitionedBlocks,
)
from auron_tpu_torch.runtime.executor import execute_task_bytes
from auron_tpu_torch.runtime.resources import ResourceRegistry

import chip_smoke

SF = 0.01
SCAN_BATCH = 1000


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


def _convert(name, cat):
    plan = queries.build(name, cat)
    ctx = ConvertContext()
    root = converters.convert_recursively(plan, strategy.apply(plan), ctx)
    return plan, root, ctx


def swap_leaves(node, scan_rid, ipc_rid=None):
    """The plan with each parquet scan an FFIReader of the same schema
    under `scan_rid`, and, with `ipc_rid`, every IPC reader's resource
    renamed to it."""
    if node.kind == "parquet_scan":
        return JP.FFIReader(schema=node.schema, resource_id=scan_rid)
    if node.kind == "ipc_reader" and ipc_rid is not None:
        return dataclasses.replace(node, resource_id=ipc_rid)
    kids = {f.name: swap_leaves(getattr(node, f.name), scan_rid, ipc_rid)
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), JP.PlanNode)}
    return dataclasses.replace(node, **kids) if kids else node


def _scan_of(node):
    if node.kind == "parquet_scan":
        return node
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, JP.PlanNode):
            found = _scan_of(v)
            if found is not None:
                return found
    return None


def _splits(scan):
    """One list of record batches per file group (one map task each)."""
    names = [f.name for f in scan.schema.fields]
    return [pq.read_table(list(g.paths), columns=names)
            .combine_chunks().to_batches(max_chunksize=SCAN_BATCH)
            for g in scan.file_groups]


class _Port:
    shuffle = InProcessShuffleService
    registry = ResourceRegistry
    blocks = PartitionedBlocks

    @staticmethod
    def run(data, res):
        return execute_task_bytes(data, res, device="cpu")

    @staticmethod
    def table(results, schema):
        cols = {f.name: [] for f in schema.fields}
        for r in results:
            for name, (d, v) in r.to_numpy().items():
                cols[name].append((d, v))
        arrays = []
        for f in schema.fields:
            d = np.concatenate([x[0] for x in cols[f.name]])
            v = np.concatenate([x[1] for x in cols[f.name]])
            arrays.append(pa.array(d, type=to_arrow_type(f.dtype), mask=~v))
        return pa.Table.from_arrays(arrays, names=[f.name
                                                   for f in schema.fields])


class _Jax:
    shuffle = JaxShuffle
    registry = JaxResources
    blocks = JaxBlocks

    @staticmethod
    def run(data, res):
        return jax_execute(data, res)

    @staticmethod
    def table(results, schema):
        return pa.Table.from_batches([b for r in results for b in r.batches])


def _task(plan, stage, p, n):
    return jserde.serialize(JP.TaskDefinition(
        plan=plan, stage_id=stage, partition_id=p, num_partitions=n),
        codec="zlib")


def _run_exchange(E, job, stage, inputs, metrics):
    """Map tasks of `job` (RssShuffleWriter over its child), one per
    entry of `inputs` (the resources that task reads), then the reduce
    side's blocks per partition."""
    svc = E.shuffle()
    plan = JP.RssShuffleWriter(child=job.child, partitioning=job.partitioning,
                               rss_resource_id="shuffle_writer")
    for m, extra in enumerate(inputs):
        res = E.registry()
        for k, v in extra.items():
            res.put(k, v)
        res.put("shuffle_writer", svc.rss_writer(job.rid, m))
        out = E.run(_task(plan, stage, m, len(inputs)), res)
        metrics.append(getattr(out, "metrics", {}))
    return [svc.reduce_blocks(job.rid, p)
            for p in range(job.partitioning.num_partitions)]


def _swap_job(job, scan_rid):
    return dataclasses.replace(job, child=swap_leaves(job.child, scan_rid))


def run_query(E, name, cat):
    """The converted stages of q96, q88c or q01's threshold subtree in
    engine E; returns (result table, map-task metrics)."""
    _, root, ctx = _convert(name, cat)
    metrics = []
    jobs = list(ctx.exchanges.values())
    if name in ("q96", "q88c"):
        [job] = jobs
        scan = _scan_of(job.child)
        job = _swap_job(job, "scan")
        blocks = _run_exchange(E, job, 1, [{"scan": b} for b in
                                           _splits(scan)], metrics)
        res = E.registry()
        res.put(job.rid, E.blocks(blocks))
        out = E.run(_task(root, 2, 0, 1), res)
        return E.table([out], out_schema(root)), metrics
    # q01: shuffle 1 (scan -> partial sum -> hash(4) on two keys), shuffle
    # 2 (final sum -> partial avg -> hash(2) on the store), then the
    # broadcast side (final avg -> threshold projection) per partition
    by_rid = {j.rid: j for j in jobs}
    [bc] = ctx.broadcasts.values()
    j2 = by_rid[_ipc_rids(bc.child)[0]]
    j1 = by_rid[_ipc_rids(j2.child)[0]]
    scan = _scan_of(j1.child)
    j1 = _swap_job(j1, "scan")
    b1 = _run_exchange(E, j1, 1, [{"scan": b} for b in _splits(scan)],
                       metrics)
    b2 = _run_exchange(E, j2, 2, [{j1.rid: E.blocks(b1)}] * len(b1),
                       metrics)
    outs = []
    for p in range(len(b2)):
        res = E.registry()
        res.put(j2.rid, E.blocks(b2))
        outs.append(E.run(_task(bc.child, 3, p, len(b2)), res))
    return E.table(outs, out_schema(bc.child)), metrics


def _ipc_rids(node):
    if node.kind == "ipc_reader":
        return [node.resource_id]
    return [r for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), JP.PlanNode)
            for r in _ipc_rids(getattr(node, f.name))]


def out_schema(node):
    from auron_tpu.runtime.planner import PhysicalPlanner as JaxPlanner
    return JaxPlanner().create_plan(node).schema


def _find(node, names):
    """The foreign node whose output columns are `names`."""
    if node.output is not None and tuple(node.output.names()) == names:
        return node
    for c in node.children:
        hit = _find(c, names)
        if hit is not None:
            return hit
    return None


def oracle(name, cat):
    plan = queries.build(name, cat)
    if name == "q01":
        plan = _find(plan, ("avg_store_sk", "threshold"))
    with jconfig.conf.scoped({"auron.enable": False}):
        return AuronSession(foreign_engine=PyArrowEngine()).execute(
            plan).table


@pytest.mark.parametrize("name", ["q96", "q88c", "q01"])
def test_corpus_stages_match(name, catalog):
    K.reset_launches()
    port, port_maps = run_query(_Port, name, catalog)
    ref, _ = run_query(_Jax, name, catalog)
    orc = oracle(name, catalog)
    ordered = name != "q01"
    assert port.num_rows > 0
    assert compare.compare_tables(port, orc, ordered=ordered) is None
    assert compare.compare_tables(port, ref, ordered=ordered) is None
    # on the CPU the wrappers run their plain versions, never a kernel
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}
    assert all(m.get("sizes_by_hist", 0) >= 1 for m in port_maps)


def test_q01_threshold_is_per_store(catalog):
    """One row per sr_store_sk (a null store would be a group of its
    own: Spark groups nulls), each 1.2 x the mean of its (customer,
    store) sums."""
    port, _ = run_query(_Port, "q01", catalog)
    _, _, ctx = _convert("q01", catalog)
    scan = _scan_of(next(iter(ctx.exchanges.values())).child)
    t = pa.Table.from_batches([b for s in _splits(scan) for b in s])
    cust = t.column("sr_customer_sk").to_pylist()
    store = t.column("sr_store_sk").to_pylist()
    amt = t.column("sr_return_amt").to_pylist()
    sums = {}
    for c, s, a in zip(cust, store, amt):
        cur = sums.get((c, s))
        sums[(c, s)] = cur if a is None else (cur or 0.0) + a
    per_store = {}
    for (c, s), v in sums.items():
        if v is not None:
            per_store.setdefault(s, []).append(v)
    got = dict(zip(port.column("avg_store_sk").to_pylist(),
                   port.column("threshold").to_pylist()))
    assert set(got) == set(s for _, s in sums)
    for s, vals in per_store.items():
        exp = 1.2 * (sum(vals) / len(vals))
        assert abs(got[s] - exp) <= 1e-9 * abs(exp)


# -- the card's plans are the converter's ------------------------------------

def _jax_json(node):
    return jserde.to_json(node)


def _port_json(node):
    return serde.to_json(node)


def test_chip_smoke_plans_are_the_converters(catalog):
    """Each plan chip_smoke.py runs on the card, built with the port's
    IR, serializes to the JSON of the plan the converter lowers, with
    the scan leaf an FFIReader under the card's resource ids."""
    def conv_map(job, scan_rid):
        return JP.RssShuffleWriter(
            child=swap_leaves(job.child, scan_rid, "shuffle_read"),
            partitioning=job.partitioning, rss_resource_id="shuffle_writer")

    for name in ("q96", "q88c"):
        _, root, ctx = _convert(name, catalog)
        [job] = ctx.exchanges.values()
        card_map, card_reduce = chip_smoke.store_sales_plans(name)
        assert _port_json(card_map) == _jax_json(conv_map(job, "store_sales"))
        assert _port_json(card_reduce) == _jax_json(
            swap_leaves(root, "store_sales", "shuffle_read"))
    _, _, ctx = _convert("q01", catalog)
    [bc] = ctx.broadcasts.values()
    by_rid = {j.rid: j for j in ctx.exchanges.values()}
    j2 = by_rid[_ipc_rids(bc.child)[0]]
    j1 = by_rid[_ipc_rids(j2.child)[0]]
    s1, s2, s3 = chip_smoke.q01_plans()
    assert _port_json(s1) == _jax_json(conv_map(j1, "store_returns"))
    assert _port_json(s2) == _jax_json(conv_map(j2, "store_returns"))
    assert _port_json(s3) == _jax_json(
        swap_leaves(bc.child, "store_returns", "shuffle_read"))

"""The aggregations above the joins of TPC-DS q17m and q39v through
auron_tpu_torch and auron_tpu, as the JAX package's converter lowers
them, over `it/datagen.py` data at a small scale factor.

The port has no joins yet, so each plan is cut at its partial
aggregate's child: both engines read the join's output rows, as the
pyarrow oracle (`it/oracle.py::PyArrowEngine`) computes them, through an
FFIReader of the join's output schema.  Every task goes to both engines
as the same serialized TaskDefinition bytes, and the stages chain
through each engine's own in-process shuffle:
- q17m: partial Min, Max, Average and Count by ss_store_sk -> hash(4);
  final -> Sort(fetch 100) -> single; Sort(fetch 100) -> Projection.
- q39v's month_stats, for January and February: partial Average and
  StddevSamp of cast(qty as double) by (warehouse, item) -> hash(4);
  final -> Projection(rename) -> Filter(sdev / mean > 0.4) -> hash(4).
Results are compared with `it/compare.py::compare_tables`, against each
other and against the oracle, which runs the whole subtree, join
included.  The generated data holds no NaN and no -0.0, so neither the
NaN Min of the JAX package (ROADMAP Queue 3 item 11) nor its float keys
(item 12) come into it; tests/test_torch_agg_rest.py holds those.

Also: the plans chip_smoke.py builds for phases 13 and 14 serialize to
the converter's JSON once the join is swapped for the FFIReader.
"""

import dataclasses

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu import config as jconfig
from auron_tpu.frontend.session import AuronSession
from auron_tpu.ir import plan as JP
from auron_tpu.ir.schema import to_arrow_type
from auron_tpu.it import compare, datagen
from auron_tpu.it.oracle import PyArrowEngine
from auron_tpu_torch.ops import kernels_cuda as K

import chip_smoke
from test_torch_corpus_stages import (
    _Jax, _Port, _convert, _ipc_rids, _jax_json, _port_json, _run_exchange,
    _task, out_schema, swap_leaves,
)

SF = 0.01
SCAN_BATCH = 1000
N_SPLITS = 4          # map tasks over the join's output


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


def _foreign(node, op):
    """The foreign nodes named `op`, depth first."""
    out = []
    node.foreach(lambda n: out.append(n) if n.op == op else None)
    return out


def _oracle_table(node):
    with jconfig.conf.scoped({"auron.enable": False}):
        return AuronSession(foreign_engine=PyArrowEngine()).execute(
            node).table


def swap_join(agg, join_schema, rid="join"):
    """The partial Agg over an FFIReader of the join's output rows."""
    return dataclasses.replace(
        agg, child=JP.FFIReader(schema=join_schema, resource_id=rid))


def _splits(table, n):
    """n contiguous splits of the join's rows as record-batch lists."""
    rows = table.num_rows
    out = []
    for m in range(n):
        lo, hi = m * rows // n, (m + 1) * rows // n
        out.append(table.slice(lo, hi - lo).combine_chunks()
                   .to_batches(max_chunksize=SCAN_BATCH))
    return out


def _jobs(ctx):
    return list(ctx.exchanges.values())


def _partial_jobs(ctx):
    return [j for j in _jobs(ctx) if j.child.kind == "agg"
            and j.child.exec_mode == "partial"]


def q17m_parts(cat):
    """(converted root, stage-1 job, stage-2 job, foreign join)."""
    plan, root, ctx = _convert("q17m", cat)
    [j1] = _partial_jobs(ctx)
    by_rid = {j.rid: j for j in _jobs(ctx)}
    j2 = by_rid[_ipc_rids(root)[0]]
    [smj] = _foreign(plan, "SortMergeJoinExec")
    return root, j1, j2, smj


def q39v_parts(cat):
    """[(stage-1 job, stage-2 job, foreign join, foreign month root)] for
    January and February."""
    plan, _, ctx = _convert("q39v", cat)
    partial = _partial_jobs(ctx)
    filters = [j for j in _jobs(ctx) if j.child.kind == "filter"]
    joins = _foreign(plan, "BroadcastHashJoinExec")
    months = _foreign(plan, "FilterExec")
    months = [m for m in months if m.output is not None and
              m.output.names()[0] in ("w1", "w2")]
    assert len(partial) == len(filters) == len(joins) == len(months) == 2
    return list(zip(partial, filters, joins, months))


def run_q17m(E, cat):
    root, j1, j2, smj = q17m_parts(cat)
    join = _oracle_table(smj)
    job1 = dataclasses.replace(j1, child=swap_join(j1.child, smj.output))
    metrics = []
    b1 = _run_exchange(E, job1, 1, [{"join": s} for s in
                                    _splits(join, N_SPLITS)], metrics)
    b2 = _run_exchange(E, j2, 2, [{j1.rid: E.blocks(b1)}] * len(b1),
                       metrics)
    res = E.registry()
    res.put(j2.rid, E.blocks(b2))
    out = E.run(_task(root, 3, 0, 1), res)
    return E.table([out], out_schema(root)), metrics


def run_q39v_month(E, cat, month):
    j1, j2, bhj, _ = q39v_parts(cat)[month]
    join = _oracle_table(bhj)
    job1 = dataclasses.replace(j1, child=swap_join(j1.child, bhj.output))
    metrics = []
    b1 = _run_exchange(E, job1, 1, [{"join": s} for s in
                                    _splits(join, N_SPLITS)], metrics)
    b2 = _run_exchange(E, j2, 2, [{j1.rid: E.blocks(b1)}] * len(b1),
                       metrics)
    return _blocks_table(E, b2, j2), metrics


def _blocks_table(E, blocks, job):
    """The rows an exchange's blocks hold, as one table."""
    schema = out_schema(job.child)
    if E is _Port:
        cols = []
        for f_i, f in enumerate(schema.fields):
            d = [b.columns[f_i].data[:b.num_rows].numpy()
                 for p in blocks for b in p]
            v = [b.columns[f_i].validity[:b.num_rows].numpy()
                 for p in blocks for b in p]
            cols.append(pa.array(np.concatenate(d), mask=~np.concatenate(v),
                                 type=to_arrow_type(f.dtype)))
        return pa.Table.from_arrays(cols, names=[f.name
                                                 for f in schema.fields])
    res = E.registry()
    res.put(job.rid, E.blocks(blocks))
    reader = JP.IpcReader(schema=schema, resource_id=job.rid)
    outs = [E.run(_task(reader, 3, p, len(blocks)), res)
            for p in range(len(blocks))]
    return E.table(outs, schema)


@pytest.mark.parametrize("case", ["q17m", "q39v_jan", "q39v_feb"])
def test_corpus_aggs_match(case, catalog):
    K.reset_launches()
    if case == "q17m":
        port, port_maps = run_q17m(_Port, catalog)
        ref, _ = run_q17m(_Jax, catalog)
        root = _convert("q17m", catalog)[0]
        orc = _oracle_table(root)
        ordered = True
    else:
        month = 0 if case == "q39v_jan" else 1
        port, port_maps = run_q39v_month(_Port, catalog, month)
        ref, _ = run_q39v_month(_Jax, catalog, month)
        orc = _oracle_table(q39v_parts(catalog)[month][3])
        ordered = False
    assert port.num_rows > 0
    assert compare.compare_tables(port, orc, ordered=ordered) is None
    assert compare.compare_tables(port, ref, ordered=ordered) is None
    # on the CPU the wrappers run their plain versions, never a kernel
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}
    # every writer batch counted its partition sizes with the histogram
    assert all(m.get("sizes_by_hist", 0) == m.get("shuffle_write_batches", 0)
               for m in port_maps)
    assert sum(m.get("sizes_by_hist", 0) for m in port_maps) >= N_SPLITS


def test_q17m_holds_min_max_count_per_store(catalog):
    """Each store's Min and Max of ss_quantity and its Count, from the
    joined rows themselves; 100 rows at most, in store order."""
    port, _ = run_q17m(_Port, catalog)
    _, _, _, smj = q17m_parts(catalog)
    join = _oracle_table(smj)
    per = {}
    for s, q, t in zip(join.column("ss_store_sk").to_pylist(),
                       join.column("ss_quantity").to_pylist(),
                       join.column("ss_ticket_number").to_pylist()):
        mn, mx, n = per.get(s, (None, None, 0))
        if q is not None:
            mn = q if mn is None else min(mn, q)
            mx = q if mx is None else max(mx, q)
        per[s] = (mn, mx, n + (t is not None))
    stores = port.column("ss_store_sk").to_pylist()
    assert stores == sorted(per, key=lambda s: (s is not None, s))[:100]
    for s, mn, mx, n in zip(stores, port.column("min_q").to_pylist(),
                            port.column("max_q").to_pylist(),
                            port.column("n").to_pylist()):
        assert (mn, mx, n) == per[s]


# -- the card's plans are the converter's ------------------------------------

def test_chip_smoke_agg_plans_are_the_converters(catalog):
    """Each plan chip_smoke.py runs in phases 13 and 14, built with the
    port's IR, serializes to the JSON of the plan the converter lowers,
    with the join an FFIReader under the card's resource ids."""
    def conv(job, child):
        return JP.RssShuffleWriter(
            child=swap_leaves(child, "join", "shuffle_read"),
            partitioning=job.partitioning, rss_resource_id="shuffle_writer")

    root, j1, j2, smj = q17m_parts(catalog)
    s1, s2, s3 = chip_smoke.q17m_plans()
    assert _port_json(s1) == _jax_json(conv(j1, swap_join(j1.child,
                                                          smj.output)))
    assert _port_json(s2) == _jax_json(conv(j2, j2.child))
    assert _port_json(s3) == _jax_json(swap_leaves(root, "join",
                                                   "shuffle_read"))
    for moy, (j1, j2, bhj, _) in zip((1, 2), q39v_parts(catalog)):
        m1, m2 = chip_smoke.q39v_plans(moy)
        assert _port_json(m1) == _jax_json(conv(j1, swap_join(j1.child,
                                                              bhj.output)))
        assert _port_json(m2) == _jax_json(conv(j2, j2.child))

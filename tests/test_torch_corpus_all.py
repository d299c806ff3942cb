"""Every query of the IT corpus (`auron_tpu/it/queries.py`) through
auron_tpu_torch on the CPU, whole, against the pyarrow oracle.

Each query is converted as `test_torch_corpus_stages.py::_convert` does
(the JAX package's `strategy.apply` + `converters.convert_recursively`)
over `it/datagen.py` data at SF 0.01, seed 7.  Its stages run in
dependency order as `test_torch_corpus_joins.py::run_converted` runs
them, generalized to a stage with several scans: each parquet scan
becomes an FFIReader of its own, and a stage over a union runs one task
per union partition, each fed the file group its assignment names.
Each task goes through `execute_task_bytes`, so it runs as the port
runs by default: verified (the suite sets `auron.plan.verify`), its
row-local chains fused (`auron.fuse.enable`; 14 queries hold
fragments: expand <- projection under a partial aggregation,
projection <- filter and filter <- projection under an exchange, their
partition ids fused, or under a sort) and then built.  All 103 queries run fused and
must equal the oracle under `compare_tables(ordered=True)`; every
query the port cannot build is listed
with the refusal it raises, so a slice that unblocks one has to move it
into the run set.
"""

import dataclasses

import pytest

from auron_tpu.ir import plan as JP
from auron_tpu.ir.node import Node as JNode
from auron_tpu.it import compare, datagen, queries
from auron_tpu_torch.ir import serde
from auron_tpu_torch.ops import kernels_cuda as K
from auron_tpu_torch.runtime.planner import PhysicalPlanner

from test_torch_corpus_aggs import _oracle_table
from test_torch_corpus_joins import _PortE
from test_torch_corpus_stages import (
    _convert, _jax_json, _splits, _task, out_schema,
)
from torch_parity import one_thread  # noqa: F401  (autouse)

SF = 0.01

# the queries the port cannot build yet, each with its refusal (none
# since the window, union, expand, string equality and round/coalesce)
REFUSED = {}


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


def _swap_scans(node, scans):
    """The plan with each parquet scan an FFIReader under `scan<k>`, k
    its index in `scans` (appended on first sight: a union repeats its
    child once per partition)."""
    if isinstance(node, tuple):
        return tuple(_swap_scans(x, scans) for x in node)
    if not isinstance(node, JNode):
        return node
    if node.kind == "parquet_scan":
        k = next((i for i, x in enumerate(scans) if x is node), None)
        if k is None:
            scans.append(node)
            k = len(scans) - 1
        return JP.FFIReader(schema=node.schema, resource_id=f"scan{k}")
    kids = {f.name: _swap_scans(getattr(node, f.name), scans)
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), (JNode, tuple))}
    return dataclasses.replace(node, **kids) if kids else node


def _walk(node):
    if isinstance(node, tuple):
        for x in node:
            yield from _walk(x)
        return
    if not isinstance(node, JNode):
        return
    yield node
    for f in dataclasses.fields(node):
        yield from _walk(getattr(node, f.name))


def _rids(node, kind):
    return [n.resource_id for n in _walk(node) if n.kind == kind]


def _tasks(plan, jobs):
    """(plan, per-task resources) of a stage: one task per union
    partition, per scan file group, or per partition of the exchange
    the stage reads."""
    union = next((n for n in _walk(plan) if n.kind == "union"), None)
    scans = []
    plan = _swap_scans(plan, scans)
    splits = [_splits(s) for s in scans]
    empty = {f"scan{k}": [] for k in range(len(scans))}
    if union is not None:
        tasks = []
        for p in range(union.num_partitions):
            res = dict(empty)
            for inp in union.inputs:
                if inp.out_partition != p:
                    continue
                sub = []
                _swap_scans(inp.child, sub)
                for s in sub:
                    k = next(i for i, x in enumerate(scans) if x is s)
                    res[f"scan{k}"] = splits[k][inp.partition]
            tasks.append(res)
        return plan, tasks
    if scans:
        n = len(splits[0])
        return plan, [{f"scan{k}": sp[m] if m < len(sp) else []
                       for k, sp in enumerate(splits)} for m in range(n)]
    dep = next(r for r in _rids(plan, "ipc_reader")
               if jobs[r][0] == "shuffle")
    return plan, [{}] * jobs[dep][1].partitioning.num_partitions


def run_query(E, name, cat):
    """The converted query whole in engine E; returns its result table."""
    _, root, ctx = _convert(name, cat)
    jobs = {j.rid: ("shuffle", j) for j in ctx.exchanges.values()}
    jobs.update({j.rid: ("broadcast", j) for j in ctx.broadcasts.values()})
    done, stage = {}, [0]

    def run_stage(child, rid=None, job=None):
        for dep in dict.fromkeys(_rids(child, "ipc_reader")):
            ensure(dep)
        plan, inputs = _tasks(child, jobs)
        stage[0] += 1
        res = E.registry()
        for r, v in done.items():
            res.put(r, v)
        svc = E.shuffle() if job is not None else None
        if svc is not None:
            plan = JP.RssShuffleWriter(child=plan,
                                       partitioning=job.partitioning,
                                       rss_resource_id="shuffle_writer")
        outs = []
        for m, extra in enumerate(inputs):
            for k, v in extra.items():
                res.put(k, v)
            if svc is not None:
                res.put("shuffle_writer", svc.rss_writer(rid, m))
            outs.append(E.run(_task(plan, stage[0], m, len(inputs)), res))
        return outs, svc

    def ensure(rid):
        if rid in done:
            return
        kind, job = jobs[rid]
        if kind == "shuffle":
            _, svc = run_stage(job.child, rid, job)
            done[rid] = E.blocks([svc.reduce_blocks(rid, p) for p in
                                  range(job.partitioning.num_partitions)])
        else:
            outs, _ = run_stage(job.child)
            done[rid] = E.broadcast(outs)

    [out], _ = run_stage(root)
    return E.table([out], out_schema(root))


def build_refusal(name, cat):
    """The first refusal of the port's serde or planner over the query's
    stage plans, or None when every stage builds."""
    _, root, ctx = _convert(name, cat)
    plans = [root] + [j.child for j in ctx.exchanges.values()] + \
        [j.child for j in ctx.broadcasts.values()]
    for p in plans:
        try:
            PhysicalPlanner().create_plan(
                serde.from_json(_jax_json(_swap_scans(p, []))))
        except NotImplementedError as e:
            return str(e)
    return None


RUN = [q for q in queries.names() if q not in REFUSED]


@pytest.mark.parametrize("name", queries.names())
def test_build_refusal_is_the_listed_one(name, catalog):
    assert build_refusal(name, catalog) == REFUSED.get(name)


@pytest.mark.parametrize("name", RUN)
def test_query_runs_whole_and_equals_the_oracle(name, catalog):
    K.reset_launches()
    port = run_query(_PortE, name, catalog)
    orc = _oracle_table(queries.build(name, catalog))
    assert compare.compare_tables(port, orc, ordered=True) is None
    # on the CPU the wrappers run their plain versions, never a kernel
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}

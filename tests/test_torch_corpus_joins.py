"""TPC-DS q01, q17m and q39v whole through auron_tpu_torch and auron_tpu,
joins included, as the JAX package's converter lowers them over
`it/datagen.py` data at a small scale factor:
- q01: two store_returns scans -> partial Sum -> hash(4); final Sum ->
  partial Average -> hash(2); the broadcast threshold (final Average ->
  Projection); final Sum -> BroadcastJoin (its build side a
  BroadcastJoinBuildHashMap over the broadcast) -> Filter -> hash(4);
  the customer scan -> hash(4); Sort, Sort -> SortMergeJoin -> Sort
  fetch 100 -> single; Sort fetch 100 -> Projection;
- q17m: the store_sales and store_returns scans -> hash(4) on (ticket,
  item); Sort, Sort -> SortMergeJoin on two keys -> partial Min, Max,
  Average, Count -> hash(4); final -> Sort fetch 100 -> single; root;
- q39v: per month, a broadcast of the month's date_dim rows and the
  inventory scan -> BroadcastJoin -> partial Average, StddevSamp ->
  hash(4); final -> Projection -> Filter -> hash(4); then Sort, Sort ->
  SortMergeJoin on two keys -> Sort fetch 100 -> single; root.
Every stage runs in each engine: map tasks one per scan file group or
per partition of the exchange they read, a broadcast collected from its
child's tasks (the JAX package's as IPC bytes, as its session collects
it; the port's as its device batches), each stage's tasks sharing one
resource registry, so a broadcast's build table is built once a stage.
Every task goes to both engines as the same serialized TaskDefinition
bytes.  Results are compared with `it/compare.py::compare_tables`
(ordered: each query ends in a take-ordered), against each other and
against the pyarrow oracle (`it/oracle.py::PyArrowEngine`).

Also: the plans chip_smoke.py builds for these queries serialize to the
converter's JSON, with each scan an FFIReader and each exchange and
broadcast under the card's resource ids.
"""

import dataclasses
import io

import pytest

from auron_tpu.ir import plan as JP
from auron_tpu.it import compare, datagen, queries
from auron_tpu_torch.ops import kernels_cuda as K

import chip_smoke
from test_torch_corpus_aggs import _oracle_table
from test_torch_corpus_stages import (
    _Jax, _Port, _convert, _ipc_rids, _jax_json, _port_json, _scan_of,
    _splits, _task, out_schema, swap_leaves,
)

SF = 0.01
QUERIES = ["q01", "q17m", "q39v"]


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


class _PortE(_Port):
    @staticmethod
    def broadcast(results):
        return [b for r in results for b in r.batches]


class _JaxE(_Jax):
    @staticmethod
    def broadcast(results):
        from auron_tpu.columnar import serde as batch_serde
        sink = io.BytesIO()
        codec = batch_serde.exchange_codec("local")
        for r in results:
            for rb in r.batches:
                if rb.num_rows:
                    batch_serde.write_one_batch(rb, sink, codec=codec)
        return sink.getvalue()


def run_converted(E, name, cat):
    """The converted query whole in engine E: every exchange and
    broadcast in dependency order, then the root task.  Returns (result
    table, per-task metrics by job kind)."""
    _, root, ctx = _convert(name, cat)
    jobs = {j.rid: ("shuffle", j) for j in ctx.exchanges.values()}
    jobs.update({j.rid: ("broadcast", j) for j in ctx.broadcasts.values()})
    done, metrics, stage = {}, {"shuffle": [], "broadcast": []}, [0]

    def tasks_of(child):
        """(plan, per-task extra resources) of a stage over `child`."""
        scan = _scan_of(child)
        if scan is not None:
            return swap_leaves(child, "scan"), \
                [{"scan": b} for b in _splits(scan)]
        dep = next(r for r in _ipc_rids(child) if jobs[r][0] == "shuffle")
        return child, [{}] * jobs[dep][1].partitioning.num_partitions

    def run_stage(child, rid=None, job=None):
        for dep in _ipc_rids(child):
            ensure(dep)
        plan, inputs = tasks_of(child)
        stage[0] += 1
        res = E.registry()          # shared by the stage's tasks
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
            outs, svc = run_stage(job.child, rid, job)
            done[rid] = E.blocks([svc.reduce_blocks(rid, p) for p in
                                  range(job.partitioning.num_partitions)])
        else:
            outs, _ = run_stage(job.child)
            done[rid] = E.broadcast(outs)
        metrics[kind] += [getattr(o, "metrics", {}) for o in outs]

    [out], _ = run_stage(root)
    return E.table([out], out_schema(root)), metrics


@pytest.mark.parametrize("name", QUERIES)
def test_join_queries_match(name, catalog):
    K.reset_launches()
    port, metrics = run_converted(_PortE, name, catalog)
    ref, _ = run_converted(_JaxE, name, catalog)
    orc = _oracle_table(queries.build(name, catalog))
    assert port.num_rows > 0
    assert compare.compare_tables(port, orc, ordered=True) is None
    assert compare.compare_tables(port, ref, ordered=True) is None
    # on the CPU the wrappers run their plain versions, never a kernel
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}
    maps = metrics["shuffle"]
    assert all(m.get("sizes_by_hist", 0) == m.get("shuffle_write_batches", 0)
               for m in maps)


def test_broadcast_builds_once_per_stage(catalog, monkeypatch):
    """q39v's two month stages: the probe tasks of a stage (one per
    inventory file group) share the table their stage built once."""
    from auron_tpu_torch.ops.joins import exec as PX
    builds = []
    real = PX.BroadcastJoinBuildHashMapExec.build_table
    monkeypatch.setattr(PX.BroadcastJoinBuildHashMapExec, "build_table",
                        lambda self, ctx: builds.append(self.cache_id) or
                        real(self, ctx))
    run_converted(_PortE, "q39v", catalog)
    _, _, ctx = _convert("q39v", catalog)
    probes = [j for j in ctx.exchanges.values()
              if _scan_of(j.child) is not None]
    assert len(probes) == 2
    assert all(len(_splits(_scan_of(j.child))) > 1 for j in probes)
    assert len(builds) == 2 and len(set(builds)) == 2


# -- the card's plans are the converter's ------------------------------------

TABLES = {"sr_": "store_returns", "c_": "customer", "ss_": "store_sales",
          "inv_": "inventory", "d_": "date_dim"}


def _card_id(rid, name):
    """The converter's id with the query's name for its plan hash."""
    kind, _, n = rid.split(":")
    return f"{kind}:{name}:{n}"


def _card_plan(node, name):
    """The converter's plan as the card runs it: each scan an FFIReader
    of its table, each exchange, broadcast and cache id renamed."""
    if node.kind == "parquet_scan":
        first = node.schema.names()[0]
        table = next(t for p, t in TABLES.items() if first.startswith(p))
        return JP.FFIReader(schema=node.schema, resource_id=table)
    kw = {}
    if node.kind == "ipc_reader":
        kw["resource_id"] = _card_id(node.resource_id, name)
    if node.kind == "broadcast_join":
        kw["cached_build_hash_map_id"] = _card_id(
            node.cached_build_hash_map_id, name)
    if node.kind == "broadcast_join_build_hash_map":
        kw["cache_id"] = _card_id(node.cache_id, name)
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, JP.PlanNode):
            kw[f.name] = _card_plan(v, name)
    return dataclasses.replace(node, **kw) if kw else node


@pytest.mark.parametrize("name", QUERIES)
def test_chip_smoke_join_plans_are_the_converters(name, catalog):
    """Each stage chip_smoke.py runs for the query, built with the port's
    IR, serializes to the JSON of the stage the converter lowers, with
    each scan an FFIReader of its table and the converter's ids under
    the query's name (`chip_smoke.join_query_plans`)."""
    _, root, ctx = _convert(name, catalog)
    built = chip_smoke.join_query_plans(name)
    want = {}
    for j in ctx.exchanges.values():
        want[_card_id(j.rid, name)] = JP.RssShuffleWriter(
            child=_card_plan(j.child, name), partitioning=j.partitioning,
            rss_resource_id="shuffle_writer")
    for j in ctx.broadcasts.values():
        want[_card_id(j.rid, name)] = _card_plan(j.child, name)
    want["root"] = _card_plan(root, name)
    assert set(built) == set(want)
    for rid, plan in want.items():
        assert _port_json(built[rid]) == _jax_json(plan), rid

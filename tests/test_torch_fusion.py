"""Pipeline-fragment fusion in the port (auron_tpu_torch/runtime/fusion.py,
ops/fused.py, the pid fusion of ops/shuffle/writer.py and the
aggregation prologue of ops/agg/exec.py) against the JAX package's.

- The rewrite: the same plan JSON through both engines' `fuse_plan`
  gives equal canonical JSON and equal decline reasons, over the cases
  of tests/test_fusion.py whose kinds the port has and over every task
  the serial q01, q03 and q65w execute at SF 0.01; `unfuse_plan`
  restores the plan it was given.
- Results, on seeded numpy input: the port's fused run equals its
  unfused run bit for bit, and the JAX package's fused `execute_plan`
  exactly on integers, strings and order, floats within
  `compare_tables`' tolerance (rel 1e-4, abs 1e-6): filter, projection,
  limit and rename, expand fan-out, coalesce staging, the prologue, and
  a division and remainder guarded by a filter over the dead rows.
- Pid fusion on one int64 key, on two keys and on a range: the fused
  fragment's ids equal the standalone PartitionIdComputer's, and each
  partition's rows equal the unfused writer's and the JAX writer's.
"""

import json

import numpy as np
import pytest

from auron_tpu.config import conf as jconf
from auron_tpu.frontend.session import PartitionedBlocks as JaxBlocks
from auron_tpu.ir import expr as JE
from auron_tpu.ir import plan as JP
from auron_tpu.ir.node import Node as JNode
from auron_tpu.ir.schema import DataType as JDT
from auron_tpu.ir.schema import Field as JF
from auron_tpu.ir.schema import Schema as JS
from auron_tpu.ops.shuffle.writer import InProcessShuffleService as JaxShuffle
from auron_tpu.runtime import fusion as jfusion
from auron_tpu.runtime.executor import execute_plan as jax_execute_plan
from auron_tpu.runtime.resources import ResourceRegistry as JaxResources
from auron_tpu_torch.analysis.fusion import body_chain
from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.config import conf
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.node import Node
from auron_tpu_torch.memmgr import manager as pmm
from auron_tpu_torch.ops.fused import PID_FIELD, FusedFragmentExec
from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer
from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
from auron_tpu_torch.runtime import fusion as pfusion
from auron_tpu_torch.runtime.executor import execute_plan
from auron_tpu_torch.runtime.planner import PhysicalPlanner
from auron_tpu_torch.runtime.resources import ResourceRegistry

import torch_parity as TP
from torch_parity import one_thread  # noqa: F401  (autouse)

I64, F64, I32, STR = JDT.int64(), JDT.float64(), JDT.int32(), JDT.string()
SCHEMA = JS.of(JF("key", I64), JF("amount", F64), JF("disc", F64),
               JF("d", I64), JF("s", STR))
ROWS, CHUNK = 4000, 1000
col, lit = JE.col, JE.lit


def _table(seed=0, rows=ROWS, keys=37):
    """key in [0, keys) with nulls, amount and disc dyadic (their sums
    are exact in any order), d with zeros, s of 0-12 bytes."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, keys, rows).astype(np.int64),
            rng.integers(-200, 600, rows) / 4.0,
            rng.integers(0, 8, rows) / 32.0,
            rng.integers(-3, 4, rows).astype(np.int64),
            np.array(["v" * int(k % 13) for k in rng.integers(0, 1000, rows)],
                     dtype=object)]
    valid = [rng.random(rows) >= 0.05 for _ in cols]
    return cols, valid


def _src():
    return JP.FFIReader(schema=SCHEMA, resource_id="src")


def _gt(name, v):
    return JE.BinaryExpr(left=col(name), op=">", right=lit(v))


def _chain():
    """tests/test_fusion.py's chain: limit <- rename <- projection <-
    filter."""
    return JP.Limit(
        child=JP.RenameColumns(
            child=JP.Projection(
                child=JP.Filter(child=_src(), predicates=(_gt("amount", 40.0),)),
                exprs=(col("key"), JE.BinaryExpr(
                    left=col("amount"), op="*",
                    right=JE.BinaryExpr(left=lit(1.0), op="-",
                                        right=col("disc")))),
                names=("key", "net")),
            names=("k", "n")),
        limit=700, offset=5)


def _expand(filtered=True, coalesce=0):
    child = JP.Filter(child=_src(), predicates=(_gt("amount", 30.0),)) \
        if filtered else JP.Projection(child=_src(),
                                       exprs=(col("key"), col("s")),
                                       names=("key", "s"))
    ex = JP.Expand(
        child=child,
        projections=((col("key"), lit(1), col("s")),
                     (JE.BinaryExpr(left=col("key"), op="+", right=lit(100)),
                      lit(2), JE.Literal(value=None, dtype=STR))),
        names=("k", "tag", "s"), types=(I64, I32, STR))
    return JP.CoalesceBatches(child=ex, target_batch_size=coalesce) \
        if coalesce is not None else ex


def _agg(mode, grouping, aggs, child=None):
    child = child or JP.Projection(
        child=JP.Filter(child=_src(), predicates=(_gt("amount", 0.0),)),
        exprs=(col("key"), JE.BinaryExpr(left=col("amount"), op="*",
                                         right=col("disc")), col("d")),
        names=("key", "net", "d"))
    return JP.Agg(child=child, exec_mode=mode,
                  grouping=tuple(col(g) for g in grouping),
                  grouping_names=tuple(grouping),
                  aggs=tuple(JE.AggExpr(fn=fn, children=(col(c),),
                                        return_type=t) for fn, c, t in aggs),
                  agg_names=tuple(f"{fn}_{c}" for fn, c, _ in aggs))


SUM_COUNT = (("sum", "net", F64), ("count", "net", I64))
MIXED = (("sum", "net", F64), ("min", "d", I64), ("max", "net", F64),
         ("avg", "net", F64), ("first", "d", I64), ("count", "d", I64))

CASES = {
    "chain": _chain(),
    "limit_without_filter": JP.Limit(
        child=JP.Projection(child=_src(), exprs=(col("key"), col("s")),
                            names=("key", "s")), limit=1500, offset=700),
    "two_limits": JP.Limit(
        child=JP.Filter(child=JP.Limit(
            child=JP.Projection(child=_src(), exprs=(col("key"), col("amount")),
                                names=("key", "amount")),
            limit=3000, offset=100), predicates=(_gt("amount", 50.0),)),
        limit=400, offset=20),
    "expand_coalesce": _expand(coalesce=0),
    "expand_unfiltered": _expand(filtered=False, coalesce=None),
    "filter_over_expand": JP.Filter(child=_expand(filtered=False,
                                                  coalesce=None),
                                    predicates=(_gt("k", 20),)),
    "coalesce_staging": JP.CoalesceBatches(
        child=JP.Projection(
            child=JP.Filter(child=_src(), predicates=(_gt("amount", 100.0),)),
            exprs=(col("key"), col("s"), col("amount")),
            names=("key", "s", "amount")),
        target_batch_size=1500),
    "guarded_division": JP.Projection(
        child=JP.Filter(child=_src(), predicates=(JE.BinaryExpr(
            left=col("d"), op="!=", right=lit(0)),)),
        exprs=(col("key"),
               JE.BinaryExpr(left=col("key"), op="/", right=col("d")),
               JE.BinaryExpr(left=col("key"), op="%", right=col("d")),
               JE.Cast(child=JE.BinaryExpr(left=col("amount"), op="*",
                                           right=lit(1e17)), dtype=I32),
               JE.Cast(child=JE.BinaryExpr(left=col("amount"), op="*",
                                           right=lit(1000.0)),
                       dtype=JDT.decimal(5, 2))),
        names=("key", "q", "r", "big", "dec")),
    "strings": JP.Projection(
        child=JP.Filter(child=_src(), predicates=(_gt("key", 30),)),
        exprs=(col("key"), col("s")), names=("key", "s")),
    "prologue_single": _agg("single", ("key",), SUM_COUNT),
    "prologue_partial": _agg("partial", ("key",), MIXED),
    "prologue_global": _agg("partial", (), MIXED),
    "prologue_filter_only_keys": _agg(
        "single", ("key",), (("count", "d", I64), ("min", "d", I64)),
        child=JP.Projection(child=JP.Filter(
            child=_src(), predicates=(_gt("amount", 10000.0),)),
            exprs=(col("key"), col("d")), names=("key", "d"))),
    "singleton": JP.Limit(child=_src(), limit=5),
}
PROLOGUE = {k for k in CASES if k.startswith("prologue")}


def to_port(jplan):
    return Node.from_dict(json.loads(json.dumps(jplan.to_dict())))


def canonical(node) -> str:
    return json.dumps(node.to_dict(), sort_keys=True, separators=(",", ":"))


def declines(report):
    return [(d.severity, d.pass_id, d.path, d.node_kind, d.message)
            for d in report.declined]


def assert_same_rewrite(jplan):
    """Both engines' fuse_plan over one plan's JSON: equal JSON, equal
    decline reasons, and unfuse_plan restores the plan."""
    plan = to_port(jplan)
    jrep, prep = jfusion.FusionReport(), pfusion.FusionReport()
    jf = jfusion.fuse_plan(JNode.from_dict(json.loads(canonical(plan))),
                           jrep)
    pf = pfusion.fuse_plan(plan, prep)
    assert canonical(pf) == canonical(jf)
    assert declines(prep) == declines(jrep)
    assert (prep.n_fragments, prep.ops_fused) == \
        (jrep.n_fragments, jrep.ops_fused)
    assert pfusion.unfuse_plan(pf) == plan
    assert pfusion.fuse_plan(pf) == pf
    return pf, prep


@pytest.mark.parametrize("name", sorted(CASES))
def test_rewrite_matches_the_jax_package(name):
    pf, rep = assert_same_rewrite(CASES[name])
    assert (rep.n_fragments == 0) == (name == "singleton")
    if name == "chain":
        assert "FusedFragment[limit <- rename_columns <- projection <- " \
               "filter]" in pfusion.explain(pf)


# q01, q03 and q65w hold no chain of two row-local operators; q27r's
# partial aggregations sit over expand <- projection, q74y's exchanges
# over projection <- filter (pid-fused), q39v's over filter <- projection
CORPUS = ("q01", "q03", "q65w", "q27r", "q74y", "q39v")
# every corpus query whose serial tasks hold a fragment
FUSING = {"q18a", "q22r", "q27r", "q36r", "q39v", "q39w", "q44r", "q67r",
          "q70r", "q74y", "q86r", "q89w", "q94n", "q95w"}


@pytest.fixture(scope="module")
def corpus_tasks(tmp_path_factory):
    """Every task of the 103 queries, run serially at SF 0.01."""
    from auron_tpu_torch.it import queries as PQ
    return TP.serial_tasks(tuple(PQ.QUERIES), sf=0.01,
                           data_dir=str(tmp_path_factory.mktemp("tpcds")))


def test_corpus_rewrites_match_the_jax_package(corpus_tasks):
    """Every task of the serial CORPUS queries at SF 0.01."""
    fragments = {}
    for name, task in corpus_tasks:
        if name in CORPUS:
            _, rep = assert_same_rewrite(task.plan)
            fragments[name] = fragments.get(name, 0) + rep.n_fragments
    assert set(fragments) == set(CORPUS)
    assert [q for q in CORPUS if fragments[q]] == ["q27r", "q74y", "q39v"]


def test_which_corpus_queries_fuse(corpus_tasks):
    """Fragments, and what sits over them, across the corpus: expand <-
    projection under a partial aggregation (never one the prologue
    takes), the other chains under an exchange (pid-fused) or a sort."""
    parents, queries = set(), set()
    for name, task in corpus_tasks:
        for node in P.walk(pfusion.fuse_plan(task.plan)):
            for c in P.plan_children(node):
                if isinstance(c, P.FusedFragment):
                    queries.add(name)
                    chain = " <- ".join(
                        k.kind for k in reversed(body_chain(c.body)[0]))
                    parents.add((node.kind, chain))
    assert queries == FUSING
    assert parents == {("agg", "expand <- projection"),
                       ("rss_shuffle_writer", "filter <- projection"),
                       ("rss_shuffle_writer", "projection <- filter"),
                       ("sort", "filter <- projection")}


# -- results --------------------------------------------------------------------

def _items(cols, valid):
    return TP.chunks(cols, valid, CHUNK)


def run_port(plan, fuse: bool, cols, valid, pid_fuse=True):
    res = ResourceRegistry()
    res.put("src", _items(cols, valid))
    with conf.scoped({"auron.fuse.enable": fuse,
                      "auron.shuffle.pid.fuse.enable": pid_fuse}):
        return execute_plan(plan, resources=res, device="cpu")


def run_jax(jplan, cols, valid):
    res = JaxResources()
    res.put("src", [TP.to_arrow(a, v, SCHEMA) for a, v in _items(cols, valid)])
    with jconf.scoped({"auron.fuse.enable": True}):
        out = jax_execute_plan(jplan, resources=res)
    return out


def port_columns(res):
    return {n: (d, v) for n, (d, v) in res.to_numpy().items()}


def assert_bit_equal(a, b):
    assert list(a) == list(b)
    for n in a:
        np.testing.assert_array_equal(a[n][1], b[n][1], err_msg=n)
        np.testing.assert_array_equal(a[n][0][a[n][1]], b[n][0][b[n][1]],
                                      err_msg=n)


def _sorted_rows(cols, names):
    n = len(cols[names[0]][0])
    rows = [tuple((cols[c][0][i].item() if hasattr(cols[c][0][i], "item")
                   else cols[c][0][i]) if cols[c][1][i] else None
                  for c in names) for i in range(n)]
    return rows


def assert_close_rows(got, exp, names, ordered):
    g, e = _sorted_rows(got, names), _sorted_rows(exp, names)
    if not ordered:
        key = lambda r: tuple((x is None, x if not isinstance(x, float)  # noqa: E731
                               else round(x, 3)) for x in r)
        g, e = sorted(g, key=key), sorted(e, key=key)
    assert len(g) == len(e)
    for rg, re_ in zip(g, e):
        for x, y in zip(rg, re_):
            if isinstance(y, float) and x is not None:
                assert abs(x - y) <= 1e-6 + 1e-4 * abs(y), (rg, re_)
            else:
                assert x == y, (rg, re_)


def jax_columns(jres, names):
    """{name: (data, validity)} of a JAX result, a string column as an
    object array ('' under a null)."""
    import pyarrow as pa
    schema = jres.batches[0].schema if jres.batches else jres.schema
    strings = [n for n in names if pa.types.is_string(schema.field(n).type)
               or pa.types.is_large_string(schema.field(n).type)
               or pa.types.is_binary(schema.field(n).type)]
    out = TP.jax_columns(jres.batches,
                         [n for n in names if n not in strings])
    for n in strings:
        vals = [x for rb in jres.batches
                for x in rb.column(rb.schema.get_field_index(n)).to_pylist()]
        out[n] = (np.array(["" if x is None else x for x in vals],
                           dtype=object),
                  np.array([x is not None for x in vals], dtype=bool))
    return {n: out[n] for n in names}


@pytest.mark.parametrize("name", sorted(set(CASES) - {"singleton"}))
def test_fused_equals_unfused_and_the_jax_package(name):
    cols, valid = _table(seed=len(name))
    plan = to_port(CASES[name])
    on = run_port(plan, True, cols, valid)
    off = run_port(plan, False, cols, valid)
    got = port_columns(on)
    assert_bit_equal(got, port_columns(off))
    # the fused tree ran: one fragment, or the prologue inside the agg
    frag = [n for n, m in on.operator_metrics if n == "FusedFragmentExec"]
    assert len(frag) == 1
    fm = [m for n, m in on.operator_metrics if n == "FusedFragmentExec"][0]
    assert fm["ops_fused"] >= 2 and fm["fused_batches"] > 0
    assert ("fused_into_parent" in fm) == (name in PROLOGUE)
    names = on.schema.names()
    exp = jax_columns(run_jax(CASES[name], cols, valid), names)
    assert_close_rows(got, exp, names, ordered=name not in PROLOGUE)


def test_prologue_takes_the_fragment_apart():
    """The partial aggregation pulls the fragment's child itself: the
    fragment yields no batch, counts one fused batch an input batch, and
    the verify-then-fuse planner builds the composition."""
    cols, valid = _table(seed=3)
    plan = to_port(CASES["prologue_partial"])
    res = run_port(plan, True, cols, valid)
    frag = dict(res.operator_metrics)["FusedFragmentExec"]
    assert frag.get("output_rows") == 0 and frag.get("output_batches") == 0
    assert frag["fused_batches"] == ROWS // CHUNK
    root = PhysicalPlanner().create_verified_plan(P.TaskDefinition(plan=plan))
    assert root._prologue is root.children[0]
    assert isinstance(root._prologue, FusedFragmentExec)
    with conf.scoped({"auron.fuse.enable": False}):
        off = PhysicalPlanner().create_verified_plan(
            P.TaskDefinition(plan=plan))
    assert off._prologue is None and off.children[0].name == "FilterExec"


# (case, distinct keys): few groups, the global aggregate, and a keyed
# one with many groups
BUDGETED = (("prologue_partial", 37), ("prologue_global", 37),
            ("prologue_single", 3000))


@pytest.mark.parametrize("name,keys", BUDGETED,
                         ids=[f"{n}-{k}" for n, k in BUDGETED])
def test_prologue_spills_under_a_budget(name, keys):
    """The prologue under a tiny memory budget: the aggregation stages
    the groups of the fragment's live rows, spills them as key-sorted
    state runs and merges those; fused and unfused both spill, and equal
    the unbudgeted run bit for bit and the JAX package's run."""
    cols, valid = _table(seed=17, keys=keys)
    plan = to_port(CASES[name])
    whole = port_columns(run_port(plan, True, cols, valid))
    for fuse in (True, False):
        with conf.scoped({"auron.memory.spill.min.trigger.bytes": 1}):
            pmm.reset_manager(1)
            try:
                res = run_port(plan, fuse, cols, valid)
            finally:
                pmm.reset_manager()
        agg = dict(res.operator_metrics)["AggExec"]
        assert agg["mem_spill_count"] > 0, fuse
        frag = [m for n, m in res.operator_metrics
                if n == "FusedFragmentExec"]
        assert [m.get("fused_into_parent") for m in frag] == \
            ([1] if fuse else [])
        assert_bit_equal(port_columns(res), whole)
    names = res.schema.names()
    exp = jax_columns(run_jax(CASES[name], cols, valid), names)
    assert_close_rows(whole, exp, names, ordered=False)


@pytest.mark.parametrize("name", ["prologue_global", "prologue_partial"])
def test_prologue_at_the_least_capacity(name):
    """`auron.batch.capacity.min` 1: the masked reductions' dead rows
    still have their own slot past the groups."""
    cols, valid = _table(seed=19)
    plan = to_port(CASES[name])
    kv = {"auron.batch.capacity.min": 1}
    with conf.scoped(kv):
        on = run_port(plan, True, cols, valid)
        off = run_port(plan, False, cols, valid)
    assert dict(on.operator_metrics)["FusedFragmentExec"][
        "fused_into_parent"] == 1
    got = port_columns(on)
    assert_bit_equal(got, port_columns(off))
    names = on.schema.names()
    with jconf.scoped(kv):
        exp = jax_columns(run_jax(CASES[name], cols, valid), names)
    assert_close_rows(got, exp, names, ordered=False)


def test_dead_rows_neither_raise_nor_count():
    """Every row fails the guard: the division by zero and the cast out
    of range run over dead rows only, and nothing comes out."""
    cols, valid = _table(seed=5)
    cols[3][:] = 0
    plan = to_port(CASES["guarded_division"])
    on = run_port(plan, True, cols, valid)
    assert on.batches == []
    frag = dict(on.operator_metrics)["FusedFragmentExec"]
    assert frag.get("fused_batches") == 0


# -- pid fusion -------------------------------------------------------------------

PARTITIONINGS = {
    "one_int64_key": JP.Partitioning(mode="hash", num_partitions=7,
                                     expressions=(col("key"),)),
    "two_keys": JP.Partitioning(mode="hash", num_partitions=5,
                                expressions=(col("key"), col("s"))),
    "range": JP.Partitioning(
        mode="range", num_partitions=4,
        sort_orders=(JE.SortExpr(child=col("amount"), asc=False,
                                 nulls_first=False),),
        range_bounds=((120.0,), (40.0,), (-10.0,))),
}


def _map_plan(part):
    return JP.RssShuffleWriter(
        child=JP.Projection(
            child=JP.Filter(child=_src(), predicates=(_gt("disc", 0.05),)),
            exprs=(col("key"), col("amount"), col("s")),
            names=("key", "amount", "s")),
        partitioning=part, rss_resource_id="writer")


def _port_blocks(plan, cols, valid, pid_fuse):
    svc = InProcessShuffleService()
    res = ResourceRegistry()
    res.put("src", _items(cols, valid))
    res.put("writer", svc.rss_writer("s", 0))
    with conf.scoped({"auron.shuffle.pid.fuse.enable": pid_fuse}):
        out = execute_plan(plan, resources=res, device="cpu")
    n = plan.partitioning.num_partitions
    parts = []
    for p in range(n):
        blocks = svc.reduce_blocks("s", p)
        rows = {}
        for name in ("key", "amount", "s"):
            i = blocks[0].schema.names().index(name) if blocks else 0
            rows[name] = (np.concatenate([b.to_numpy()[0][i] for b in blocks])
                          if blocks else np.zeros(0),
                          np.concatenate([b.to_numpy()[1][i] for b in blocks])
                          if blocks else np.zeros(0, bool))
        parts.append(rows)
    return out, parts


def _jax_blocks(jplan, cols, valid):
    svc = JaxShuffle()
    res = JaxResources()
    res.put("src", [TP.to_arrow(a, v, SCHEMA) for a, v in _items(cols, valid)])
    res.put("writer", svc.rss_writer("s", 0))
    jax_execute_plan(jplan, resources=res)
    out_schema = JS.of(JF("key", I64), JF("amount", F64), JF("s", STR))
    reader = JP.IpcReader(schema=out_schema, resource_id="read")
    n = jplan.partitioning.num_partitions
    blocks = JaxBlocks([svc.reduce_blocks("s", p) for p in range(n)])
    parts = []
    for p in range(n):
        r = JaxResources()
        r.put("read", blocks)
        parts.append(jax_columns(jax_execute_plan(
            reader, partition_id=p, num_partitions=n, resources=r),
            ("key", "amount", "s")))
    return parts


@pytest.mark.parametrize("name", sorted(PARTITIONINGS))
def test_pid_fusion(name):
    cols, valid = _table(seed=11)
    jplan = _map_plan(PARTITIONINGS[name])
    plan = to_port(jplan)
    fused_res, fused = _port_blocks(plan, cols, valid, True)
    plain_res, plain = _port_blocks(plan, cols, valid, False)
    writer = dict(fused_res.operator_metrics)["RssShuffleWriterExec"]
    frag = dict(fused_res.operator_metrics)["FusedFragmentExec"]
    assert writer["pid_fused_batches"] == frag["pid_fused_batches"] > 0
    assert "pid_fused_batches" not in \
        dict(plain_res.operator_metrics)["RssShuffleWriterExec"]
    for p, (a, b) in enumerate(zip(fused, plain)):
        assert_bit_equal(a, b)
    for p, (a, e) in enumerate(zip(fused, _jax_blocks(jplan, cols, valid))):
        assert_close_rows(a, e, ("key", "amount", "s"), ordered=True)


@pytest.mark.parametrize("name", sorted(PARTITIONINGS))
def test_fused_ids_equal_the_standalone_computer(name):
    """The fragment's PID_FIELD column, computed before its compaction,
    against PartitionIdComputer over the compacted batch."""
    from auron_tpu_torch.ops.base import TaskContext
    cols, valid = _table(seed=13)
    plan = to_port(_map_plan(PARTITIONINGS[name]))
    frag_node = pfusion.fuse_plan(plan).child
    frag = PhysicalPlanner().create_plan(frag_node)
    assert frag.enable_pid_fusion(plan.partitioning)
    computer = PartitionIdComputer(plan.partitioning, frag.schema)
    res = ResourceRegistry()
    res.put("src", _items(cols, valid))
    seen = 0
    for b in frag.execute(TaskContext(resources=res)):
        assert b.schema.names()[-1] == PID_FIELD
        ids = b.columns[-1].data[:b.num_rows]
        plain = computer(Batch(frag.schema, b.columns[:-1], b.num_rows,
                               b.capacity))
        np.testing.assert_array_equal(ids.numpy(), plain.numpy())
        seen += b.num_rows
    assert seen > 0


def test_chip_smoke_phase_31_runs_on_the_cpu(tmp_path, capsys):
    """chip_smoke.py's phase 31 at SF 0.01 with the CPU in the card's
    place, against the JAX oracle's results of its queries, and its
    prologue task over 40,000 store_sales rows (the kernel wrappers run
    their plain versions here and launch nothing)."""
    import chip_smoke
    from auron_tpu_torch.it import datagen as pdatagen
    from auron_tpu_torch.it.compare import HostTable
    from auron_tpu_torch.it.runner import QueryRunner
    from auron_tpu_torch.ops import kernels_cuda as K

    from test_torch_it_runner import load_tool
    d = str(tmp_path)
    results = load_tool().derive(d, 0.01, 7, 4,
                                 names=list(chip_smoke.FUSION_QUERIES))
    expected = {n: HostTable(r["columns"], [tuple(x) for x in r["rows"]])
                for n, r in json.loads(json.dumps(results)).items()}
    catalog, data = pdatagen.generate(d, sf=0.01, seed=7)
    runner = QueryRunner(catalog, data, expected, "cpu")
    cols, valid = chip_smoke.make_store_sales(40_000, 0)
    launches = chip_smoke.run_phase31(runner, cols, valid, "cpu", K, "cpu")
    out = capsys.readouterr().out
    for name in chip_smoke.FUSION_QUERIES:
        assert f"phase 31: {name} serial, verified" in out
    assert "prologue-fused aggregations" in out
    assert "phase 31: the prologue at SF 10" in out
    assert set(launches) == {
        f"{q}_{s}" for q in chip_smoke.FUSION_QUERIES + ("prologue",)
        for s in ("fused", "unfused")}

"""EXPLAIN ANALYZE of the port (auron_tpu_torch/runtime/explain_analyze.py)
against the JAX package's.

- On the same metric trees, built from a seed in both packages:
  `merge_metric_trees`, `metric_totals`, `metric_max`,
  `explain_analyze` (human and normalized), `render_analyzed_dicts`,
  `diff_metric_trees` and `render_diff` give the same values and the
  same text.
- q03 (the JAX golden's query, tests/golden_plans/q03.analyze.txt), q01
  and q65w at SF 0.002 with 3 fact chunks on the serial path through
  both sessions (the JAX package's with `auron.fuse.enable` and
  `auron.spmd.singleDevice.enable` off, one task at a time): their
  merged, normalized trees have the same task groups, operator names
  and `output_rows`, `output_batches`, `shuffle_write_rows` and
  `shuffle_read_rows` on every node.

The allowed differences, each pinned by a test:
- scan leaves: the JAX session reads the parquet files
  (`ParquetScanExec`, with `parquet_row_groups_read`); the port reads no
  file, so `converters.ScanSourceProvider` makes each scan an
  `FFIReaderExec` that `it/datagen.py::TableEngine` serves, one split a
  file group;
- `ExchangeStats[...]` marker groups: the JAX session's adaptive
  execution observes each exchange (ROADMAP Queue 1 item 23);
- the port's own counters (`PORT_ONLY_KEYS`: its shuffle writer's route
  and batch counts, the join's probe chunks and builds, the sort's form
  and rows, the sort-merge join's windows), which the JAX operators do
  not keep;
- batch counts: none differ (`BATCH_DIFFERENCES` is empty).
"""

import os

import numpy as np
import pytest

from auron_tpu.config import conf as jconf
from auron_tpu.frontend.session import AuronSession as JaxSession
from auron_tpu.it import datagen as jdatagen
from auron_tpu.it import queries as jqueries
from auron_tpu.it.oracle import PyArrowEngine
from auron_tpu.runtime import explain_analyze as JEA
from auron_tpu.runtime.metrics import MetricNode as JNode
from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend import converters as PC
from auron_tpu_torch.frontend.session import AuronSession
from auron_tpu_torch.it import datagen as pdatagen
from auron_tpu_torch.it import queries as pqueries
from auron_tpu_torch.runtime import explain_analyze as PEA
from auron_tpu_torch.runtime.metrics import MetricNode as PNode

from torch_parity import one_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_plans", "q03.analyze.txt")
SF, SEED, CHUNKS = 0.002, 7, 3
QUERIES = ("q03", "q01", "q65w")
KEYS = ("output_rows", "output_batches", "shuffle_write_rows",
        "shuffle_read_rows")
SCAN_LEAVES = {"ParquetScanExec": "FFIReaderExec"}
JAX_ONLY_KEYS = {"parquet_row_groups_read"}
JAX_ONLY_GROUP = "ExchangeStats["
PORT_ONLY_KEYS = {"shuffle_write_batches", "sizes_by_hist",
                  "sizes_by_bincount", "probe_chunks", "build_hash_maps",
                  "sorted_by_multipass", "sorted_by_radix", "sorted_rows",
                  "smj_windows"}
# (query, group index, node path, key) -> why the batch counts differ
BATCH_DIFFERENCES: dict = {}


# ---------------------------------------------------------------------------
# the same trees in both packages
# ---------------------------------------------------------------------------

OPS = ("ProjectExec", "FilterExec", "AggExec", "SortExec", "IpcReaderExec",
       "RssShuffleWriterExec", "WindowExec", "SortMergeJoinExec")
VALUE_KEYS = ("output_rows", "output_batches", "elapsed_compute_ns",
              "mem_peak", "mem_spill_count", "mem_spill_size",
              "shuffle_write_rows", "shuffle_write_time_ns",
              "shuffle_read_rows", "shuffle_read_bytes", "input_rows",
              "num_fallbacks", "sorted_rows")


def _shape(rng, depth=0):
    """(name, [child shapes]) of a random operator tree."""
    kids = [] if depth >= 3 else \
        [_shape(rng, depth + 1) for _ in range(int(rng.integers(0, 3)))]
    return str(rng.choice(OPS)), kids


def _tree(node_cls, shape, values):
    """A tree of `node_cls` over `shape`, each node's values taken in
    pre-order from the iterator `values`."""
    name, kids = shape
    node = node_cls(name)
    for k, v in next(values):
        node.add(k, v)
    node.children = [_tree(node_cls, c, values) for c in kids]
    return node


def _values(rng, shape):
    """Pre-order value lists of every node of `shape`."""
    out = []

    def walk(s):
        keys = rng.choice(VALUE_KEYS, int(rng.integers(0, 6)), replace=False)
        out.append([(str(k), int(rng.choice([0, rng.integers(1, 3 << 20)])))
                    for k in keys])
        for c in s[1]:
            walk(c)
    walk(shape)
    return out


def same_trees(seed):
    """The same 6-9 trees over 3 shapes in both packages."""
    rng = np.random.default_rng(seed)
    shapes = [_shape(rng) for _ in range(3)]
    jt, pt = [], []
    for _ in range(int(rng.integers(6, 10))):
        shape = shapes[int(rng.integers(0, 3))]
        vals = _values(rng, shape)
        jt.append(_tree(JNode, shape, iter(vals)))
        pt.append(_tree(PNode, shape, iter(vals)))
    return jt, pt


@pytest.mark.parametrize("seed", range(6))
def test_merge_totals_and_max_equal_the_jax_package(seed):
    jt, pt = same_trees(seed)
    assert [(t.to_dict(), n) for t, n in PEA.merge_metric_trees(pt)] == \
        [(t.to_dict(), n) for t, n in JEA.merge_metric_trees(jt)]
    assert PEA.metric_totals(pt) == JEA.metric_totals(jt)
    for key in VALUE_KEYS:
        assert PEA.metric_max(pt, key) == JEA.metric_max(jt, key)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("normalize", [False, True])
def test_explain_analyze_text_equals_the_jax_package(seed, normalize):
    jt, pt = same_trees(seed)
    kw = dict(query_id=f"q{seed}", wall_s=0.125 * seed, rows=seed * 7,
              spmd=bool(seed % 2), retries=seed % 3, fallbacks=seed % 2,
              normalize=normalize)
    assert PEA.explain_analyze(pt, **kw) == JEA.explain_analyze(jt, **kw)
    assert PEA.render_analyzed(pt, normalize) == \
        JEA.render_analyzed(jt, normalize)
    dicts = [{"tasks": n, "tree": t.to_dict()}
             for t, n in JEA.merge_metric_trees(jt)]
    assert PEA.render_analyzed_dicts(dicts, normalize) == \
        JEA.render_analyzed_dicts(dicts, normalize)


@pytest.mark.parametrize("spmd", [False, True])
def test_explain_analyze_of_no_trees_equals_the_jax_package(spmd):
    for normalize in (False, True):
        assert PEA.explain_analyze([], rows=3, spmd=spmd,
                                   normalize=normalize) == \
            JEA.explain_analyze([], rows=3, spmd=spmd, normalize=normalize)


@pytest.mark.parametrize("seed", range(4))
def test_diff_and_render_diff_equal_the_jax_package(seed):
    ja, pa_ = same_trees(seed)
    # the second run: the same shapes, other values
    rng = np.random.default_rng(seed + 100)
    jb, pb = [], []
    for t in ja:
        vals = _values(rng, _shape_of(t))
        jb.append(_tree(JNode, _shape_of(t), iter(vals)))
        pb.append(_tree(PNode, _shape_of(t), iter(vals)))

    def groups(mod, trees):
        return [{"tasks": n, "tree": t.to_dict()}
                for t, n in mod.merge_metric_trees(trees)]
    jd = JEA.diff_metric_trees(groups(JEA, ja), groups(JEA, jb))
    pd = PEA.diff_metric_trees(groups(PEA, pa_), groups(PEA, pb))
    assert pd == jd
    assert PEA.render_diff(pd, "a1", "b1") == JEA.render_diff(jd, "a1", "b1")
    other = [{"tasks": 1, "tree": {"name": "Nothing", "values": {},
                                   "children": []}}]
    for mod, trees in ((JEA, ja), (PEA, pa_)):
        with pytest.raises(ValueError, match="no matching plan shape"):
            mod.diff_metric_trees(groups(mod, trees), other)


def _shape_of(node):
    return node.name, [_shape_of(c) for c in node.children]


def test_deferred_device_counts_settle_at_first_read():
    """`add_deferred` keeps 0-dim tensors until the node is read, then
    reads them back in one stack."""
    import torch
    n = PNode("x")
    n.add("output_rows", 2)
    n.add_deferred("output_rows", torch.tensor(5))
    n.add_deferred("output_batches", torch.tensor(1, dtype=torch.int32))
    assert n.values == {"output_rows": 2} and len(n.deferred) == 2
    assert n.get("output_rows") == 7 and n.deferred == {}
    assert n["output_batches"] == 1 and "output_batches" in n
    assert dict(n) == {"output_rows": 7, "output_batches": 1}


# ---------------------------------------------------------------------------
# q03, q01 and q65w on the serial path through both sessions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{query: (JAX result, port result)}, both serial, over one
    catalog."""
    d = str(tmp_path_factory.mktemp("ea_tpcds"))
    jcat = jdatagen.generate(d, sf=SF, seed=SEED, fact_chunks=CHUNKS)
    pcat, tables = pdatagen.generate(d, sf=SF, seed=SEED,
                                     fact_chunks=CHUNKS)
    out = {}
    provider = PC.ScanSourceProvider()
    PC.register_provider(provider)
    try:
        for name in QUERIES:
            with jconf.scoped({"auron.spmd.singleDevice.enable": False,
                               "auron.fuse.enable": False,
                               "auron.task.parallelism": 1}):
                jr = JaxSession(foreign_engine=PyArrowEngine()).execute(
                    jqueries.build(name, jcat))
            with conf.scoped({"auron.spmd.singleDevice.enable": False}):
                pr = AuronSession(foreign_engine=pdatagen.TableEngine(
                    pcat, tables)).execute(pqueries.build(name, pcat),
                                           device="cpu")
            out[name] = (jr, pr)
    finally:
        PC.unregister_provider(provider)
    return out


def _jax_groups(jr):
    return [(n, t.to_dict()) for t, n in JEA.merge_metric_trees(jr.metrics)
            if not t.name.startswith(JAX_ONLY_GROUP)]


def _port_groups(pr):
    return [(n, t.to_dict())
            for t, n in PEA.merge_metric_trees(pr.metric_trees)]


def _walk(node, path=()):
    path = path + (node["name"],)
    yield path, node
    for c in node["children"]:
        yield from _walk(c, path)


@pytest.mark.parametrize("name", QUERIES)
def test_serial_trees_agree_with_the_jax_session(name, runs):
    jr, pr = runs[name]
    assert not pr.spmd and not jr.spmd
    assert pr.num_rows == jr.table.num_rows
    jg, pg = _jax_groups(jr), _port_groups(pr)
    assert [n for n, _ in pg] == [n for n, _ in jg]
    for gi, ((_, jt), (_, pt)) in enumerate(zip(jg, pg)):
        jnodes, pnodes = list(_walk(jt)), list(_walk(pt))
        assert [tuple(SCAN_LEAVES.get(x, x) for x in p)
                for p, _ in jnodes] == [p for p, _ in pnodes]
        for (path, jn), (_, pn) in zip(jnodes, pnodes):
            for key in KEYS:
                want = jn["values"].get(key, 0)
                got = pn["values"].get(key, 0)
                if (name, gi, path, key) in BATCH_DIFFERENCES:
                    continue
                assert got == want, (name, gi, path, key)


@pytest.mark.parametrize("name", QUERIES)
def test_allowed_differences_are_exactly_the_listed_ones(name, runs):
    """Every key the port's nodes keep and the JAX nodes lack is one of
    PORT_ONLY_KEYS, the other way round one of JAX_ONLY_KEYS (on the
    scan leaves), the only groups the JAX session adds are its
    ExchangeStats markers, and no batch count differs."""
    jr, pr = runs[name]
    jnames = [t.name for t in jr.metrics]
    assert any(n.startswith(JAX_ONLY_GROUP) for n in jnames)
    assert not any(t.name.startswith(JAX_ONLY_GROUP)
                   for t in pr.metric_trees)
    for (_, jt), (_, pt) in zip(_jax_groups(jr), _port_groups(pr)):
        for (path, jn), (_, pn) in zip(_walk(jt), _walk(pt)):
            jk = {k for k, v in jn["values"].items() if v}
            pk = {k for k, v in pn["values"].items() if v}
            vol = {k for k in jk | pk if PEA._volatile(k)}
            assert (pk - jk - vol) <= PORT_ONLY_KEYS, path
            extra = jk - pk - vol
            assert extra <= JAX_ONLY_KEYS, path
            assert not extra or path[-1] in SCAN_LEAVES
    assert BATCH_DIFFERENCES == {}


def _canonical(text: str, port: bool) -> str:
    """The normalized EXPLAIN ANALYZE with the listed differences taken
    out: ExchangeStats groups, the scan leaves' name and keys, the
    port's own counters."""
    out, skip = [], False
    for line in text.splitlines():
        if line.startswith("["):
            skip = False
        if line.strip().startswith(JAX_ONLY_GROUP):
            out.pop()          # the group's "[1 task]" header
            skip = True
            continue
        if skip:
            continue
        pad, _, rest = line.partition(line.lstrip())
        if ": " in line and not line.startswith("=="):
            op, vals = line.lstrip().split(": ", 1)
            op = SCAN_LEAVES.get(op, op)
            drop = PORT_ONLY_KEYS if port else JAX_ONLY_KEYS
            vals = " ".join(v for v in vals.split()
                            if v.split("=")[0] not in drop)
            line = f"{pad}{op}: {vals}"
        out.append(line)
    return "\n".join(out)


def test_q03_matches_the_jax_golden_outside_the_listed_differences(runs):
    _, pr = runs["q03"]
    with open(GOLDEN) as f:
        golden = f.read().rstrip("\n")
    assert _canonical(pr.explain_analyze(normalize=True), port=True) == \
        _canonical(golden, port=False)


def test_human_form_carries_the_volatile_fields(runs):
    _, pr = runs["q03"]
    human = pr.explain_analyze()
    assert pr.query_id and f"query={pr.query_id}" in human
    assert "compute=" in human and "wall=" in human
    assert f"query={pr.query_id}" not in pr.explain_analyze(normalize=True)

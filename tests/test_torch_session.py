"""The port's session (`auron_tpu_torch/frontend/session.py`) against
the JAX package's, over the IT corpus at SF 0.01, seed 7.

Each query is converted by the JAX package's converter
(`test_torch_corpus_stages.py::_convert`) and carried into the port's
IR node by node (`to_port`): a subtree the converter shares (a union's
child, read once per partition) stays shared, and each parquet scan
becomes an FFIReader `scan<k>` fed the scan's file groups, one
partition a group (`port_query`).

- For every query, the stage executor's kind-level rejections
  (`iter_spmd_rejections`) equal the JAX package's over the same plans
  (scan-swapped as `test_torch_corpus_all.py::_swap_scans` does).
- The 16 gate queries of the IT perf gate (`IT_PERF.json`) go whole
  through both sessions: both take the stage path or both fall back,
  and both equal the pyarrow oracle,
  `compare_tables(ordered=plan_is_ordered(plan))`.
  With `auron.spmd.singleDevice.enable` off, the port's serial path
  equals the oracle too.
"""

import dataclasses
from types import SimpleNamespace

import pyarrow as pa
import pytest

from auron_tpu.frontend.session import AuronSession as JaxSession
from auron_tpu.ir.node import Node as JNode
from auron_tpu.ir.node import _decode as jdecode
from auron_tpu.ir.node import _encode as jencode
from auron_tpu.ir.schema import to_arrow_type
from auron_tpu.it import compare, datagen, queries
from auron_tpu.parallel import stage as jstage
from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend import converters as PC
from auron_tpu_torch.frontend.session import AuronSession
from auron_tpu_torch.ir import plan as PP
from auron_tpu_torch.ir.node import _REGISTRY
from auron_tpu_torch.ir.node import _decode as pdecode
from auron_tpu_torch.ir.node import _encode as pencode
from auron_tpu_torch.ops import kernels_cuda as K
from auron_tpu_torch.ops.scan.ipc import SourceTable
from auron_tpu_torch.parallel import stage as pstage

from test_torch_corpus_aggs import _oracle_table
from test_torch_corpus_all import _swap_scans
from test_torch_corpus_stages import _convert, _splits
from torch_parity import one_thread  # noqa: F401  (autouse)

SF = 0.01

# the gate queries of the IT perf gate (IT_PERF.json), all of which the
# JAX package ran on its stage path
GATE = ("q55", "q01", "q65w", "q16a", "q06a", "q13a", "q26a", "q34c",
        "q48a", "q93s", "q61p", "q59w", "q32e", "q72p", "q73h", "q90r")


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


# -- the converted query in the port's IR -------------------------------------

def to_port(v, memo, scans=None):
    """The port's counterpart of a JAX-package IR value: a node of the
    same kind and fields, memoized by identity so shared subtrees stay
    shared; with `scans`, each parquet scan an FFIReader `scan<k>`, k
    its index in `scans` (appended on first sight)."""
    if isinstance(v, tuple):
        return tuple(to_port(x, memo, scans) for x in v)
    if not isinstance(v, JNode):
        return pdecode(jencode(v))
    got = memo.get(id(v))
    if got is not None:
        return got[1]
    if v.kind == "parquet_scan" and scans is not None:
        k = next((i for i, x in enumerate(scans) if x is v), None)
        if k is None:
            scans.append(v)
            k = len(scans) - 1
        out = PP.FFIReader(schema=to_port(v.schema, memo),
                           resource_id=f"scan{k}")
    else:
        cls = _REGISTRY[v.kind]
        out = cls(**{f.name: to_port(getattr(v, f.name), memo, scans)
                     for f in dataclasses.fields(cls)
                     if hasattr(v, f.name)})
    memo[id(v)] = (v, out)
    return out


def port_query(name, cat):
    """(foreign plan, port root, port ConvertContext, sources) of a
    query: every stage carried over with its partition count, each scan
    a SourceTable of its file groups."""
    plan, root, ctx = _convert(name, cat)
    memo, scans = {}, []
    pctx = PC.ConvertContext()
    stages = [(root, to_port(root, memo, scans))]
    for rid, j in ctx.exchanges.items():
        child = to_port(j.child, memo, scans)
        pctx.exchanges[rid] = PC.ShuffleJob(
            rid, child, to_port(j.partitioning, memo))
        stages.append((j.child, child))
    for rid, j in ctx.broadcasts.items():
        child = to_port(j.child, memo, scans)
        pctx.broadcasts[rid] = PC.BroadcastJob(rid, child)
        stages.append((j.child, child))
    for ref, port in stages:
        pctx.set_parts(port, ctx.parts(ref))
    sources = {}
    for k, scan in enumerate(scans):
        sources[f"scan{k}"] = SourceTable(_splits(scan))
        pctx.sources[f"scan{k}"] = PC.ForeignSource(f"scan{k}")
    return plan, stages[0][1], pctx, sources


def columns_table(schema, columns) -> pa.Table:
    """{name: (data, validity)} host columns of a port schema as an
    arrow table."""
    arrays = [pa.array(columns[f.name][0],
                       type=to_arrow_type(jdecode(pencode(f.dtype))),
                       mask=~columns[f.name][1])
              for f in schema.fields]
    return pa.Table.from_arrays(arrays, names=[f.name
                                               for f in schema.fields])


def port_table(res) -> pa.Table:
    """A SessionResult's columns as an arrow table."""
    return columns_table(res.schema, res.columns)


def run_port(name, cat, stage=True):
    plan, root, ctx, sources = port_query(name, cat)
    with conf.scoped({"auron.spmd.singleDevice.enable": stage}):
        res = AuronSession().execute_converted(root, ctx, sources,
                                               device="cpu")
    return plan, res


def rejections(name, cat):
    """The JAX package's and the port's (kind, reason) lists over the
    query's scan-swapped plans."""
    _, root, ctx = _convert(name, cat)
    scans = []
    swapped = SimpleNamespace(
        exchanges={rid: dataclasses.replace(
            j, child=_swap_scans(j.child, scans))
            for rid, j in ctx.exchanges.items()},
        broadcasts={rid: dataclasses.replace(
            j, child=_swap_scans(j.child, scans))
            for rid, j in ctx.broadcasts.items()})
    jroot = _swap_scans(root, scans)
    ref = [(n.kind, r) for n, r in
           jstage.iter_spmd_rejections(jroot, swapped)]
    memo = {}
    pctx = PC.ConvertContext()
    for rid, j in swapped.exchanges.items():
        pctx.exchanges[rid] = PC.ShuffleJob(
            rid, to_port(j.child, memo), to_port(j.partitioning, memo))
    for rid, j in swapped.broadcasts.items():
        pctx.broadcasts[rid] = PC.BroadcastJob(rid, to_port(j.child, memo))
    port = [(n.kind, r) for n, r in
            pstage.iter_spmd_rejections(to_port(jroot, memo), pctx)]
    return ref, port


# -- tests -------------------------------------------------------------------

@pytest.mark.parametrize("name", queries.names())
def test_rejections_are_the_references(name, catalog):
    ref, port = rejections(name, catalog)
    assert port == ref


@pytest.mark.parametrize("name", GATE)
def test_gate_query_takes_the_references_path(name, catalog):
    K.reset_launches()
    plan, port = run_port(name, catalog)
    ref = JaxSession().execute(plan)
    orc = _oracle_table(plan)
    ordered = compare.plan_is_ordered(plan)
    assert port.spmd == ref.spmd
    assert port.spmd, port.spmd_rejection
    assert port.metrics["num_fallbacks"] == 0
    assert compare.compare_tables(port_table(port), orc,
                                  ordered=ordered) is None
    assert compare.compare_tables(ref.table, orc, ordered=ordered) is None
    # the stage path launches neither kernel
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}


@pytest.mark.parametrize("name", GATE)
def test_gate_query_on_the_serial_path(name, catalog):
    plan, port = run_port(name, catalog, stage=False)
    assert not port.spmd and port.spmd_rejection is None
    assert port.metrics["serial_tasks"] > 0
    assert compare.compare_tables(
        port_table(port), _oracle_table(plan),
        ordered=compare.plan_is_ordered(plan)) is None

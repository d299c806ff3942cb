"""A foreign plan through the port's `AuronSession.execute` (tag,
convert, the stage path first, the serial path where the reference
falls back), over the IT corpus at SF 0.01, seed 7.

The port reads no file, so its convert provider
`converters.ScanSourceProvider` claims each FileSourceScanExec: an
FFIReader, one split per file group, over a ForeignSource that wraps
the scan.  The test
foreign engine (`PortEngine`) answers a scan by reading the group's
parquet files with pyarrow into a SourceTable, and any other node
through `it/oracle.py::PyArrowEngine`, converting the tables at the
boundary.  The JAX package's session gets the same provider over its
own classes (`torch_parity.scan_provider`, registered at run time) and
`PyArrowEngine`, so both run the same converted plan.

- The 16 gate queries of `IT_PERF.json`: equal to the oracle under
  `compare_tables(ordered=plan_is_ordered(plan))`, on the stage path as
  the JAX package's session, with its count of foreign sections (each
  claimed scan is one, and the engine ran nothing but those scans), no
  kernel launched; and with `auron.spmd.singleDevice.enable` off, on
  the port's serial path.
- Foreign sections (q65w with `auron.enable.window` off, q13a and q01
  with `auron.enable.bhj` off): the engine runs the section, over
  native children where it has them, under a native root through a C2N
  reader in q01; the result equals the oracle, and neither session is
  all native.
- Foreign only (`auron.enable` off), a local table's rows, no provider
  (the port refuses the parquet scan, naming ROADMAP Queue 1 item 13)
  and no engine where one is needed.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from auron_tpu import config as jconfig
from auron_tpu.frontend import converters as JC
from auron_tpu.frontend import foreign as JF
from auron_tpu.frontend.session import AuronSession as JaxSession
from auron_tpu.ir.node import _decode as jdecode
from auron_tpu.ir.schema import to_arrow_type
from auron_tpu.it import compare, datagen, queries
from auron_tpu.it.oracle import PyArrowEngine
from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend import converters as PC
from auron_tpu_torch.frontend import foreign as PF
from auron_tpu_torch.frontend.session import AuronSession
from auron_tpu_torch.ir.node import _encode as pencode
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.ops import kernels_cuda as K
from auron_tpu_torch.ops.scan.ipc import SourceTable, arrow_to_numpy

from test_torch_corpus_aggs import _oracle_table
from test_torch_session import GATE, port_table
from torch_parity import one_thread, scan_provider  # noqa: F401  (autouse)

SF = 0.01
SCAN_BATCH = 1000


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


@pytest.fixture
def providers():
    jp, pp = scan_provider(JC), scan_provider(PC)
    JC.register_provider(jp)
    PC.register_provider(pp)
    yield
    JC.unregister_provider(jp)
    PC.unregister_provider(pp)


def arrow_table(table: SourceTable, schema: Schema) -> pa.Table:
    arrays, validities = table.columns(len(schema))
    return pa.Table.from_arrays(
        [pa.array(a, type=to_arrow_type(jdecode(pencode(f.dtype))),
                  mask=None if v is None else ~np.asarray(v, bool))
         for a, v, f in zip(arrays, validities, schema.fields)],
        names=list(schema.names()))


class EngineTable(SourceTable):
    """An engine's result: its rows as a SourceTable, and the pyarrow
    table itself for the engine's next node (the oracle's partial
    aggregation passes its rows through, not the declared states)."""

    def __init__(self, arrow: pa.Table):
        super().__init__([[arrow_to_numpy(rb)
                           for rb in arrow.combine_chunks().to_batches()]])
        self.arrow = arrow


class PortEngine:
    """The port's foreign engine of these tests (see the module
    docstring); `ran` lists the ops it executed."""

    def __init__(self):
        self.ran = []

    def execute(self, node, child_tables):
        self.ran.append(node.op)
        if node.op == "FileSourceScanExec":
            names = list(node.output.names())
            return SourceTable([
                [arrow_to_numpy(rb) for rb in pq.read_table(
                    list(g), columns=names).combine_chunks()
                 .to_batches(max_chunksize=SCAN_BATCH)]
                for g in node.attrs["file_groups"]])
        tables = [t.arrow if isinstance(t, EngineTable) else
                  arrow_table(t, c.output)
                  for t, c in zip(child_tables, node.children)]
        return EngineTable(PyArrowEngine().execute(
            JF.ForeignNode.from_json(node.to_json()), tables))


def run_port(plan, engine=None, device="cpu"):
    port_plan = PF.ForeignNode.from_json(plan.to_json())
    return AuronSession(foreign_engine=engine or PortEngine()).execute(
        port_plan, device=device)


def assert_only_scans_went_foreign(res, engine):
    """The only foreign sections are the scans the provider claimed, and
    the engine served each of them once and ran nothing else."""
    assert not isinstance(res.converted, PC.ForeignWrap)
    ops = [s.node.node.op for s in res.ctx.sources.values()
           if not s.node.children]
    assert res.foreign_sections == len(res.ctx.sources) == len(ops)
    assert sorted(engine.ran) == sorted(ops)
    assert set(ops) == {"FileSourceScanExec"}


def assert_oracle(res, plan):
    assert compare.compare_tables(
        port_table(res), _oracle_table(plan),
        ordered=compare.plan_is_ordered(plan)) is None


@pytest.mark.parametrize("name", GATE)
def test_gate_query_through_execute(name, catalog, providers):
    plan = queries.build(name, catalog)
    K.reset_launches()
    engine = PortEngine()
    res = run_port(plan, engine)
    ref = JaxSession(foreign_engine=PyArrowEngine()).execute(plan)
    assert res.spmd == ref.spmd
    assert res.spmd, res.spmd_rejection
    assert res.metrics["num_fallbacks"] == 0
    # both count each claimed scan as a foreign section; the engine ran
    # those scans, once each, and nothing else
    assert res.all_native() == ref.all_native()
    assert res.foreign_sections == ref._foreign_sections
    assert_only_scans_went_foreign(res, engine)
    assert res.convert_s > 0 and res.tags is not None
    assert_oracle(res, plan)
    # the stage path launches neither kernel
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}


@pytest.mark.parametrize("name", GATE)
def test_gate_query_through_execute_serially(name, catalog, providers):
    plan = queries.build(name, catalog)
    engine = PortEngine()
    with conf.scoped({"auron.spmd.singleDevice.enable": False}):
        res = run_port(plan, engine)
    assert not res.spmd and res.spmd_rejection is None
    assert res.metrics["serial_tasks"] > 0
    assert_only_scans_went_foreign(res, engine)
    assert_oracle(res, plan)


def test_foreign_section_runs_on_the_engine(catalog, providers):
    plan = queries.build("q65w", catalog)
    engine = PortEngine()
    kv = {"auron.enable.window": False}
    with conf.scoped(kv):
        res = run_port(plan, engine)
    with jconfig.conf.scoped(kv):
        ref = JaxSession(foreign_engine=PyArrowEngine()).execute(plan)
    assert {"WindowExec", "FilterExec",
            "TakeOrderedAndProjectExec"} <= set(engine.ran)
    assert not res.all_native() and not ref.all_native()
    assert res.spmd == ref.spmd
    assert_oracle(res, plan)


def test_foreign_joins_demote_the_aggregation(catalog, providers):
    """q13a with the broadcast hash join off: the joins stay foreign, and
    so does everything above them (an aggregation over a foreign child,
    and the exchange over that aggregation, are demoted)."""
    plan = queries.build("q13a", catalog)
    engine = PortEngine()
    with conf.scoped({"auron.enable.bhj": False}):
        res = run_port(plan, engine)
    assert {"BroadcastHashJoinExec", "HashAggregateExec",
            "ShuffleExchangeExec"} <= set(engine.ran)
    assert not res.all_native()
    assert_oracle(res, plan)


def test_foreign_section_under_a_native_root(catalog, providers):
    """q01 with the broadcast hash join off: the join and the Filter over
    it stay foreign over native children (the ctr aggregation and the
    thresholds' broadcast, run serially and handed over as tables); the
    exchange above them converts, reading the section through a C2N
    reader, and the root is native, on the JAX package's path."""
    plan = queries.build("q01", catalog)
    engine = PortEngine()
    kv = {"auron.enable.bhj": False}
    with conf.scoped(kv):
        res = run_port(plan, engine)
    with jconfig.conf.scoped(kv):
        ref = JaxSession(foreign_engine=PyArrowEngine()).execute(plan)
    assert not isinstance(res.converted, PC.ForeignWrap)
    assert res.foreign_sections == ref._foreign_sections
    assert not res.all_native() and not ref.all_native()
    assert sum(1 for s in res.ctx.sources.values() if s.node.children) == 1
    assert any(rid.startswith("c2n:") for rid in res.ctx.sources)
    assert {"BroadcastHashJoinExec", "FilterExec"} <= set(engine.ran)
    assert res.spmd == ref.spmd
    assert_oracle(res, plan)


def test_foreign_only(catalog):
    plan = queries.build("q01", catalog)
    engine = PortEngine()
    with conf.scoped({"auron.enable": False}):
        res = run_port(plan, engine)
    assert res.converted is None and not res.all_native()
    assert engine.ran[-1] == "TakeOrderedAndProjectExec"
    assert_oracle(res, plan)


def test_parquet_scan_without_a_provider_is_refused(catalog):
    engine = PortEngine()
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        run_port(queries.build("q01", catalog), engine)
    assert engine.ran == []


def test_no_engine_where_one_is_needed(catalog, providers):
    with pytest.raises(RuntimeError, match="no foreign engine"):
        AuronSession().execute(PF.ForeignNode.from_json(
            queries.build("q13a", catalog).to_json()), device="cpu")


def test_local_table_needs_no_engine():
    """A child-less LocalTableScanExec is read from its rows by the port
    itself (strings, nulls), under a native Filter and Project, equal
    to the JAX package's session."""
    i64, st = DataType.int64(), DataType.string()
    out = Schema.of(Field("k", i64), Field("s", st))
    rows = [{"k": 1, "s": "a"}, {"k": None, "s": "bb"}, {"k": 3, "s": None},
            {"k": 4, "s": "dddd"}]
    scan = PF.ForeignNode("LocalTableScanExec", output=out,
                          attrs={"rows": rows})
    filt = PF.ForeignNode("FilterExec", children=(scan,), output=out,
                          attrs={"condition": PF.fcall(
                              "IsNotNull", PF.fcol("k", i64),
                              dtype=DataType.bool_())})
    proj_out = Schema.of(Field("k2", i64), Field("s", st))
    plan = PF.ForeignNode("ProjectExec", children=(filt,), output=proj_out,
                          attrs={"project_list": [
                              PF.falias(PF.fcall("Add", PF.fcol("k", i64),
                                                 PF.flit(1, i64), dtype=i64),
                                        "k2"),
                              PF.fcol("s", st)]})
    res = AuronSession().execute(plan, device="cpu")
    ref = JaxSession().execute(JF.ForeignNode.from_json(plan.to_json()))
    assert res.all_native() and res.foreign_sections == 0
    assert compare.compare_tables(port_table(res), ref.table,
                                  ordered=True) is None
    assert res.columns["k2"][0].tolist() == [2, 4, 5]

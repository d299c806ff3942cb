"""The port's tracing, metrics, counters, events and task logging
(auron_tpu_torch/runtime/) against the JAX package's modules on the same
inputs, and the traces of queries through the port's session on the
CPU.

- Recorder: spans, nesting, error spans, bounded drops, drains; the
  same span script through both packages gives the same spans, and the
  same Chrome-trace document once ids and times are taken out; each
  package's `validate_chrome_trace` accepts the other's document, and
  both `summarize_chrome_trace` give one text on one document.
- A query id reaches the `task_logging` prefixes; counters, histograms,
  events and `MetricNode` give the JAX package's values.
- The session: with tracing off a query still gets an id and a record,
  and `SessionResult.trace` is None; a traced serial query (SF 0.002)
  holds the span families `query`, `plan.convert`, `exchange.map`,
  `task.execute`, `shuffle.push`, `shuffle.commit`,
  `shuffle.fetch.part` and one `op.complete` event per operator and
  stream; under a small memory budget, `spill.write` spans naming the
  tier and `mem.spill` events, one per spill the manager arbitrated; a
  traced stage-path query the `spmd.*` spans.
- `kernel.build` events from the nvcc build (the compiler faked), the
  trace CLI and the runner's `analyze` / `trace_dir` options.
"""

import json
import logging
import os

import numpy as np
import pytest

from auron_tpu.runtime import counters as jcounters
from auron_tpu.runtime import events as jevents
from auron_tpu.runtime import task_logging as jlogging
from auron_tpu.runtime import tracing as JT
from auron_tpu.runtime.metrics import MetricNode as JNode
from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend import converters as PC
from auron_tpu_torch.frontend.session import AuronSession
from auron_tpu_torch.it import datagen as pdatagen
from auron_tpu_torch.it import queries as pqueries
from auron_tpu_torch.memmgr import manager as M
from auron_tpu_torch.runtime import counters as pcounters
from auron_tpu_torch.runtime import events as pevents
from auron_tpu_torch.runtime import explain_analyze as PEA
from auron_tpu_torch.runtime import task_logging as plogging
from auron_tpu_torch.runtime import tracing as PT
from auron_tpu_torch.runtime.metrics import MetricNode as PNode

from torch_parity import one_thread  # noqa: F401  (autouse)

SF, SEED, CHUNKS = 0.002, 7, 3
SERIAL_FAMILIES = {"query", "plan.convert", "exchange.map", "task.execute",
                   "shuffle.push", "shuffle.commit", "shuffle.fetch.part",
                   "op.complete"}
STAGE_FAMILIES = {"query", "plan.convert", "spmd.execute", "spmd.launch",
                  "spmd.ingest", "spmd.run", "spmd.gather"}


# ---------------------------------------------------------------------------
# the recorder against the JAX package's
# ---------------------------------------------------------------------------

def span_script(T):
    """One sequence of spans and events through a tracing module: a
    nest, an instant, an error span and two drops past the bound."""
    rec = T.TraceRecorder("qtest", max_events=6)
    with T.trace_scope(recorder=rec, query_id="qtest"):
        assert T.current_query_id() == "qtest"
        with T.span("outer", cat="t", k=1):
            with T.span("inner", cat="t") as sp:
                sp.set_args(nbytes=12)
        T.event("marker", cat="t", note="hi")
        with pytest.raises(ValueError):
            with T.span("boom", cat="t"):
                raise ValueError("nope")
        for i in range(4):
            T.event("extra", cat="t", i=i)
    assert T.current_recorder() is None and T.current_query_id() is None
    return rec


def _normalized(doc):
    """A Chrome-trace document without its times and ids."""
    evs = []
    for ev in doc["traceEvents"]:
        ev = {k: v for k, v in ev.items()
              if k not in ("ts", "dur", "pid", "tid")}
        evs.append(ev)
    other = {k: v for k, v in doc["otherData"].items() if k != "wall_start"}
    return {"traceEvents": evs, "displayTimeUnit": doc["displayTimeUnit"],
            "otherData": other}


def test_span_script_gives_the_jax_spans_and_document():
    jr, pr = span_script(JT), span_script(PT)
    key = [(s.name, s.cat, s.dur_ns < 0, s.args, s.thread)
           for s in pr.snapshot()]
    assert key == [(s.name, s.cat, s.dur_ns < 0, s.args, s.thread)
                   for s in jr.snapshot()]
    assert [s.name for s in pr.snapshot()] == \
        ["inner", "outer", "marker", "boom", "extra", "extra"]
    assert pr.dropped == jr.dropped == 2
    assert "ValueError: nope" in pr.snapshot()[3].args["error"]
    pdoc, jdoc = pr.to_chrome_trace(), jr.to_chrome_trace()
    assert _normalized(pdoc) == _normalized(jdoc)
    assert pdoc["otherData"]["trace_truncated"] is True
    assert PT.validate_chrome_trace(jdoc) == []
    assert JT.validate_chrome_trace(pdoc) == []
    xs = {e["name"]: e for e in pdoc["traceEvents"] if e["ph"] == "X"}
    assert xs["outer"]["ts"] <= xs["inner"]["ts"]
    assert xs["inner"]["ts"] + xs["inner"]["dur"] <= \
        xs["outer"]["ts"] + xs["outer"]["dur"] + 1e-3
    assert json.loads(json.dumps(pdoc))


def test_span_is_a_shared_noop_when_off():
    assert PT.current_recorder() is None
    s = PT.span("anything", cat="x")
    assert s is PT.span("other")
    with s:
        s.set_args(n=1)
    PT.event("nothing")


def test_drains_match_the_jax_package():
    out = []
    for T in (JT, PT):
        rec = T.TraceRecorder("qd", max_events=100)
        with T.trace_scope(recorder=rec):
            for i in range(5):
                T.event("e", i=i)
        spans, first, nxt = rec.drain_since(2)
        got = [[s.args["i"] for s in spans], first, nxt]
        spans, cursor = rec.drain()
        got += [[s.args["i"] for s in spans], cursor, rec.snapshot()]
        out.append(got)
    assert out[0] == out[1]


@pytest.mark.parametrize("bad", [
    [], {}, {"traceEvents": [{"name": "", "ph": "Z", "ts": -5},
                             {"name": "x", "ph": "X", "ts": 0.0},
                             "not-an-object"]},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 1, "dur": 2,
                      "pid": "p", "args": []}]}])
def test_validate_gives_the_jax_errors(bad):
    assert PT.validate_chrome_trace(bad) == JT.validate_chrome_trace(bad)
    assert PT.validate_chrome_trace(bad) != []


def _synthetic_doc(seed):
    """A trace of nested and overlapping complete events with fixed
    times, and some instants."""
    rng = np.random.default_rng(seed)
    evs = [{"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": "p"}}]
    for i in range(40):
        t0 = float(rng.integers(0, 10_000))
        evs.append({"name": f"s{int(rng.integers(0, 7))}", "cat": "c",
                    "ph": "X" if i % 5 else "i", "ts": t0,
                    "dur": float(rng.integers(0, 3_000)), "pid": 1,
                    "tid": 1})
    evs.append({"name": "root", "cat": "c", "ph": "X", "ts": 0.0,
                "dur": 20_000.0, "pid": 1, "tid": 1})
    return {"traceEvents": evs, "displayTimeUnit": "ms", "otherData": {}}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("top", [3, 10])
def test_summary_text_equals_the_jax_package(seed, top):
    doc = _synthetic_doc(seed)
    assert PT.summarize_chrome_trace(doc, top) == \
        JT.summarize_chrome_trace(doc, top)
    assert PT.summarize_chrome_trace({"traceEvents": []}) == \
        JT.summarize_chrome_trace({"traceEvents": []})


def test_query_id_reaches_the_task_logging_prefix():
    got = []
    for T, L in ((JT, jlogging), (PT, plogging)):
        f = L.TaskContextFilter()
        rec = logging.LogRecord("x", logging.INFO, "f", 1, "m", (), None)
        seen = []
        f.filter(rec)
        seen.append(rec.task)
        with T.trace_scope(query_id="3f2a9c"):
            f.filter(rec)
            seen.append(rec.task)
            with L.task_scope(1, 7):
                f.filter(rec)
                seen.append(rec.task)
                seen.append(L.current_ids())
        with L.task_scope(2, 0):
            f.filter(rec)
            seen.append(rec.task)
        got.append(seen)
    assert got[0] == got[1]
    assert got[1][2] == "[q 3f2a9c stage 1 part 7] "


def test_counters_and_histograms_match_the_jax_package():
    jcounters.reset()
    pcounters.reset()
    for mod in (jcounters, pcounters):
        for key, n in (("tasks_started", 3), ("queries_failed", 1),
                       ("shuffle_bytes_pushed", 1 << 20), ("custom", 2)):
            mod.bump(key, n)
        for v in (0.001, 0.3, 4.0, 7000.0):
            mod.observe("query_wall_seconds", v)
    jsnap, psnap = jcounters.snapshot(), pcounters.snapshot()
    assert set(psnap) <= set(jsnap)
    assert {k: jsnap[k] for k in psnap} == psnap
    assert pcounters.get("custom") == jcounters.get("custom") == 2
    assert pcounters.histograms()["query_wall_seconds"] == \
        jcounters.histograms()["query_wall_seconds"]
    jcounters.reset()
    pcounters.reset()
    assert pcounters.get("tasks_started") == 0


def test_events_match_the_jax_package():
    got = []
    for mod in (jevents, pevents):
        mod.clear()
        mod.emit("fleet.death", "worker 3 died", ("q1", "q2"), worker=3,
                 gone=None)
        mod.emit("mem.kill", "over budget", ("q2",))
        first = mod.snapshot()[0]["seq"]
        evs = mod.snapshot(since=first - 1, kind="fleet") + \
            mod.snapshot(since=first - 1, query_id="q2")
        got.append([{k: v for k, v in e.items() if k not in ("t", "seq")}
                    for e in evs])
        mod.clear()
        assert mod.snapshot() == []
    assert got[0] == got[1]


def test_event_ring_keeps_the_jax_default_bound():
    lens = []
    for mod in (jevents, pevents):
        mod.clear()
        for i in range(pevents.MAX_EVENTS + 5):
            mod.emit("mem.kill", str(i))
        evs = mod.snapshot()
        lens.append((len(evs), evs[0]["message"], evs[-1]["message"]))
        mod.clear()
    assert lens[0] == lens[1] == \
        (pevents.MAX_EVENTS, "5", str(pevents.MAX_EVENTS + 4))


def test_metric_node_matches_the_jax_package():
    out = []
    for cls in (JNode, PNode):
        root = cls("AggExec")
        root.add("output_rows", 5)
        root.add("output_rows", 2)
        root.set("mem_peak", 9)
        kid = root.child("FFIReaderExec")
        kid.add("output_batches", 1)
        out.append((root.to_dict(), root.render(), root.get("output_rows"),
                    root.get("missing")))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# queries through the port's session
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    return pdatagen.generate("trace-tpcds", sf=SF, seed=SEED,
                             fact_chunks=CHUNKS)


@pytest.fixture
def run(tables):
    """run(name, **conf) -> SessionResult of the port's session on the
    CPU, the scans served by TableEngine."""
    catalog, data = tables
    provider = PC.ScanSourceProvider()
    PC.register_provider(provider)

    def go(name, kv=None):
        with conf.scoped(kv or {}):
            return AuronSession(foreign_engine=pdatagen.TableEngine(
                catalog, data)).execute(pqueries.build(name, catalog),
                                        device="cpu")
    yield go
    PC.unregister_provider(provider)
    M.reset_manager()


def _names(doc, ph=None):
    return [e["name"] for e in doc["traceEvents"]
            if e["ph"] != "M" and (ph is None or e["ph"] == ph)]


def _streamed(trees):
    """The operators whose streams ran: every node with a compute time
    (a broadcast build child that found its table cached never ran)."""
    n = 0
    stack = list(trees)
    while stack:
        t = stack.pop()
        n += "elapsed_compute_ns" in t.values
        stack.extend(t.children)
    return n


def test_tracing_off_still_mints_an_id_and_a_record(run):
    PT.clear_history()
    before = pcounters.get("queries_completed")
    res = run("q03", {"auron.spmd.singleDevice.enable": False})
    assert res.trace is None and res.query_id
    assert pcounters.get("queries_completed") == before + 1
    rec = PT.find_query(res.query_id)
    assert rec is not None and rec.trace is None and not rec.spmd
    assert rec.rows == res.num_rows == 20
    assert rec.metric_totals == PEA.metric_totals(res.metric_trees)
    assert [g["tasks"] for g in rec.metric_trees] == \
        [n for _, n in PEA.merge_metric_trees(res.metric_trees)]
    assert rec.attempts == res.metrics["serial_tasks"]
    assert [t["state"] for t in rec.timeline] == ["running", "succeeded"]
    assert PT.history_metric_totals()["output_rows"] >= \
        rec.metric_totals["output_rows"]


def test_task_logging_leaves_the_package_level_alone(run):
    run("q03", {"auron.spmd.singleDevice.enable": False})
    assert plogging._installed
    assert logging.getLogger("auron_tpu_torch").level == logging.NOTSET
    assert not logging.getLogger(
        "auron_tpu_torch.debug").isEnabledFor(logging.INFO)


@pytest.mark.parametrize("name", ["q01", "q03", "q65w"])
def test_traced_serial_query_holds_the_span_families(run, name):
    res = run(name, {"auron.spmd.singleDevice.enable": False,
                     "auron.trace.enable": True})
    doc = res.trace.to_chrome_trace()
    assert PT.validate_chrome_trace(doc) == []
    assert JT.validate_chrome_trace(doc) == []
    names = _names(doc)
    assert SERIAL_FAMILIES <= set(names), SERIAL_FAMILIES - set(names)
    # one op.complete an operator and stream
    assert names.count("op.complete") == _streamed(res.metric_trees)
    assert names.count("task.execute") == res.metrics["serial_tasks"]
    tasks = [e for e in doc["traceEvents"] if e["name"] == "task.execute"]
    assert all({"stage", "partition"} <= set(e["args"]) for e in tasks)
    q = next(e for e in doc["traceEvents"] if e["name"] == "query")
    assert q["args"]["query_id"] == res.query_id == \
        doc["otherData"]["query_id"]
    assert PT.summarize_chrome_trace(doc) == JT.summarize_chrome_trace(doc)
    # the root stage's merged output rows are the result's rows
    groups = PEA.merge_metric_trees(res.metric_trees)
    root = next(t for t, _ in groups
                if PEA._signature(t) == PEA._signature(res.metric_trees[-1]))
    assert root.get("output_rows") == res.num_rows


def test_traced_stage_path_query_holds_the_spmd_spans(run):
    res = run("q03", {"auron.trace.enable": True})
    assert res.spmd and res.metric_trees == []
    doc = res.trace.to_chrome_trace()
    assert PT.validate_chrome_trace(doc) == []
    assert STAGE_FAMILIES <= set(_names(doc))
    assert "task.execute" in _names(doc)    # the tail's replay task
    text = res.explain_analyze(normalize=True)
    assert "mode=spmd" in text and "no per-operator metrics" in text


def test_stage_refusal_adds_the_fallback_node(run, monkeypatch):
    """A plan the stage executor refuses runs serially, and its trees
    hold one SpmdFallback node."""
    import auron_tpu_torch.frontend.session as S

    def refuse(plan, ctx):
        raise S.SpmdUnsupported("refused for the test")
    monkeypatch.setattr(S, "precheck_plan", refuse)
    res = run("q65w", {"auron.trace.enable": True})
    assert not res.spmd and res.metrics["num_fallbacks"] == 1
    assert [t.name for t in res.metric_trees].count("SpmdFallback") == 1
    assert "fallbacks=1" in res.explain_analyze(normalize=True)
    assert PT.find_query(res.query_id).fallbacks == 1


@pytest.mark.parametrize("host_first", [True, False])
def test_traced_spill_records_the_tier_and_the_spills(run, host_first):
    M.reset_manager(64 << 10)
    mgr = M.get_manager()
    res = run("q01", {"auron.spmd.singleDevice.enable": False,
                      "auron.trace.enable": True,
                      "auron.memory.spill.min.trigger.bytes": 1024,
                      "auron.spill.host.memory.first": host_first})
    doc = res.trace.to_chrome_trace()
    assert PT.validate_chrome_trace(doc) == []
    writes = [e for e in doc["traceEvents"] if e["name"] == "spill.write"]
    spills = [e for e in doc["traceEvents"] if e["name"] == "mem.spill"]
    tier = "host" if host_first else "file"
    total = PEA.metric_totals(res.metric_trees)
    assert writes and spills and mgr.num_spills == len(spills)
    assert len(writes) == total["mem_spill_count"] == \
        total[f"mem_spill_{tier}"]
    assert {e["args"]["tier"] for e in writes} == {tier}
    assert sum(e["args"]["nbytes"] for e in writes) == \
        total["mem_spill_size"]
    assert all(e["cat"] == "mem" and e["args"]["consumer"]
               for e in spills)
    reads = [e for e in doc["traceEvents"] if e["name"] == "spill.read"]
    assert reads and {e["args"]["tier"] for e in reads} == {tier}
    rec = PT.find_query(res.query_id)
    assert rec.mem_spills == mgr.num_spills
    assert rec.mem_spill_bytes == mgr.spill_bytes_freed
    assert rec.mem_peak == PEA.metric_max(res.metric_trees, "mem_peak") > 0
    assert "mem_spill_count=" in res.explain_analyze(normalize=True)


def test_memory_pressure_events(run):
    M.reset_manager(64 << 10)
    res = run("q01", {"auron.spmd.singleDevice.enable": False,
                      "auron.trace.enable": True,
                      "auron.memory.spill.min.trigger.bytes": 1024})
    doc = res.trace.to_chrome_trace()
    fracs = [e["args"]["fraction"] for e in doc["traceEvents"]
             if e["name"] == "mem.pressure"]
    assert fracs == sorted(fracs) and fracs
    assert fracs == [c["fraction"] for c in
                     M.get_manager().stats()["watermarks_crossed"]]


def test_trace_bound_drops_and_counts(run):
    before = pcounters.get("trace_dropped_events")
    res = run("q03", {"auron.spmd.singleDevice.enable": False,
                      "auron.trace.enable": True,
                      "auron.trace.max.events": 10})
    doc = res.trace.to_chrome_trace()
    assert len(_names(doc)) == 10 and res.trace.dropped > 0
    assert doc["otherData"]["trace_truncated"] is True
    assert pcounters.get("trace_dropped_events") == \
        before + res.trace.dropped


def test_kernel_build_events(tmp_path, monkeypatch):
    """Each nvcc run records one kernel.build event in the caller's
    trace, from its own thread; built libraries record none."""
    from auron_tpu_torch.ops import kernels_cuda as K

    def fake_nvcc(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("lib")

        class Done:
            returncode, stderr = 0, ""
        return Done()
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(K, "_libs", {})
    monkeypatch.setattr(K, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(K, "_load", lambda name: name)
    monkeypatch.setattr(K.subprocess, "run", fake_nvcc)
    found = []
    for _ in range(2):
        K._libs.clear()
        with conf.scoped({"auron.trace.enable": True}), \
                PT.trace_scope() as sc:
            K.build()
        doc = sc.recorder.to_chrome_trace()
        assert PT.validate_chrome_trace(doc) == []
        found.append(sorted(e["args"]["kernel"] for e in doc["traceEvents"]
                            if e["name"] == "kernel.build"
                            and e["cat"] == "compile"))
    assert found == [sorted(K.SOURCES), []]


def test_trace_cli_runs_validates_and_summarizes(tmp_path, capsys):
    from auron_tpu import trace as jtrace
    from auron_tpu_torch import trace
    out = str(tmp_path / "q03.json")
    assert trace.main(["run", "q03", "--device", "cpu", "--serial",
                       "--analyze", "--fact-chunks", str(CHUNKS),
                       "-o", out]) == 0
    text = capsys.readouterr().out
    assert "== EXPLAIN ANALYZE" in text and "critical path:" in text
    assert "q03: 20 rows on the serial path" in text
    assert trace.main(["validate", out]) == 0
    assert jtrace.main(["validate", out]) == 0
    assert trace.main(["summary", out, "--top", "3"]) == 0
    capsys.readouterr()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "Z"}]}))
    assert trace.main(["validate", str(bad)]) == 2
    assert trace.main(["run", "q01", "--device", "cpu",
                       "--serial", "--budget", str(64 << 10),
                       "--fact-chunks", str(CHUNKS), "-o", out]) == 0
    text = capsys.readouterr().out
    assert "mem: budget=65536" in text and "spills=0" not in text
    assert "spill.write" in {e["name"] for e in
                             json.load(open(out))["traceEvents"]}


def test_runner_keeps_explain_analyze_and_traces(tables, tmp_path):
    from auron_tpu_torch.it.compare import HostTable
    from auron_tpu_torch.it.runner import QueryRunner
    catalog, data = tables
    first = QueryRunner(catalog, data, {}, "cpu")
    provider = PC.ScanSourceProvider()
    PC.register_provider(provider)
    try:
        res = AuronSession(foreign_engine=first.engine).execute(
            pqueries.build("q03", catalog), device="cpu")
    finally:
        PC.unregister_provider(provider)
    runner = QueryRunner(catalog, data, {"q03": HostTable.from_result(res)},
                         "cpu", analyze=True, trace_dir=str(tmp_path))
    with conf.scoped({"auron.trace.enable": True}):
        r = runner.run("q03")
    assert r.ok, r.error
    assert r.analyze.startswith("== EXPLAIN ANALYZE") and "mode=spmd" in \
        r.analyze
    doc = json.load(open(os.path.join(tmp_path, "q03.trace.json")))
    assert PT.validate_chrome_trace(doc) == [] and "spmd.run" in _names(doc)


def test_chip_smoke_phase_30_runs_on_the_cpu(tmp_path, capsys):
    """chip_smoke.py's phase 30 at SF 0.01 with the CPU in the card's
    place, against the JAX oracle's results of its five queries: every
    check passes and each query prints its medians and their ratio."""
    import chip_smoke
    from auron_tpu_torch.it.compare import HostTable
    from auron_tpu_torch.it.runner import QueryRunner
    from auron_tpu_torch.ops import kernels_cuda as K

    from test_torch_it_runner import load_tool
    d = str(tmp_path)
    results = load_tool().derive(d, 0.01, SEED, 4,
                                 names=list(chip_smoke.TRACED_QUERIES))
    expected = {n: HostTable(r["columns"], [tuple(x) for x in r["rows"]])
                for n, r in json.loads(json.dumps(results)).items()}
    catalog, data = pdatagen.generate(d, sf=0.01, seed=SEED)
    runner = QueryRunner(catalog, data, expected, "cpu")
    chip_smoke.run_phase30(runner, "cpu", K, "cpu")
    out = capsys.readouterr().out
    for name in chip_smoke.TRACED_QUERIES:
        assert f"phase 30: {name} stage path" in out and "ratio" in out
    for name in chip_smoke.TRACED_SERIAL:
        assert f"phase 30: {name} serial (traced)" in out
    assert "phase 30: execute_with_metrics adds" in out
    assert "phase 30: serial runs" in out

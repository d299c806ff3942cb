"""The port's corpus runner (`auron_tpu_torch/it/runner.py`) on the CPU,
rehearsing phase 27 of chip_smoke.py: every IT query from its foreign
plan through `QueryRunner(device="cpu")` over the port's SF-0.01 tables,
cold and warm, against results that the JAX package's oracle computes
here over the JAX generator's parquet files (`tools/torch_expected.py`
derives them as it derives the committed file).  Each query's cold
execute and its warm executes equal the oracle: on the stage path
(`FALLBACK`, the queries the stage executor declines, each with its
reason, is empty, so a change that moves one has to move it here), no
kernel launched, the warm executes uploading nothing; `REFUSED`, the
queries the port cannot run, is empty.  An altered expected value fails
its query with the JAX package's message, and a query that raises is a
red row that does not stop the sweep."""

import importlib.util
import json
import pathlib
import statistics

import pyarrow as pa
import pytest

from auron_tpu.frontend import foreign as JF
from auron_tpu.it import compare as JC
from auron_tpu.it import queries as JQ
from auron_tpu_torch.it import datagen as PD
from auron_tpu_torch.it import queries as PQ
from auron_tpu_torch.it.compare import HostTable
from auron_tpu_torch.it.runner import WARM_RUNS, QueryRunner

from torch_parity import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SF, SEED = 0.01, 7

REFUSED = {}

FALLBACK = {}

RUN = [q for q in JQ.names() if q not in REFUSED]


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_expected", ROOT / "tools" / "torch_expected.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpcds"))
    results = load_tool().derive(d, SF, SEED, 4)
    # through the file format, as the committed results reach the runner
    expected = {n: HostTable(r["columns"], [tuple(x) for x in r["rows"]])
                for n, r in json.loads(json.dumps(results)).items()}
    cat, tables = PD.generate(d, sf=SF, seed=SEED)
    return cat, tables, expected


@pytest.fixture(scope="module")
def swept(corpus):
    """Each query's runner and result, run once for its cold and its
    warm case."""
    cat, tables, expected = corpus
    done = {}

    def result(name):
        if name not in done:
            runner = QueryRunner(cat, tables, expected, device="cpu")
            done[name] = runner, runner.run(name)
        return done[name]
    return result


@pytest.mark.parametrize("run", ["cold", "warm"])
@pytest.mark.parametrize("name", RUN)
def test_query_equals_the_oracle_cold_and_warm(name, run, corpus, swept):
    expected = corpus[2]
    runner, r = swept(name)
    assert runner.results == [r]
    assert r.spmd_rejection == FALLBACK.get(name)
    assert r.spmd == (name not in FALLBACK)
    if r.spmd:
        # the stage path launches neither kernel
        assert r.launches == {k: 0 for k in r.launches}
    assert r.peak_bytes is None
    assert len(r.gc_s) == 1 + WARM_RUNS and all(g >= 0 for g in r.gc_s)
    if run == "cold":
        # the runner compares the cold result first
        assert r.error is None or r.error.startswith("warm run: "), r.error
        assert r.rows == expected[name].num_rows
        assert r.convert_s > 0
        assert r.bytes_uploaded[0] > 0
    else:
        assert r.ok, r.error
        assert len(r.warm_s) == WARM_RUNS
        assert r.native_warm_s == statistics.median(r.warm_s)
        assert r.bytes_uploaded[1] == 0
        assert r.host_syncs[0] == r.host_syncs[1]


def _arrow(t: HostTable) -> pa.Table:
    return pa.Table.from_pylist([dict(zip(t.names, r)) for r in t.rows])


def test_altered_value_fails_with_the_reference_message(corpus):
    cat, tables, expected = corpus
    name = "q03"
    good = expected[name]
    row = list(good.rows[3])
    c = next(i for i, v in enumerate(row) if isinstance(v, float))
    row[c] += 1
    altered = HostTable(good.names, good.rows[:3] + [tuple(row)] +
                        good.rows[4:])
    runner = QueryRunner(cat, tables, {**expected, name: altered},
                         device="cpu")
    r = runner.run(name)
    assert not r.ok
    plan = JF.ForeignNode.from_json(PQ.build(name, cat).to_json())
    want = JC.compare_tables(_arrow(good), _arrow(altered),
                             ordered=JC.plan_is_ordered(plan))
    assert want is not None and r.error == want


def test_sweep_keeps_going_past_a_failure(corpus):
    cat, tables, expected = corpus
    runner = QueryRunner(cat, tables, {"q96": expected["q96"]},
                         device="cpu")
    seen = []
    runner.run_all(["q41d", "q96"], on_result=seen.append)
    assert [r.name for r in seen] == ["q41d", "q96"]
    bad, good = runner.results
    assert not bad.ok and bad.error.startswith("KeyError") and bad.trace
    assert good.ok
    assert "1/2 passed" in runner.report()
    assert [d["name"] for d in json.loads(runner.to_json())] == \
        ["q41d", "q96"]

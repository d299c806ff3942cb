"""TPC-DS queries whole on auron_tpu_torch's serial path under a memory
budget small enough that each spills, against the pyarrow oracle.

q01 (sort-merge join, take-ordered by a string key), q17m (two-key
sort-merge join, stddev), q39v (sort-merge join of two months), q65w
(window) and q27r (expand under the partial aggregation) run as
`test_torch_corpus_all.py::run_query` runs them, at SF 0.01, seed 7,
with a 64 KiB budget and no minimum spill size, and are compared as
that test compares them (`compare_tables(ordered=True)`).  Each must
spill, in the operators its plan has.
"""

import pytest

from auron_tpu.it import datagen, queries
from auron_tpu.it import compare
from auron_tpu_torch.config import conf
from auron_tpu_torch.memmgr import manager as pmm

from test_torch_corpus_aggs import _oracle_table
from test_torch_corpus_all import run_query
from test_torch_corpus_joins import _PortE
from torch_parity import one_thread  # noqa: F401  (autouse)

SF = 0.01
BUDGET = 64 * 1024
# the consumers that must have spilled in each query
SPILLED = {"q01": {"SortMergeJoinExec", "AggExec", "SortExec"},
           "q17m": {"SortMergeJoinExec", "AggExec", "SortExec"},
           "q39v": {"SortMergeJoinExec", "AggExec", "SortExec"},
           "q65w": {"WindowExec", "AggExec", "SortExec"},
           "q27r": {"AggExec", "SortExec"}}


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


@pytest.mark.parametrize("name", sorted(SPILLED))
def test_query_under_a_budget_equals_the_oracle(name, catalog):
    try:
        with conf.scoped({"auron.memory.spill.min.trigger.bytes": 1}):
            mgr = pmm.reset_manager(BUDGET)
            port = run_query(_PortE, name, catalog)
    finally:
        pmm.reset_manager()
    orc = _oracle_table(queries.build(name, catalog))
    assert compare.compare_tables(port, orc, ordered=True) is None
    spilled = {n for n, t in mgr.consumer_totals().items() if t["spills"]}
    assert SPILLED[name] <= spilled, spilled

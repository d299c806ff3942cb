"""Every query of the IT corpus (`auron_tpu/it/queries.py`) through the
port's session on the CPU, whole, against the pyarrow oracle, at SF
0.01, seed 7: the stage executor where it accepts the plan, the serial
path where it declines it (`test_torch_session.py::port_query` carries
the converted query into the port).  No query may raise: `REFUSED`, the
queries the port cannot run, is empty.  `FALLBACK` lists the queries
the stage executor declines, each with its reason, so a change that
moves one has to move it here.
"""

import pytest

from auron_tpu.it import compare, datagen, queries
from auron_tpu_torch.ops import kernels_cuda as K

from test_torch_corpus_aggs import _oracle_table
from test_torch_session import port_table, run_port
from torch_parity import one_thread  # noqa: F401  (autouse)

SF = 0.01

REFUSED = {}

FALLBACK = {}


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return datagen.generate(str(tmp_path_factory.mktemp("tpcds")), sf=SF,
                            seed=7)


RUN = [q for q in queries.names() if q not in REFUSED]


@pytest.mark.parametrize("name", RUN)
def test_query_through_the_session_equals_the_oracle(name, catalog):
    K.reset_launches()
    plan, res = run_port(name, catalog)
    assert res.spmd_rejection == FALLBACK.get(name)
    assert res.spmd == (name not in FALLBACK)
    assert compare.compare_tables(
        port_table(res), _oracle_table(plan),
        ordered=compare.plan_is_ordered(plan)) is None
    if res.spmd:
        # the stage path launches neither kernel
        assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}

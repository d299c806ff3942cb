"""The port's TPC-DS query builders (`auron_tpu_torch/it/queries.py`)
against the JAX package's: every plan byte-equal in JSON over catalogs
of the same data directory, and the queries in the same order."""

import pytest

from auron_tpu.it import datagen as JD
from auron_tpu.it import queries as JQ
from auron_tpu_torch.it import datagen as PD
from auron_tpu_torch.it import queries as PQ


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpcds"))
    return JD.generate(d, sf=0.01, seed=7), PD.generate(d, sf=0.01,
                                                        seed=7)[0]


def test_names_in_the_reference_order():
    assert PQ.names() == JQ.names()
    assert len(PQ.names()) == 103


@pytest.mark.parametrize("name", JQ.names())
def test_plan_json_equals_the_reference(name, catalogs):
    jcat, pcat = catalogs
    assert PQ.build(name, pcat).to_json() == JQ.build(name, jcat).to_json()

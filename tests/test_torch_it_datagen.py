"""The port's TPC-DS generator (`auron_tpu_torch/it/datagen.py`) against
the JAX package's (`auron_tpu/it/datagen.py`): the same tables bit for
bit, read back from the JAX package's parquet files with pyarrow, at
two (sf, seed, fact_chunks); the same catalog; the port's
`TableEngine` serving the catalog's scans; and the generator without
pyarrow."""

import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from auron_tpu.it import datagen as JD
from auron_tpu_torch.config import conf
from auron_tpu_torch.frontend.foreign import ForeignNode
from auron_tpu_torch.it import datagen as PD

CASES = [(0.01, 7, 4), (0.03, 11, 3)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "sf%g-seed%d-"
                "chunks%d" % c)
def both(request, tmp_path_factory):
    sf, seed, chunks = request.param
    d = str(tmp_path_factory.mktemp("tpcds"))
    jcat = JD.generate(d, sf=sf, seed=seed, fact_chunks=chunks)
    pcat, tables = PD.generate(d, sf=sf, seed=seed, fact_chunks=chunks)
    return jcat, pcat, tables


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64) if a.dtype == np.float64 else a


def test_version_is_the_reference_s():
    assert PD._DATAGEN_VERSION == JD._DATAGEN_VERSION == 2


def test_same_tables_and_catalog(both):
    jcat, pcat, tables = both
    assert list(pcat.tables) == list(jcat.tables) == list(tables)
    assert pcat.data_dir == jcat.data_dir
    for name, jt in jcat.tables.items():
        pt = pcat.tables[name]
        assert pt.chunks == jt.chunks, name
        # the schema with nullability and the file groups, as the plans
        # carry them
        assert pt.schema.names() == jt.schema.names()
        assert pcat.scan(name).to_json() == jcat.scan(name).to_json()
        arrays, validities = tables[name]
        assert len(arrays) == len(validities) == len(jt.schema.names())
        parts = [pq.read_table(p) for p in jt.chunks]
        bounds = PD.chunk_bounds(len(arrays[0]), len(pt.chunks))
        assert [p.num_rows for p in parts] == list(np.diff(bounds)), name
        whole = pa.concat_tables(parts).combine_chunks()
        for i, cname in enumerate(jt.schema.names()):
            col = whole[cname].combine_chunks()
            a, v = arrays[i], validities[i]
            assert v.dtype == bool and len(v) == len(a) == len(col)
            assert np.array_equal(v, np.asarray(col.is_valid())), cname
            if pa.types.is_string(col.type):
                assert a.dtype == object, cname
                assert list(a) == col.to_pylist(), cname
            elif pa.types.is_date32(col.type):
                assert a.dtype == np.int32, cname
                assert np.array_equal(
                    a, col.cast(pa.int32()).to_numpy()), cname
            else:
                exp = col.to_numpy()
                assert a.dtype == exp.dtype, cname
                assert np.array_equal(_bits(a), _bits(exp)), cname


def test_meal_time_nulls(both):
    _, pcat, tables = both
    i = pcat.tables["time_dim"].schema.index_of("t_meal_time")
    vals, valid = tables["time_dim"][0][i], tables["time_dim"][1][i]
    hours = np.arange(24 * 60) // 60
    meal = ((hours >= 6) & (hours < 9)) | ((hours >= 11) & (hours < 13)) | \
        ((hours >= 17) & (hours < 20))
    assert np.array_equal(valid, meal)
    assert all(v is None for v in vals[~valid])


def test_engine_serves_each_file_group(both):
    _, pcat, tables = both
    engine = PD.TableEngine(pcat, tables)
    cols = ["ss_item_sk", "ss_net_profit"]
    arrays, validities = tables["store_sales"]
    idx = [pcat.tables["store_sales"].schema.index_of(c) for c in cols]
    bounds = PD.chunk_bounds(len(arrays[0]),
                             len(pcat.tables["store_sales"].chunks))
    for parts in (None, 2, 1):
        scan = pcat.scan("store_sales", cols, parts=parts)
        with conf.scoped({"auron.batch.size": 700}):
            table = engine.execute(scan, [])
        groups = scan.attrs["file_groups"]
        assert len(table.parts) == len(groups)
        rows = []
        for g, part in zip(groups, table.parts):
            ks = [pcat.tables["store_sales"].chunks.index(p) for p in g]
            want = np.concatenate([np.arange(bounds[k], bounds[k + 1])
                                   for k in ks])
            rows.append(want)
            got = [np.concatenate([it[0][j] for it in part])
                   for j in range(len(cols))]
            assert all(len(it[0][0]) <= 700 for it in part)
            for j, i in enumerate(idx):
                assert np.array_equal(got[j], arrays[i][want])
        whole, wvalid = table.columns(len(cols))
        order = np.concatenate(rows)
        for j, i in enumerate(idx):
            assert np.array_equal(whole[j], arrays[i][order])
            assert np.array_equal(wvalid[j], validities[i][order])
        # the same scan again: the same table object
        assert engine.execute(pcat.scan("store_sales", cols, parts=parts),
                              []) is table
    assert engine.scans == 6


def test_engine_refuses_other_nodes(both):
    _, pcat, tables = both
    engine = PD.TableEngine(pcat, tables)
    scan = pcat.scan("store", ["s_store_sk"])
    node = ForeignNode("FilterExec", children=(scan,), output=scan.output,
                       attrs={"condition": None})
    with pytest.raises(NotImplementedError, match="FilterExec"):
        engine.execute(node, [])
    bad = ForeignNode("FileSourceScanExec", output=scan.output,
                      attrs={"file_groups": [["elsewhere.parquet"]]})
    with pytest.raises(ValueError, match="elsewhere"):
        engine.execute(bad, [])
    assert engine.scans == 1


def test_generates_without_pyarrow(tmp_path):
    code = ("import sys\n"
            "sys.modules['pyarrow'] = None\n"
            "import auron_tpu_torch.it\n"
            "from auron_tpu_torch.it import compare, queries, runner\n"
            "from auron_tpu_torch.it.datagen import generate\n"
            f"cat, tables = generate({str(tmp_path)!r}, sf=0.01)\n"
            "assert len(tables['store_sales'][0][0]) == 10000\n"
            "assert len(queries.names()) == 103\n"
            "assert 'pyarrow' not in sys.modules or "
            "sys.modules['pyarrow'] is None\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

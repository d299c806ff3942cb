"""The committed expected results of the port's corpus
(`auron_tpu_torch/it/expected_sf1_seed7.json`): the header and the
query names, and `load_expected` refusing a file whose header or
queries differ; the three queries with the least oracle time at SF 1
(`IT_SF1.json`: q41d, q84d, q96) re-derived by the JAX package's oracle
over its SF-1 parquet files and equal to the file; and the CLI, which
runs two of them on the CPU over the port's SF-1 tables and refuses an
(sf, seed) the repo holds no results for."""

import importlib.util
import json
import pathlib

import pytest
import torch

from auron_tpu_torch.it import datagen as PD
from auron_tpu_torch.it import queries as PQ
from auron_tpu_torch.it.__main__ import main
from auron_tpu_torch.it.runner import expected_path, load_expected

from torch_parity import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PATH = ROOT / "auron_tpu_torch" / "it" / "expected_sf1_seed7.json"
CHEAPEST = ["q41d", "q84d", "q96"]


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_expected", ROOT / "tools" / "torch_expected.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_header_and_names():
    assert pathlib.Path(expected_path(1.0, 7)) == PATH
    head, tables = load_expected(1.0, 7)
    assert head == {"sf": 1.0, "seed": 7, "fact_chunks": 4,
                    "datagen_version": PD._DATAGEN_VERSION,
                    "names": PQ.names()}
    assert list(tables) == PQ.names()
    assert all(t.names and all(len(r) == len(t.names) for r in t.rows)
               for t in tables.values())


@pytest.mark.parametrize("key, value", [
    ("sf", 0.5), ("seed", 8), ("fact_chunks", 3), ("datagen_version", 1),
    ("names", ["q01"]), ("queries", "q96")])
def test_a_header_that_differs_is_refused(key, value, tmp_path):
    with open(PATH) as f:
        doc = json.load(f)
    if key == "queries":            # a query's results missing
        del doc["queries"][value]
    else:
        doc[key] = value
    path = tmp_path / "expected.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="tools/torch_expected.py") as e:
        load_expected(1.0, 7, path=str(path))
    assert key in str(e.value)
    with pytest.raises(FileNotFoundError, match="tools/torch_expected.py"):
        load_expected(1.0, 7, path=str(tmp_path / "none.json"))


def test_cheapest_queries_rederived_by_the_oracle(tmp_path):
    tool = load_tool()
    results = tool.derive(str(tmp_path), 1.0, 7, 4, CHEAPEST)
    assert [n for n in results] == CHEAPEST
    assert tool.check(str(PATH), results) == []
    with open(PATH) as f:
        have = json.load(f)["queries"]
    assert all(len(have[n]["rows"]) == len(results[n]["rows"]) > 0
               for n in CHEAPEST)


def test_cli_runs_two_queries_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "out.json"
    assert main(["--device", "cpu", "--queries", "q41d,q96", "--json",
                 str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [r["name"] for r in rows] == ["q41d", "q96"]
    assert all(r["ok"] and r["spmd"] for r in rows)
    assert "2/2 passed" in capsys.readouterr().out


def test_cli_refuses_what_the_file_lacks(capsys):
    assert main(["--sf", "0.5", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "sf=0.5 seed=7" in err and "tools/torch_expected.py" in err
    assert main(["--seed", "8", "--device", "cpu"]) == 2
    assert main(["--queries", "q41d,nope", "--device", "cpu"]) == 2
    assert "nope" in capsys.readouterr().err


def test_cli_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--queries", "q96"])

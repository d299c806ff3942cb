"""Write, or check, the expected results of the PyTorch port's TPC-DS
harness (`auron_tpu_torch/it/expected_sf1_seed7.json`).

The port has no oracle of its own: its runner compares each query with
a result that the JAX package's pyarrow oracle computed.  This tool
builds the JAX package's tables (`auron_tpu.it.datagen.generate`, the
parquet files in a temporary directory), runs every query of
`auron_tpu.it.queries` on the oracle as `auron_tpu/it/runner.py` does
(`auron.enable` off, `PyArrowEngine`) and writes one JSON file,
readable with `json` alone:

    {"sf": 1.0, "seed": 7, "fact_chunks": 4, "datagen_version": 2,
     "names": [...],
     "queries": {"q01": {"columns": [...], "rows": [[...], ...]}, ...}}

A float is written as Python's `repr` writes it (it reads back to the
same double; NaN and infinities as `NaN` and `Infinity`), a null as
`null`, a date as its int days since 1970-01-01.  The port's generator
makes the same tables bit for bit, and its query builders the same
plans, so the file holds for the port's runs at the same (sf, seed).

    python tools/torch_expected.py            # write the file
    python tools/torch_expected.py --check    # re-derive and compare
    python tools/torch_expected.py --check --queries q41d,q96

This tool imports the JAX package; the port never imports it.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "auron_tpu_torch", "it",
                           "expected_sf1_seed7.json")
_EPOCH = datetime.date(1970, 1, 1)


def _value(v):
    """A result value as the file holds it."""
    if isinstance(v, datetime.datetime):
        raise TypeError(f"timestamp result value {v!r}: no format for it")
    if isinstance(v, datetime.date):
        return (v - _EPOCH).days
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"result value {v!r} of type {type(v).__name__}")


def oracle_result(plan):
    """(column names, rows) of a foreign plan on the JAX package's
    oracle, as its IT runner computes the expected side."""
    from auron_tpu import config
    from auron_tpu.frontend.session import AuronSession
    from auron_tpu.it.oracle import PyArrowEngine
    with config.conf.scoped({"auron.enable": False}):
        table = AuronSession(foreign_engine=PyArrowEngine()).execute(
            plan).table
    names = list(table.schema.names)
    rows = [[_value(r[c]) for c in names] for r in table.to_pylist()]
    return names, rows


def derive(data_dir: str, sf: float, seed: int, fact_chunks: int,
           names=None, log=None) -> dict:
    """{query: {"columns", "rows"}} of `names` (default every query)."""
    from auron_tpu.it import datagen, queries
    cat = datagen.generate(data_dir, sf=sf, seed=seed,
                           fact_chunks=fact_chunks)
    out = {}
    for name in names or queries.names():
        t0 = time.perf_counter()
        cols, rows = oracle_result(queries.build(name, cat))
        out[name] = {"columns": cols, "rows": rows}
        if log is not None:
            log(f"{name}: {len(rows)} rows in "
                f"{time.perf_counter() - t0:.2f} s")
    return out


def _row_text(row) -> str:
    return json.dumps(row, allow_nan=True)


def render(sf: float, seed: int, fact_chunks: int, results: dict) -> str:
    """The file's text: the header, then each query's rows one a line."""
    from auron_tpu.it import datagen
    head = {"sf": sf, "seed": seed, "fact_chunks": fact_chunks,
            "datagen_version": datagen._DATAGEN_VERSION,
            "names": list(results)}
    lines = ["{" + json.dumps(head)[1:-1] + ', "queries": {']
    for i, (name, r) in enumerate(results.items()):
        body = ",\n".join("  " + _row_text(row) for row in r["rows"])
        lines.append(f'{json.dumps(name)}: {{"columns": '
                     f'{json.dumps(r["columns"])}, "rows": [\n{body}]}}'
                     + ("," if i + 1 < len(results) else ""))
    lines.append("}}")
    return "\n".join(lines) + "\n"


def check(path: str, results: dict) -> list:
    """The queries whose rows or columns differ from the file's, each
    with its first difference (row text compared exactly)."""
    with open(path) as f:
        have = json.load(f)["queries"]
    bad = []
    for name, r in results.items():
        h = have.get(name)
        if h is None:
            bad.append(f"{name}: not in the file")
            continue
        if h["columns"] != r["columns"]:
            bad.append(f"{name}: columns {h['columns']} vs {r['columns']}")
            continue
        if len(h["rows"]) != len(r["rows"]):
            bad.append(f"{name}: {len(h['rows'])} rows in the file, "
                       f"{len(r['rows'])} re-derived")
            continue
        for i, (a, b) in enumerate(zip(h["rows"], r["rows"])):
            if _row_text(a) != _row_text(b):
                bad.append(f"{name}: row {i}: file {a} re-derived {b}")
                break
    return bad


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--fact-chunks", type=int, default=4)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--check", action="store_true",
                    help="re-derive the results and compare them with the "
                         "file instead of writing it")
    ap.add_argument("--queries", default=None,
                    help="comma-separated subset (with --check)")
    args = ap.parse_args()
    if args.queries and not args.check:
        ap.error("--queries applies to --check: the file holds every "
                 "query")
    names = args.queries.split(",") if args.queries else None
    if args.check:      # the header first: deriving takes minutes
        from auron_tpu_torch.it.runner import load_expected
        try:
            load_expected(args.sf, args.seed, args.fact_chunks, args.out)
        except (FileNotFoundError, ValueError) as e:
            print(e)
            return 1
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tpcds_expected_") as d:
        results = derive(d, args.sf, args.seed, args.fact_chunks, names,
                         log=lambda s: print(s, flush=True))
    if args.check:
        bad = check(args.out, results)
        for line in bad:
            print(line)
        print(f"{len(results) - len(bad)}/{len(results)} queries equal "
              f"the file ({time.perf_counter() - t0:.1f} s)")
        return 1 if bad else 0
    with open(args.out, "w") as f:
        f.write(render(args.sf, args.seed, args.fact_chunks, results))
    rows = sum(len(r["rows"]) for r in results.values())
    print(f"wrote {len(results)} queries, {rows} rows to {args.out} in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

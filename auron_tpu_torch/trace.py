"""Trace CLI: record, validate and summarize query traces (counterpart of
auron_tpu/trace.py).

    python -m auron_tpu_torch.trace run q01 --serial --analyze -o q01.json
    python -m auron_tpu_torch.trace validate q01.json
    python -m auron_tpu_torch.trace summary q01.json --top 15

`run` generates the TPC-DS tables with the port's numpy generator
(`it.datagen.generate`, nothing written), runs one corpus query through
`AuronSession.execute` with `auron.trace.enable` on, the scans served by
`it.datagen.TableEngine`, on the card unless `--device cpu` is given,
and writes the Chrome-trace JSON (load in chrome://tracing or
ui.perfetto.dev).  `--serial` turns the stage executor off, so the
task, shuffle and operator events appear; `--budget` runs under a small
memory budget, so the spill spans and memory events appear; `--analyze`
prints EXPLAIN ANALYZE.  Spans read the host clock: on a GPU a span
is the host's dispatch of the work inside it, plus any synchronization
there, not device time.  `validate` checks the structure the Perfetto
importer relies on (exit 2 on any error); `summary` prints per-span
aggregates and the critical path.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from auron_tpu_torch.runtime.tracing import (
    summarize_chrome_trace, validate_chrome_trace,
)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _cmd_validate(args: argparse.Namespace) -> int:
    doc = _load(args.file)
    errors = validate_chrome_trace(doc)
    if errors:
        for e in errors:
            print(f"trace: {e}", file=sys.stderr)
        return 2
    n = len(doc.get("traceEvents", []))
    print(f"{args.file}: valid Chrome trace ({n} events)")
    return 0


def _cmd_summary(args: argparse.Namespace) -> int:
    doc = _load(args.file)
    print(summarize_chrome_trace(doc, top=args.top))
    return 0


def _cmd_run(args: argparse.Namespace) -> int:
    from auron_tpu_torch import resolve_device
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.frontend import converters
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.it import queries
    from auron_tpu_torch.it.datagen import TableEngine, generate
    from auron_tpu_torch.memmgr.manager import reset_manager

    query = args.query
    dev = resolve_device(args.device)
    catalog, tables = generate("trace-data", sf=args.sf, seed=args.seed,
                               fact_chunks=args.fact_chunks)
    plan = queries.build(query, catalog)
    scope = {"auron.trace.enable": True}
    if args.serial:
        scope["auron.spmd.singleDevice.enable"] = False
    if args.budget:
        scope["auron.memory.spill.min.trigger.bytes"] = args.spill_trigger
    provider = converters.ScanSourceProvider()
    converters.register_provider(provider)
    stats = {}
    try:
        with conf.scoped(scope):
            mgr = reset_manager(args.budget or None)
            session = AuronSession(foreign_engine=TableEngine(catalog,
                                                              tables))
            res = session.execute(plan, dev)
            stats = mgr.stats()
    finally:
        converters.unregister_provider(provider)
        reset_manager()
    if args.budget:
        print(f"mem: budget={args.budget} "
              f"peak={stats.get('peak_used', 0)} "
              f"spills={stats.get('num_spills', 0)} "
              f"freed={stats.get('spill_bytes_freed', 0)} "
              f"watermarks="
              f"{[c['fraction'] for c in stats.get('watermarks_crossed', [])]}")
    if res.trace is None:
        print("no trace was recorded (auron.trace.enable did not take?)",
              file=sys.stderr)
        return 2
    doc = res.trace.to_chrome_trace()
    errors = validate_chrome_trace(doc)
    if errors:
        for e in errors:
            print(f"trace: {e}", file=sys.stderr)
        return 2
    with open(args.out, "w") as f:
        json.dump(doc, f)
    path = "stage" if res.spmd else "serial"
    print(f"{query}: {res.num_rows} rows on the {path} path ({dev}), "
          f"{len(doc['traceEvents'])} trace events -> {args.out}")
    if args.analyze:
        print(res.explain_analyze())
    print(summarize_chrome_trace(doc, top=args.top))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="auron_tpu_torch.trace")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="trace one TPC-DS corpus query")
    run.add_argument("query", nargs="?", default="q01")
    run.add_argument("--sf", type=float, default=0.002)
    run.add_argument("--seed", type=int, default=7)
    run.add_argument("--fact-chunks", type=int, default=4)
    run.add_argument("-o", "--out", default="trace.json")
    run.add_argument("--device", default=None,
                     help="cuda (default) or cpu")
    run.add_argument("--serial", action="store_true",
                     help="turn the stage executor off, so the task, "
                          "shuffle and operator events appear")
    run.add_argument("--analyze", action="store_true",
                     help="also print EXPLAIN ANALYZE for the run")
    run.add_argument("--budget", type=int, default=0,
                     help="run under this memory budget (bytes) so spill "
                          "spans and mem.* events appear")
    run.add_argument("--spill-trigger", type=int, default=1024,
                     help="auron.memory.spill.min.trigger.bytes to use "
                          "with --budget")
    run.add_argument("--top", type=int, default=10)
    run.set_defaults(fn=_cmd_run)

    val = sub.add_parser("validate", help="schema-check a trace file")
    val.add_argument("file")
    val.set_defaults(fn=_cmd_validate)

    summ = sub.add_parser("summary", help="summarize a trace file")
    summ.add_argument("file")
    summ.add_argument("--top", type=int, default=10)
    summ.set_defaults(fn=_cmd_summary)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

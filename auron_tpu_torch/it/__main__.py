"""CLI: python -m auron_tpu_torch.it --sf 1 --seed 7 [--queries q01,q96]
[--json out.json] [--device cuda]

Generates the TPC-DS tables in memory, runs the corpus through the
port's session, cold and warm, on the card unless `--device cpu` is
given, and compares each query with the committed expected results of
(sf, seed) (`expected_sf<sf>_seed<seed>.json` beside this file, which
`tools/torch_expected.py` writes).  Prints one JSON line per query and
the report; exits 1 when any query fails, 2 when (sf, seed) has no
expected results (`runner.load_expected`) or a query is not in the
corpus."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="auron_tpu_torch.it")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--queries", default=None,
                    help="comma-separated subset (default: all)")
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from auron_tpu_torch import resolve_device
    from auron_tpu_torch.it import queries
    from auron_tpu_torch.it.datagen import generate
    from auron_tpu_torch.it.runner import QueryRunner, load_expected

    try:
        head, expected = load_expected(args.sf, args.seed)
    except (FileNotFoundError, ValueError) as e:
        print(e, file=sys.stderr)
        return 2
    names = args.queries.split(",") if args.queries else queries.names()
    unknown = [n for n in names if n not in expected]
    if unknown:
        print(f"no query {','.join(unknown)}: the corpus is "
              f"{','.join(queries.names())}", file=sys.stderr)
        return 2

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    cat, tables = generate(f"tpcds-sf{args.sf:g}-seed{args.seed}",
                           sf=args.sf, seed=args.seed,
                           fact_chunks=head["fact_chunks"])
    print(f"generated sf={args.sf:g} seed={args.seed}: "
          f"{sum(len(a[0]) for a, _ in tables.values())} rows in "
          f"{len(tables)} tables in {time.perf_counter() - t0:.2f} s",
          flush=True)
    runner = QueryRunner(cat, tables, expected, device=device)

    def flush(r):
        line = {k: v for k, v in r.to_dict().items() if v is not None}
        print(json.dumps(line), flush=True)
        if args.json:
            tmp = args.json + ".tmp"
            with open(tmp, "w") as f:
                f.write(runner.to_json())
            os.replace(tmp, args.json)

    runner.run_all(names, on_result=flush)
    print(runner.report())
    return 0 if all(r.ok for r in runner.results) else 1


if __name__ == "__main__":
    sys.exit(main())

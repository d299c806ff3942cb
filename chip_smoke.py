#!/usr/bin/env python3
"""On-card smoke run of auron_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--rows N] [--seed S]

Needs one CUDA card and the CUDA toolkit; builds the port's kernels from
the sources in this checkout.  Every task runs as the port runs by
default (`PhysicalPlanner.create_verified_plan`): its row-local chains
fused (`auron.fuse.enable`; of phases 3-24 only q39v's exchanges, over
filter <- projection with their partition ids fused, and q27r's partial
aggregations, over expand <- projection, hold such a chain), the
verifier off unless a phase turns it on.  Phases, each fatal on failure:

1. print the card (`nvidia-smi` name and power limit) and CUDA version,
   build both kernels (hash-pid and radix histogram, one nvcc each,
   started together) under a trace scope and print the build time: the
   trace validates and holds one `kernel.build` event for each source
   that was not already built (both in a fresh checkout), none where
   `build/` held both libraries;
2. hold the hash-pid kernel bit-exact against its plain PyTorch version
   on the card, on full-range int64 keys with 10% nulls (n in 1, 3, 127,
   1025, 2^24+3: its vector path and its tail; n_parts in 1, 2, 4, 7,
   200), on views that start off a 16-byte boundary (its scalar path) and
   on all-null keys (the shapes the paths give it are phase 15's);
3. run the TPC-DS shuffled group-by stage pair at SF 10 size through the
   task entry point `execute_task_bytes` on the card: 8 map tasks
   (FFIReader -> Projection -> partial Agg -> RssShuffleWriter, hash on
   ss_customer_sk into 200 partitions) and 200 reduce tasks (IpcReader ->
   final Agg), check the result against a numpy group-by and check that
   every map-side batch went through the hash-pid kernel once and the
   radix-histogram kernel (the writer's partition sizes) once;
4. time the kernel and its plain version (CUDA events and the
   profiler's kernel durations) beside the launch floor (the profiler's
   duration of a one-element `add_`);
5. profile the first quarter of one map task: wall time, device busy
   time and idle share, the top kernels and host ops;
6. hold the radix-histogram kernel bit-exact against its plain version
   on the card: n in {128, 256, 512, 1024, 128 x 131, 8192, 144000,
   2^24} x b_bits in {0, 1, 2, 6, 8} (clusters of 1, 2, 4 and 8 blocks),
   all-zero and all-same-digit words, a view off a 16-byte boundary (must
   raise ValueError), and the writer's partition sizes at n_parts 1, 2,
   4, 7 and 200 on row counts that are not multiples of 128 (the shapes
   the paths give it are phase 15's);
7. run the global-sort stage pair on the same rows through
   `execute_task_bytes`: 8 map tasks (FFIReader -> Projection ->
   RssShuffleWriter, range partitioning into 200 partitions by bounds
   sampled as Spark's RangePartitioner samples) and 200 reduce tasks
   (IpcReader -> Sort, ORDER BY ss_sales_price DESC NULLS LAST,
   ss_customer_sk ASC NULLS FIRST); check that the partitions in id order
   equal numpy's stable lexsort under Spark's ordering, that every row
   lies inside its partition's bounds, that every map-side batch went
   through the radix-histogram kernel once, and that every reduce sort
   ran in the form `sort_strategy` resolves for the card;
8. time the radix-histogram kernel at the writer's shapes (and on
   all-zero words at 524288) against its plain version, its memory
   bound, `torch.bincount` and the launch floor, and a reduce task's
   sort under both strategies (pack-sort and multipass);
9. profile the first 64th of one sort map task and one sort reduce
   task;
10. run TPC-DS q96 whole through `execute_task_bytes` as the JAX
    package's converter lowers it: 8 map tasks (FFIReader -> Filter
    ss_quantity >= 20 AND ss_sales_price < 120.0 -> partial count ->
    RssShuffleWriter, single partition) over the store_sales rows with
    ss_sold_date_sk beside them, and 1 reduce task (IpcReader -> final
    count -> Limit 100); check the count against numpy exactly and that
    every map-side batch went through the radix-histogram kernel (b = 1,
    the single writer's ceil_log2(1)) and none through hash-pid; profile
    the first quarter of one map task;
11. run q88c whole the same way: 8 map tasks (FFIReader -> Projection of
    three CASE band flags -> partial sums -> single-partition writer) and
    1 reduce task (final sums); check the three band counts exactly;
    profile the first eighth of one map task;
12. run the three aggregate stages of q01's threshold subtree over the
    SF-10 store_returns rows (sampled from the store_sales rows as
    `it/datagen.py` samples them): 4 map tasks (scan -> partial Sum by
    (customer, store) -> hash(4) on both keys), 4 tasks (final Sum ->
    partial Average by store -> hash(2) on the store), 2 tasks (final
    Average -> threshold = avg * 1.2); check one row per store, the null
    store included, against numpy to relative 1e-9, the histogram kernel
    on every writer's batch (b = 2, then b = 1) and hash-pid on every
    batch of the single-key hash(2) writer; profile one stage-1 map task;
    print the seconds phases 10-12 took;
13. run TPC-DS q17m whole as the converter lowers it, each stage through
    `execute_task_bytes` (`JoinQuery`): store_sales with ticket (the row
    number), item, store and quantity for all rows (8 tasks -> hash(4)
    on (ticket, item)), store_returns (4 tasks -> hash(4)), 4 sort-merge
    join tasks (Sort, Sort -> SortMergeJoin on two keys -> partial Min,
    Max, Average, Count by ss_store_sk -> hash(4)), 4 tasks (final ->
    Sort fetch 100 -> single), 1 task (Sort fetch 100 -> Projection);
    check that the join's rows number one per store_returns row, the 100
    rows against numpy, the histogram on every writer batch and hash-pid
    on every batch of the one-key exchange (no task is profiled: a
    sort-merge join task's trace took 37-57 s to read); then a group-by
    of 2^20 rows by a float64 key holding -0.0,
    0.0, +-inf and NaNs of both signs and several payloads (Count, Min,
    Max, first_ignores_null of a float64 value) through hash(4),
    checked against numpy under Spark's normalization; First and
    first_ignores_null under both sort forms; sorted_segment_min / max
    on the card against the CPU for every type;
14. run q39v whole: for January and February 2000 a broadcast of the
    month's rows of date_dim (73,049 rows, Filter d_moy, d_year), a
    broadcast join of the inventory snapshots of January to March 2000
    (13 weekly snapshots of 510,000 (item, warehouse) pairs, 4 tasks)
    against it -> partial Average and StddevSamp -> hash(4) on two keys,
    4 tasks (final -> rename -> Filter sdev / mean > 0.4 -> hash(4));
    then 4 sort-merge join tasks of the two months' kept groups -> Sort
    fetch 100 -> single, and the root; check each month's kept groups,
    means and sdevs against numpy, the root's 100 rows against the kept
    groups joined in Python, the histogram on every writer batch and no
    hash-pid (two keys); print the seconds phases 13-14 took;
15. (run last) hold each kernel bit-exact against its plain version at
    every (rows, n_parts) the writers of phases 3-14, 16-18, 21-24, 28
    and 29 gave it, as their metrics report them;
16. run TPC-DS q09c and q41d whole as the converter lowers them, with
    string columns on the card: q09c over the store_sales rows (8 map
    tasks: Projection of a nested CASE into the string band "1-20",
    "21-60", "61-100" -> partial Count, Average by the band -> hash(4)
    on the string; 4 tasks: final -> Sort fetch 10 -> single; 1 task:
    Sort fetch 10 -> Projection), checked against numpy; q41d over SF-10
    item (102,000 rows, i_brand and i_class strings; 1 map task: Filter
    30 <= price <= 70 -> partial Count by (i_brand, i_class) -> hash(4)
    on both strings; 4 tasks: final -> Sort fetch 100 -> single; 1
    task), its 100 rows (of 171 groups, the null ones first) against
    Python's sort; profile the first eighth of one q09c map task;
17. run TPC-DS q01 whole over phase 12's store_returns and SF-10
    customer (500,000 rows, c_customer_id strings): two scans -> partial
    Sum -> hash(4); final Sum -> partial Average -> hash(2); the
    broadcast of the thresholds; final Sum -> BroadcastJoin (a build-map
    stage over the broadcast, built once for the stage's 4 tasks) ->
    Filter -> hash(4) by sr_customer_sk; the customer scan -> hash(4);
    4 sort-merge join tasks -> Sort fetch 100 by (c_customer_id,
    sr_store_sk, ctr_total_return DESC) -> single; Sort fetch 100 ->
    Projection; check the thresholds, the broadcast join's rows, every
    customer in its Spark partition with its id intact, each task's top
    100 and the top 100 c_customer_id against numpy and Python's sort;
18. run a group-by of 2^20 rows by 1,000 string keys of 0-40 UTF-8 bytes
    (the empty string, keys apart only by a trailing NUL, non-ASCII
    first bytes), batches of width 8 alternating with wider ones: Count
    and Sum through hash(4), checked against Python, each group in
    pmod(Spark's hashUnsafeBytes, 4) computed in plain Python;
19. run every join type (inner, left, right, full, left and right semi
    and anti, existence) through BroadcastJoin (on the sides the JAX
    package's plan verifier lets it build), HashJoin built on each side
    and SortMergeJoin streaming and whole-side, over two sides of 2^15
    rows (~16 rows a key, an eighth of the keys unmatched, nulls, a
    string payload), probe batches spanning many pair chunks, and with
    an empty build side; check each against the port's own run on the
    CPU row for row and numpy's row count; then the same on string keys
    of 0-40 bytes (2^14 rows a side), the left side's at most 8 bytes
    and the right side's up to 40, so the build and the probe side lie
    in different width buckets;
20. over phase 18's string keys (k, and t the keys a row later) with
    phase 3's price and quantity: every comparison (== != <=> < <= > >=)
    of k with t and with a literal, IN with and without a null, NOT IN,
    round at scales -2, 0, 2 (and 6 of x / q) over float64, int32 and
    int64, coalesce and nvl over floats, ints and strings, and a Filter
    by a string order and a NOT IN, on the card and on the CPU: bools,
    ints and strings exact, round's float64 bits exact or within the
    ulps it prints;
21. run TPC-DS q13a whole (`JoinQuery`): date_dim's rows of 2001 and
    store's rows of TN, CA, TX and OH (SF-10 store, 102 rows, s_state
    STATES[sk % 10]) broadcast; 8 tasks over the store_sales rows (sold
    date, store, quantity, price, net profit) -> two broadcast joins ->
    partial Average, Average, Sum by s_state -> hash(4) on the string;
    final -> Sort fetch 100 -> single; check the 4 groups against numpy;
22. run q65w whole: 8 tasks of partial Sum of price by (store, item)
    (item uniform over the 102,000 SF-10 items) -> hash(4) on both; 4
    tasks of final Sum -> hash(4) by ss_store_sk (hash-pid); 4 window
    tasks, rank() over (store, ordered by revenue desc, item) -> Filter
    rk <= 5 -> Sort fetch 200 -> single; check the top 5 of each store
    and their ranks against numpy; profile window task 0;
23. run q27r whole: item (i_category CATEGORIES[sk % 10]) and store
    broadcast; 8 tasks -> two broadcast joins with string payloads ->
    Expand into 3 grouping sets (null string literals) -> partial
    Average and Count by (category, state, grouping id) -> hash(4) on
    two strings and an int; check the 111 groups against numpy;
24. run q33b whole: per channel (store_sales 28,800,991 rows, 8
    partitions; catalog_sales 14,401,261, 4; web_sales 7,197,566, 2)
    broadcast joins with date_dim's rows of March 1999 and item's
    i_manufact_id -> Projection, under one Union of 14 partitions whose
    tasks stream their assignments -> partial Sum by i_manufact_id ->
    hash(4); final -> Sort fetch 100; check the sums against numpy;
25-26. (folded into 27);
27. run q01, q13a and q65w at SF 10 from their foreign plans, built by
    the port's `it/queries.py` over a catalog of phases 17, 21 and 22's
    tables (the IT schema's names and types, one chunk a split): the
    port's convert provider `ScanSourceProvider` claims every scan, the
    port's foreign engine over host tables (`it/datagen.py::TableEngine`)
    serves each as a SourceTable, and `AuronSession.execute` tags,
    converts and runs each once on the stage path: equal to its phase's
    serial result and to numpy, neither kernel launched; then q01 with
    `auron.spmd.singleDevice.enable` off, on the session's serial path,
    traced (`auron.trace.enable`): equal to phase 17, both kernels
    launched, phase 17's launches where the task counts are equal, its
    trace valid and holding the `query`, `plan.convert`, `task.execute`,
    `shuffle.push`, `shuffle.fetch.part` and `op.complete` families, its
    EXPLAIN ANALYZE root's output rows its result's rows; print the
    trace's summary (the top 10 spans by host time) and the EXPLAIN
    ANALYZE text.  Then generate TPC-DS at SF 1, seed 7
    with the port's numpy generator (`it/datagen.py::generate`, the JAX
    package's tables bit for bit) and print the time it took; run all
    103 IT queries from their foreign plans through the port's
    `it/runner.py::QueryRunner` on the card (`AuronSession.execute`,
    `TableEngine` serving the scans), cold (the source cache emptied)
    and warm, each against the committed expected results of the JAX
    package's oracle (`auron_tpu_torch/it/expected_sf1_seed7.json`);
    print a line a query (the path, or the stage executor's reason for
    the serial path; tag and convert ms; cold and warm seconds; host
    syncs and bytes uploaded, cold/warm; peak device memory, reset a
    query; rows; the hash-pid/radix-hist launches), fail after the sweep
    if any query raised or differed, print the least, median and most of
    each of those readings, and profile the warm execute of the query
    with the largest warm time;
28. run five serial SF-10 tasks through `execute_task_bytes`, each once
    under a 32 MiB memory budget (`auron.memory.budget.bytes`, spill
    trigger 4 MiB) and once under the default budget: (a) phase 3's
    first map split sorted by phase 7's keys, equal row for row; (b) the
    same rows grouped by phases 21-24's (ss_store_sk, ss_item_sk), Sum
    and Count of the price, keys and counts exact, sums to relative
    1e-9; (c) q65w's window task 0 (2,655,622 rows at full size), equal;
    (d) a sort-merge inner join whose build side has 2^20 rows, 2^19 of
    them under one key, and whose probe side has 2^15 rows, 8 of them on
    that key, under `auron.smj.window.max.rows` 2^16, equal as a row
    multiset to the same join uncapped and unbudgeted; (e) (b)'s
    aggregation over the rows with a price of at least 20 and the price
    less 20 (Filter -> Projection), under the budget fused (the
    aggregation's prologue) and unfused, and unbudgeted, equal as (b).
    Each budgeted run must spill from its operator and (d) take the
    giant-group escape;
    print each run's wall time, spills, spilled bytes and tier, the
    memory manager's pool peak and `torch.cuda.max_memory_allocated`.
    (c)'s budgeted run is traced: one `mem.spill` event for each spill
    the memory manager arbitrated, one `spill.write` span for each spill
    the window wrote (its `mem_spill_count`; the run's last spill, of
    the staged tail, the operator writes without the manager, as in the
    JAX package), each naming the tier it spilled to;
29. float32 and decimal(p <= 18) columns: (a) phase 3's first map split
    (3,600,123 rows) with ss_sales_price as decimal(7,2) (its cents, the
    int64 unscaled value), three stage pairs through `execute_task_bytes`
    into 16 partitions: group by ss_customer_sk with Sum (decimal(17,2))
    and Average (decimal(11,6)) of the price and Min and Max of
    CheckOverflow(Cast(qty as decimal(10,0)) * price, decimal(18,2));
    group by the price itself, Count and Sum of the quantity, the hash
    exchange on the single decimal key through the hash-pid kernel; a
    global sort by the price DESC NULLS LAST, a range exchange by
    Spark-sampled `Decimal` bounds; each exact against numpy's integers,
    the histogram on every writer batch and hash-pid on every batch of
    the two one-key hash exchanges; (b) 2^20 rows of a float32 key and
    value (+-0.0, NaNs of four patterns, +-inf, subnormals): a two-phase
    group-by (Min, Max, Sum, Average, Count) through hash(4) and a global
    sort by the key, checked against numpy under Spark's rules; (c) (a)'s
    group by customer from its foreign plan through
    `AuronSession.execute` (`TableEngine` serving the scan): the stage
    path, no launch, equal to (a);
30. (run after phase 27's sweep, over its SF-1 catalog) tracing's cost
    on the card: q01, q03, q65w, q75y and q23m through
    `AuronSession.execute` on the stage path, each once to warm, then
    three executes untraced and three traced: equal results, host syncs,
    bytes uploaded and kernel launches, and an equal normalized EXPLAIN
    ANALYZE, between the two; print both warm medians and their ratio.
    Then q01, q03 and q65w with the stage executor off, traced, once
    each: equal to the oracle's expected results, the trace valid; print
    each serial wall time.
31. (after phase 30, over phase 27's SF-1 catalog) the task pipeline:
    q01, q03, q65w, q96, q27r and q74y from their foreign plans through
    `AuronSession.execute` on the serial path with the plan verifier on
    (`auron.plan.verify`), fusion off and then on, each once traced
    with its host syncs counted (`torch.cuda.set_sync_debug_mode`'s
    warning on every synchronizing call) and then timed untraced in
    turns (off, on, on, off): equal fused and unfused and to the
    expected results, hash-pid launched as often fused as unfused; print
    for each the fragment operators, the operators fused, the pid-fused
    batches, the prologue-fused aggregations, each kernel's launches,
    the host syncs, the walls, and the verifier's and the fusion pass's
    host time (their `plan.verify` and `plan.fuse` spans).  Then the
    partial-aggregation prologue at SF 10: phase 3's first map split
    through Filter -> Projection -> partial Agg -> hash(200) by
    customer, fused (the aggregation takes the fragment's stages in, no
    compaction) and unfused, in turns: equal blocks, the same launches,
    one of each kernel a writer batch;
Every phase from 3 to 27, 29, 30 and 31 runs under the default memory budget:
after each the memory manager's spill count is printed, and a spill
fails the script.
It prints the card's line and one JSON line describing each kernel, then,
as the last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

SF10_STORE_SALES_ROWS = 28_800_991   # TPC-DS store_sales at scale factor 10
SF10_STORE_RETURNS_ROWS = 2_875_432  # TPC-DS store_returns at scale factor 10
SF10_CUSTOMERS = 500_000             # TPC-DS customer at scale factor 10
SF10_STORES = 102                    # TPC-DS store at scale factor 10
SOLD_DATE_SK = (2_450_816, 2_452_642)  # TPC-DS sold-date keys (inclusive)
N_RETURN_MAPS = 4                    # half the store_sales splits
NULL_FRACTION = 0.04                 # per column, a few percent as in dsdgen
N_MAPS = 8
N_REDUCE = 200                       # spark.sql.shuffle.partitions default
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
NONTENSOR_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores
PID_BYTES_PER_ROW = 13               # 8 key + 1 validity + 4 pid
PID_OPS_PER_ROW = 36                 # murmur3 mixes, fmix, null select, pmod
HIST_B_BITS = 8                      # ceil_log2(200 partitions)
HIST_OPS_PER_WORD = 3                # shift, bucket address, shared add
SAMPLE_POINTS_PER_PARTITION = 20     # Spark RangePartitioner's sample hint
SCAN_BATCH = 8192                    # auron.batch.size: a range map batch
PROFILE_ATTEMPTS = 3                 # profiler sessions tried for one time


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def build_phase(K) -> None:
    """Phase 1: build both kernels under a trace scope; the trace
    validates and holds one `kernel.build` event for each source whose
    library was not already built."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.runtime import tracing
    todo = sorted(n for n, src in K.SOURCES.items()
                  if not (K.BUILD_DIR / f"lib{n}.so").exists() or
                  (K.BUILD_DIR / f"lib{n}.so").stat().st_mtime <
                  src.stat().st_mtime)
    t = time.perf_counter()
    with conf.scoped({"auron.trace.enable": True}), \
            tracing.trace_scope() as scope:
        K.build()
    secs = time.perf_counter() - t
    doc = scope.recorder.to_chrome_trace()
    errors = tracing.validate_chrome_trace(doc)
    built = sorted(e["args"]["kernel"] for e in doc["traceEvents"]
                   if e["name"] == "kernel.build")
    if errors or built != todo:
        raise AssertionError(f"phase 1: kernel.build events {built}, "
                             f"want {todo}; trace errors {errors[:3]}")
    print(f"phase 1: built {sorted(K.SOURCES)} in {secs:.2f} s; "
          + (f"{len(built)} kernel.build events ({', '.join(built)}) in a "
             f"valid trace" if built else "no kernel.build event: build/ "
             "held both libraries"))


def median_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def pid_bound(n: int):
    """(least time in ms, "bytes" or "operations") for n rows."""
    by_bytes = n * PID_BYTES_PER_ROW / HBM_BYTES_PER_S * 1e3
    by_ops = n * PID_OPS_PER_ROW / NONTENSOR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def random_keys(rng, n: int, dev, null_fraction: float = 0.1):
    keys = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                        dtype=np.int64, endpoint=True)
    valid = rng.random(n) >= null_fraction
    return torch.from_numpy(keys).to(dev), torch.from_numpy(valid).to(dev)


def check_kernel(K, dev, rng) -> int:
    """Phase 2: kernel == plain version, bit for bit; returns the largest
    absolute pid difference seen (0)."""
    worst = 0

    def check(keys, valid, n_parts, what):
        nonlocal worst
        got = K.hash_partition_ids_i64(keys, valid, n_parts)
        exp = K.hash_partition_ids_i64_plain(keys, valid, n_parts)
        torch.cuda.synchronize()
        err = int((got.long() - exp.long()).abs().max())
        worst = max(worst, err)
        if err:
            raise AssertionError(f"hash-pid kernel != plain at {what} "
                                 f"n_parts={n_parts}: max err {err}")
    for n in (1, 3, 127, 1025, 2**24 + 3):
        keys, valid = random_keys(rng, n, dev)
        for n_parts in (1, 2, 4, 7, 200):
            check(keys, valid, n_parts, f"n={n}")
    # views off a 16-byte boundary take the kernel's scalar path
    keys, valid = random_keys(rng, 499_500, dev)
    for k, v, what in ((keys[1:], valid[1:], "keys[1:], valid[1:]"),
                       (keys[1:], valid[:-1], "keys[1:]"),
                       (keys[:-1], valid[1:], "valid[1:]")):
        check(k, v, N_REDUCE, what)
    keys, _ = random_keys(rng, 8192, dev)
    none = torch.zeros(8192, dtype=torch.bool, device=dev)
    for n_parts in (1, 7, 200):
        got = K.hash_partition_ids_i64(keys, none, n_parts)
        if not bool((got == 42 % n_parts).all()):
            raise AssertionError(f"all-null batch: pids != 42 % {n_parts}")
    print(f"phase 2: hash-pid kernel bit-exact with its plain version "
          f"(n in 1, 3, 127, 1025, 2^24+3 x n_parts 1, 2, 4, 7, 200; "
          f"keys[1:] and valid[1:] views; all-null)")
    return worst


def make_store_sales(rows: int, seed: int):
    """store_sales columns of the slice: ss_customer_sk uniform over the
    SF-10 customers, ss_quantity in 1..100, ss_sales_price in 0..200 in
    cents, each with NULL_FRACTION nulls."""
    rng = np.random.default_rng(seed)
    sk = rng.integers(1, SF10_CUSTOMERS + 1, rows, dtype=np.int64)
    qty = rng.integers(1, 101, rows, dtype=np.int32)
    price = np.round(rng.random(rows) * 200.0, 2)
    valid = [rng.random(rows) >= NULL_FRACTION for _ in range(3)]
    return [sk, qty, price], valid


# ---------------------------------------------------------------------------
# plans, exchanges and launch checks shared by every path
# ---------------------------------------------------------------------------

def _writer(child, mode: str, n_parts: int, exprs=(), **partitioning):
    from auron_tpu_torch.ir import plan as P
    return P.RssShuffleWriter(
        child=child, partitioning=P.Partitioning(
            mode=mode, num_partitions=n_parts, expressions=tuple(exprs),
            **partitioning),
        rss_resource_id="shuffle_writer")


def _dtype(t: str):
    """The DataType of "i32" | "i64" | "f32" | "f64" | "str" | "dec(p,s)"."""
    from auron_tpu_torch.ir.schema import DataType
    if t.startswith("dec("):
        p, s = t[4:-1].split(",")
        return DataType.decimal(int(p), int(s))
    return {"i32": DataType.int32(), "i64": DataType.int64(),
            "f32": DataType.float32(), "f64": DataType.float64(),
            "str": DataType.string()}[t]


def _schema(*fields):
    """A Schema of (name, type as `_dtype` names it[, nullable]) fields."""
    from auron_tpu_torch.ir.schema import Field, Schema
    return Schema.of(*(Field(n, _dtype(t), nullable=nullable)
                       for n, t, nullable in
                       ((f + (True,))[:3] for f in fields)))


def _stage_launches(before, after):
    return {k: after[k] - before[k] for k in after}


def check_stage(what, launches, results, n_parts: int, hash_pid: bool,
                scan_batch: int = 0):
    """The histogram on every writer batch of a stage, hash-pid on each
    too when the exchange hashes one int64 key, and on none otherwise.
    Returns the batches and the (kernel, rows, n_parts) of each launch,
    from the writers' metrics: a task that wrote one batch gives its
    rows; several batches are taken only from a writer fed straight by
    the scan (`scan_batch`, the scan's batch rows): whole scan batches
    and one remainder."""
    pushed = sum(r.metrics.get("shuffle_write_batches", 0) for r in results)
    by_hist = sum(r.metrics.get("sizes_by_hist", 0) for r in results)
    want_pid = pushed if hash_pid else 0
    if not pushed or launches["radix_bucket_hist"] != pushed or \
            by_hist != pushed or \
            launches["hash_partition_ids_i64"] != want_pid:
        raise AssertionError(f"{what}: {launches} for {pushed} map-side "
                             f"batches (want the histogram on each, "
                             f"hash-pid on {want_pid})")
    rows = []
    for r in results:
        k = r.metrics.get("shuffle_write_batches", 0)
        n = r.metrics.get("shuffle_write_rows", 0)
        tail = n - (k - 1) * scan_batch
        if k > 1 and not 0 < tail <= scan_batch:
            raise AssertionError(f"{what}: a task wrote {k} batches of {n} "
                                 f"rows in all, not scan batches of "
                                 f"{scan_batch}")
        rows += [scan_batch] * (k - 1) + [tail] if k else []
    kernels = ("hash_pid", "hist") if hash_pid else ("hist",)
    return pushed, [(kern, n, n_parts) for n in rows for kern in kernels]


STORE_SALES = (("ss_customer_sk", "i64"), ("ss_quantity", "i32"),
               ("ss_sales_price", "f64"))


def stage_plans():
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    f64, i64 = DataType.float64(), DataType.int64()
    src_schema = _schema(*STORE_SALES)
    aggs = (E.AggExpr(fn="sum", children=(E.col("sales"),), return_type=f64),
            E.AggExpr(fn="count", children=(E.col("sales"),),
                      return_type=i64))
    names = ("sum_sales", "cnt_sales")
    key = (E.col("ss_customer_sk"),)
    proj = P.Projection(
        child=P.FFIReader(schema=src_schema, resource_id="store_sales"),
        exprs=(E.col("ss_customer_sk"),
               E.BinaryExpr(left=E.Cast(child=E.col("ss_quantity"),
                                        dtype=f64),
                            op="*", right=E.col("ss_sales_price"))),
        names=("ss_customer_sk", "sales"))
    map_plan = _writer(P.Agg(child=proj, exec_mode="partial", grouping=key,
                             grouping_names=("ss_customer_sk",), aggs=aggs,
                             agg_names=names), "hash", N_REDUCE, key)
    state_schema = _schema(("ss_customer_sk", "i64"), ("sum_sales#sum", "f64"),
                           ("cnt_sales#count", "i64", False))
    reduce_plan = P.Agg(
        child=P.IpcReader(schema=state_schema, resource_id="shuffle_read"),
        exec_mode="final", grouping=key, grouping_names=("ss_customer_sk",),
        aggs=aggs, agg_names=names)
    return map_plan, reduce_plan


def map_task(m: int, cols, valid, svc, dev, plan=None, shuffle_id="ss",
             source="store_sales", n_maps=N_MAPS, split=None):
    """Map task m of n_maps of `plan` (default: the group-by map plan)
    through execute_task_bytes, its scan leaf `source` fed split m of the
    rows (or the rows [lo, hi) of `split`), writing into `svc` under
    `shuffle_id`."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    rows = len(cols[0])
    bs = int(conf.get("auron.batch.size"))
    lo, hi = split or (m * rows // n_maps, (m + 1) * rows // n_maps)
    res = ResourceRegistry()
    # the front end's scan batches: batch-size slices of the split
    res.put(source, [
        ([c[s:min(s + bs, hi)] for c in cols],
         [v[s:min(s + bs, hi)] for v in valid])
        for s in range(lo, hi, bs)])
    res.put("shuffle_writer", svc.rss_writer(shuffle_id, m))
    task = P.TaskDefinition(plan=plan or stage_plans()[0], stage_id=1,
                            partition_id=m, num_partitions=n_maps)
    return execute_task_bytes(serde.serialize(task), res, device=dev)


def run_stage_pair(cols, valid, dev):
    """Phase 3: the stage pair through execute_task_bytes.  Returns the
    reduce outputs, the map results and the two stages' seconds."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    svc = InProcessShuffleService()
    t0 = time.perf_counter()
    map_results = [map_task(m, cols, valid, svc, dev) for m in range(N_MAPS)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    blocks = [svc.reduce_blocks("ss", p) for p in range(N_REDUCE)]
    reduce_plan = stage_plans()[1]
    outs = [reduce_task(reduce_plan, blocks, 2, p, dev).to_numpy()
            for p in range(N_REDUCE)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return outs, map_results, t1 - t0, t2 - t1


def _device_us(avgs) -> float:
    """Summed device time of the kernels and copies in a profile's
    key_averages()."""
    from torch.autograd import DeviceType
    total = 0.0
    for e in avgs:
        if e.device_type == DeviceType.CUDA:
            total += getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)
    return total


def profiled_ms(fn, iters: int = 25, kernel: str = ""):
    """Device time of one call from torch.profiler's CUDA trace (kernel
    durations summed, gaps excluded), or None when no attempt's trace
    has any.

    The calls run twice inside the profiler, a warm-up step whose events
    are discarded and the measured step: late in a long process the
    trace misses the first launches of a session otherwise (up to half
    of 25 on an H100), and now and then a whole session.  With `kernel`,
    a substring of the name of the one kernel a call launches, the
    result is that kernel's mean duration over the launches the trace
    holds, which a lost launch cannot bias."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        ms = _profiled_once(fn, iters, kernel)
        if ms is not None:
            return ms
    return None


def _profiled_once(fn, iters: int, kernel: str):
    from torch.autograd import DeviceType
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA],
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                         repeat=1))
    with prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    if kernel:
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        n = sum(e.count for e in hits)
        us = sum(e.self_device_time_total for e in hits)
        return us / n / 1e3 if n and us > 0 else None
    us = _device_us(prof.key_averages())
    return us / iters / 1e3 if us > 0 else None


def launch_floor_ms(dev) -> float:
    """The profiler's duration of a one-element `add_`: what no launch
    goes below."""
    x = torch.zeros(1, device=dev)
    return profiled_ms(lambda: x.add_(1), kernel="elementwise")


def profile_task(label: str, fn, card: str, batches: int = 0) -> None:
    """Where one task's time goes: wall time, summed device time and the
    device's idle share, the kernel launches (per batch, given the
    task's `batches`), the top kernels and host ops."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # a whole task's trace holds 10^5-10^6 events; building their Python
    # objects took a third less time with the collector off (a 25,000-
    # event trace)
    t = time.perf_counter()
    gc.disable()
    try:
        avgs = prof.key_averages()
    finally:
        gc.enable()
    parse_s = time.perf_counter() - t
    busy = _device_us(avgs) / 1e6
    phase = label.split(":")[0]
    launches = sum(e.count for e in avgs
                   if e.device_type == DeviceType.CPU and
                   e.key.startswith("cudaLaunchKernel"))
    per = f", {launches / batches:.1f} a batch of {batches}" if batches \
        else ""
    print(f"{label} under the profiler: wall {wall:.4f} s, "
          f"device busy {busy:.4f} s, idle share {1 - busy / wall:.3f}, "
          f"{launches} kernel launches{per} (trace read in {parse_s:.1f} "
          f"s) | {card}")
    dev_rows = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                      key=lambda e: -(getattr(e, "self_device_time_total",
                                              0.0) or 0.0))[:8]
    for e in dev_rows:
        print(f"{phase}:   device {e.self_device_time_total / 1e3:9.4f} ms "
              f"x{e.count:<6d} {e.key[:70]}")
    cpu_rows = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:12]
    for e in cpu_rows:
        print(f"{phase}:   host   {e.self_cpu_time_total / 1e3:9.4f} ms "
              f"x{e.count:<6d} {e.key[:70]}")
    # the trace's events hold reference cycles: collect them here, not
    # inside the next timed stage
    del prof, avgs, dev_rows, cpu_rows
    gc.collect()


def profile_map_task(cols, valid, dev, card: str) -> None:
    """Phase 5: where one group-by map task's time goes, over its first
    quarter (reading a whole task's trace took 20 s on an H100)."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    profile_task("phase 5: map task 0, its first quarter",
                 lambda: map_task(0, cols, valid, InProcessShuffleService(),
                                  dev, n_maps=4 * N_MAPS), card)


def check_result(outs, cols, valid, K, dev) -> int:
    """The reduce output equals a numpy group-by of the same rows: keys
    and counts exactly, sums to relative 1e-9 (another summation order),
    the null-key group included, every key in partition
    pmod(murmur3(key), 200) of the plain version.  Returns the groups."""
    sk, qty, price = cols
    skv, qv, pv = valid
    for p, out in enumerate(outs):
        k, kv = out["ss_customer_sk"]
        pid = K.hash_partition_ids_i64_plain(
            torch.from_numpy(k).to(dev), torch.from_numpy(kv).to(dev),
            N_REDUCE)
        if not bool((pid == p).all()):
            raise AssertionError(f"reduce partition {p} holds keys of "
                                 f"another partition")
    got = {name: [np.concatenate([o[name][i] for o in outs]) for i in (0, 1)]
           for name in ("ss_customer_sk", "sum_sales", "cnt_sales")}
    gk = np.where(got["ss_customer_sk"][1], got["ss_customer_sk"][0], -1)
    order = np.argsort(gk, kind="stable")
    sales_valid = qv & pv
    sales = qty.astype(np.float64) * price
    uk, inv = np.unique(np.where(skv, sk, -1), return_inverse=True)
    ref_cnt = np.bincount(inv, weights=sales_valid).astype(np.int64)
    ref_sum = np.bincount(inv, weights=np.where(sales_valid, sales, 0.0))
    if len(gk) != len(uk) or not np.array_equal(gk[order], uk):
        raise AssertionError(f"group keys differ: {len(gk)} groups vs "
                             f"{len(uk)} in the reference")
    if not np.array_equal(got["cnt_sales"][0][order], ref_cnt):
        raise AssertionError("counts differ from the reference")
    if not np.array_equal(got["sum_sales"][1][order], ref_cnt > 0):
        raise AssertionError("sum nullness differs from the reference")
    s = got["sum_sales"][0][order]
    rel = np.abs(s - ref_sum) / np.maximum(np.abs(ref_sum), 1e-300)
    if not (np.all(rel <= 1e-9) and np.all(s[ref_cnt == 0] == 0)):
        raise AssertionError(f"sums differ: max relative error "
                             f"{rel.max()}")
    if uk[0] != -1:
        raise AssertionError("the data has no null-key group")
    return len(uk)



# ---------------------------------------------------------------------------
# the radix-histogram kernel (phases 6 and 8)
# ---------------------------------------------------------------------------

def hist_words(rng, n: int, dev, n_parts: int = 0):
    """n u32 words as the int32 bit view the kernel takes: uniform over
    all 32 bits, or, with n_parts, ids in [0, n_parts) in the top
    ceil_log2(n_parts) bits as the shuffle writer builds them."""
    if n_parts:
        from auron_tpu_torch.ops.radix_sort import ceil_log2
        u = rng.integers(0, n_parts, n).astype(np.uint64) << \
            np.uint64(32 - ceil_log2(n_parts))
    else:
        u = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    return torch.from_numpy(u.astype(np.uint32).view(np.int32)).to(dev)


def hist_bound(cap: int, b_bits: int):
    """(least time in ms, "bytes" or "operations") for cap words: each
    word read once, the [n_tiles, 2^b] int32 counts written once."""
    from auron_tpu_torch.ops.kernels_cuda import LANES, hist_tile_rows
    n_tiles = cap // (hist_tile_rows(cap) * LANES)
    by_bytes = (4 * cap + 4 * n_tiles * (1 << b_bits)) / HBM_BYTES_PER_S * 1e3
    by_ops = cap * HIST_OPS_PER_WORD / NONTENSOR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def hist_library_input(words, b_bits: int):
    """tile_id * 2^b + digit of every word: the index whose
    torch.bincount is the histogram (the library yardstick)."""
    from auron_tpu_torch.ops.kernels_cuda import LANES, hist_tile_rows
    cap = words.shape[0]
    tile = hist_tile_rows(cap) * LANES
    u = words.to(torch.int64) & 0xFFFFFFFF
    digit = u >> (32 - b_bits) if b_bits else torch.zeros_like(u)
    tile_id = torch.arange(cap, device=words.device) // tile
    return tile_id * (1 << b_bits) + digit, (cap // tile) << b_bits


def check_hist_kernel(K, dev, rng) -> int:
    """Phase 6: kernel == plain version, bit for bit, on the Pallas
    contract's shapes and on the shuffle writer's; returns the largest
    absolute count difference seen (0)."""
    from auron_tpu_torch.ops.shuffle import writer as W
    worst = 0

    def check(words, b, what):
        nonlocal worst
        got = K.radix_bucket_hist(words, b)
        exp = K.radix_bucket_hist_plain(words, b)
        torch.cuda.synchronize()
        err = int((got.long() - exp.long()).abs().max())
        worst = max(worst, err)
        if err or got.shape != exp.shape or \
                int(got.sum()) != words.shape[0]:
            raise AssertionError(f"radix-hist kernel != plain at {what} "
                                 f"b_bits={b}: max err {err}")
    sizes = (128, 256, 512, 1024, 128 * 131, 8192, 144_000, 1 << 24)
    clusters = {K.hist_launch_shape(n)[1] for n in sizes}
    if clusters != {1, 2, 4, 8}:
        raise AssertionError(f"the sizes cover clusters {clusters}")
    for n in sizes:
        words = hist_words(rng, n, dev)
        for b in (0, 1, 2, 6, 8):
            check(words, b, f"n={n}")
    # skew: every word in one bucket (the writer's zero padding, a null
    # partition)
    for n in (8192, 524_288):
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        # digit 199 in the top byte, as the int32 bit view
        same = (hist_words(rng, n, dev) & 0x00FFFFFF) | \
            ((199 << 24) - (1 << 32))
        for b in (0, 1, 2, 6, 8):
            check(zeros, b, f"all-zero n={n}")
            check(same, b, f"one digit n={n}")
    before = K.LAUNCHES["radix_bucket_hist"]
    try:
        K.radix_bucket_hist(hist_words(rng, 8193, dev)[1:], 8)
    except ValueError:
        pass
    else:
        raise AssertionError("a view off a 16-byte boundary did not raise")
    if K.LAUNCHES["radix_bucket_hist"] != before:
        raise AssertionError("the refused view was counted as a launch")
    for n in (1000, 8191):
        for n_parts in (1, 2, 4, 7, 200):
            pids = torch.from_numpy(rng.integers(0, n_parts, n)
                                    .astype(np.int32)).to(dev)
            got = W.sizes_by_hist(pids, n_parts)
            exp = torch.bincount(pids, minlength=n_parts).cpu().numpy()
            err = int(np.abs(got - exp).max())
            worst = max(worst, err)
            if err:
                raise AssertionError(f"writer sizes != bincount at n={n} "
                                     f"n_parts={n_parts}")
    print("phase 6: radix-hist kernel bit-exact with its plain version "
          "(n in 128, 256, 512, 1024, 16768, 8192, 144000, 2^24 x "
          "b_bits 0, 1, 2, 6, 8: clusters of 1, 2, 4, 8; all-zero and "
          "one-digit words at 8192, 524288); words[1:] raised ValueError; "
          "writer sizes exact at n in 1000, 8191 x n_parts 1, 2, 4, 7, 200")
    return worst


def time_hist(K, dev, rng, cap: int, n_parts: int, card: str,
              zero: bool = False):
    """Phase 8: the kernel at one of the writer's shapes, on ids of
    n_parts partitions or, with `zero`, on all-zero words (one bucket);
    returns its JSON numbers and the largest difference from the plain
    version."""
    words = torch.zeros(cap, dtype=torch.int32, device=dev) if zero else \
        hist_words(rng, cap, dev, n_parts)
    b = HIST_B_BITS
    idx, length = hist_library_input(words, b)
    kernel = lambda: K.radix_bucket_hist(words, b)  # noqa: E731
    plain = lambda: K.radix_bucket_hist_plain(words, b)  # noqa: E731
    library = lambda: torch.bincount(idx, minlength=length)  # noqa: E731
    err = int((kernel().long() - plain().long()).abs().max())
    lib_err = int((kernel().long().view(-1) - library()).abs().max())
    if err or lib_err:
        raise AssertionError(f"radix-hist kernel != plain/bincount at "
                             f"cap={cap}")
    ev = {k: median_ms(f) for k, f in
          (("kernel", kernel), ("plain", plain), ("library", library))}
    pr = {"kernel": profiled_ms(kernel, kernel="radix_hist_kernel"),
          "plain": profiled_ms(plain), "library": profiled_ms(library)}
    bound, bound_by = hist_bound(cap, b)
    print(f"phase 8: radix-hist cap={cap}{' all-zero' if zero else ''} "
          f"b_bits={b}: kernel "
          f"{ev['kernel']:.5f} ms by events, {pr['kernel']} ms by "
          f"profiler; plain {ev['plain']:.5f} / {pr['plain']} ms; "
          f"torch.bincount {ev['library']:.5f} / {pr['library']} ms; "
          f"bound {bound:.6f} ms ({bound_by}) | {card}")
    # the profiler's kernel durations where the trace has them: the event
    # window of one small launch also holds the host's launch overhead
    return {"ms": pr["kernel"] or ev["kernel"],
            "plain_ms": pr["plain"] or ev["plain"],
            "library_ms": pr["library"] or ev["library"],
            "bound_ms": bound, "bound_by": bound_by}, err


# ---------------------------------------------------------------------------
# the global-sort stage pair (phases 7 to 9)
# ---------------------------------------------------------------------------

def spark_lexsort_keys(cols, valid, orders):
    """np.lexsort keys (least significant first) that order rows of
    numeric key columns as Spark orders them: per key a null rank (nulls
    first or last) and the value, negated for a descending key; -0.0 and
    0.0 compare equal."""
    keys = []
    for c, v, (asc, nulls_first) in zip(cols, valid, orders):
        rank = v if nulls_first else ~v
        keys += [rank.astype(np.int8), np.where(v, c if asc else -c, 0)]
    return keys[::-1]


def range_bounds(cols, valid, orders, n_parts: int, n_maps: int,
                 seed: int):
    """The range bounds as Spark's RangePartitioner computes them:
    sampleSize = min(20 x partitions, 1e6) points, ceil(3 x sampleSize /
    splits) sampled from each split (rows cut into n_maps equal splits),
    each weighted by split rows / its sample count, then determineBounds:
    walk the weighted candidates in key order and take a bound each time
    the cumulative weight passes the next step, skipping duplicates.
    Returns up to n_parts - 1 bound rows of Python values (None = null)."""
    import math
    rows = len(cols[0])
    sample_size = min(float(SAMPLE_POINTS_PER_PARTITION * n_parts), 1e6)
    per_split = math.ceil(3.0 * sample_size / n_maps)
    rng = np.random.default_rng(seed)
    idx, weight = [], []
    for m in range(n_maps):
        lo, hi = m * rows // n_maps, (m + 1) * rows // n_maps
        k = min(per_split, hi - lo)
        idx.append(lo + rng.choice(hi - lo, k, replace=False))
        weight.append(np.full(k, (hi - lo) / k, dtype=np.float32))
    idx, weight = np.concatenate(idx), np.concatenate(weight)
    cols, valid = [c[idx] for c in cols], [v[idx] for v in valid]
    keys = spark_lexsort_keys(cols, valid, orders)
    order = np.lexsort(keys)
    key_rows = np.stack([k.astype(np.float64) for k in keys[::-1]], 1)
    step = float(weight.astype(np.float64).sum()) / n_parts
    cum, target, prev, bounds = 0.0, step, None, []
    for j in order:
        if len(bounds) == n_parts - 1:
            break
        cum += float(weight[j])
        if cum >= target and (prev is None or
                              tuple(key_rows[j]) != prev):
            bounds.append(tuple(c[j].item() if v[j] else None
                                for c, v in zip(cols, valid)))
            target += step
            prev = tuple(key_rows[j])
    return tuple(bounds)


def sort_stage_plans(bounds):
    """(map plan, reduce plan) of the global sort, in the port's IR."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    schema = _schema(*STORE_SALES)
    orders = (E.SortExpr(child=E.col("ss_sales_price"), asc=False,
                         nulls_first=False),
              E.SortExpr(child=E.col("ss_customer_sk"), asc=True,
                         nulls_first=True))
    names = tuple(f.name for f in schema)
    map_plan = _writer(P.Projection(
        child=P.FFIReader(schema=schema, resource_id="store_sales"),
        exprs=tuple(E.col(n) for n in names), names=names),
        "range", N_REDUCE, sort_orders=orders, range_bounds=bounds)
    reduce_plan = P.Sort(child=P.IpcReader(schema=schema,
                                           resource_id="shuffle_read"),
                         sort_exprs=orders)
    return map_plan, reduce_plan


def sort_reduce_task(p: int, svc, reduce_plan, dev):
    """Reduce task p of the global sort through execute_task_bytes."""
    blocks = [[] for _ in range(N_REDUCE)]
    blocks[p] = svc.reduce_blocks("sort", p)
    return reduce_task(reduce_plan, blocks, 4, p, dev)


def run_sort_stage_pair(cols, valid, plans, dev):
    """Phase 7: the global-sort stage pair.  Returns the shuffle service
    (it keeps the blocks for phases 8 and 9), the map results, the reduce
    outputs, the reduce tasks' metrics and the two stages' seconds."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    map_plan, reduce_plan = plans
    svc = InProcessShuffleService()
    t0 = time.perf_counter()
    map_results = [map_task(m, cols, valid, svc, dev, map_plan, "sort")
                   for m in range(N_MAPS)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs, metrics = [], []
    for p in range(N_REDUCE):
        r = sort_reduce_task(p, svc, reduce_plan, dev)
        outs.append(r.to_numpy())
        metrics.append(r.metrics)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return svc, map_results, outs, metrics, t1 - t0, t2 - t1


def _lex_less(a, b):
    """Row-wise lexicographic a < b and a == b over key lists (most
    significant first)."""
    lt = np.zeros(len(a[0]), bool)
    eq = np.ones(len(a[0]), bool)
    for x, y in zip(a, b):
        lt |= eq & (x < y)
        eq &= x == y
    return lt, eq


def check_sort_result(outs, cols, valid, bounds) -> list:
    """The partitions in id order equal numpy's stable lexsort of the
    input under Spark's ordering (every column, nulls included), and each
    row lies inside its partition's bounds: bound[p-1] < row <= bound[p].
    Returns the rows per partition."""
    names = ("ss_customer_sk", "ss_quantity", "ss_sales_price")
    orders = ((False, False), (True, True))
    sk, _qty, price = cols
    key_cols, key_valid = [price, sk], [valid[2], valid[0]]
    order = np.lexsort(spark_lexsort_keys(key_cols, key_valid, orders))
    sizes = [len(o[names[0]][0]) for o in outs]
    for i, name in enumerate(names):
        got_d = np.concatenate([o[name][0] for o in outs])
        got_v = np.concatenate([o[name][1] for o in outs])
        exp_v = valid[i][order]
        exp_d = np.where(exp_v, cols[i][order], 0)
        if not (np.array_equal(got_v, exp_v) and
                np.array_equal(got_d, exp_d)):
            raise AssertionError(f"sorted column {name} differs from "
                                 f"numpy's stable lexsort")
    got = [np.concatenate([o[n][0] for o in outs]) for n in names]
    got_valid = [np.concatenate([o[n][1] for o in outs]) for n in names]
    rows = spark_lexsort_keys([got[2], got[0]],
                              [got_valid[2], got_valid[0]], orders)[::-1]
    b_cols = [np.array([0.0 if r[0] is None else r[0] for r in bounds]),
              np.array([0 if r[1] is None else r[1] for r in bounds])]
    b_valid = [np.array([r[0] is not None for r in bounds]),
               np.array([r[1] is not None for r in bounds])]
    b_keys = spark_lexsort_keys(b_cols, b_valid, orders)[::-1]
    pid = np.repeat(np.arange(len(outs)), sizes)
    lower = pid > 0
    if lower.any():
        lb = [k[pid[lower] - 1] for k in b_keys]
        lt, _ = _lex_less(lb, [k[lower] for k in rows])
        if not lt.all():
            raise AssertionError("a row is not above its lower bound")
    upper = pid < len(bounds)
    if upper.any():
        ub = [k[pid[upper]] for k in b_keys]
        lt, eq = _lex_less([k[upper] for k in rows], ub)
        if not (lt | eq).all():
            raise AssertionError("a row is above its upper bound")
    return sizes


def time_reduce_sort(svc, dev, card: str):
    """Phase 8: one reduce task's sort (partition 0's rows, their keys
    encoded once) under the pack-sort and under the multipass argsort;
    both must give the same permutation."""
    from auron_tpu_torch.columnar.batch import concat_batches
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.ops import sort_keys as SK
    blocks = svc.reduce_blocks("sort", 0)
    b = concat_batches(blocks[0].schema, blocks)
    key_cols = [b.columns[2], b.columns[0]]
    words = SK.encode_sort_keys(key_cols, ((False, False), (True, True)))
    bits = SK.encode_sort_keys_bits(key_cols)
    perms, ms = {}, {}
    for name, strategy in (("pack-sort", "radix"),
                           ("multipass", "argsort")):
        with conf.scoped({"auron.kernel.sort.strategy": strategy}):
            fn = lambda: SK.lexsort_indices(  # noqa: E731
                words, b.num_rows, b.capacity, bits)
            perms[name] = fn()
            ms[name] = (median_ms(fn, iters=11), profiled_ms(fn, iters=5))
    if not torch.equal(perms["pack-sort"], perms["multipass"]):
        raise AssertionError("pack-sort and multipass permutations differ")
    for name, (ev, pr) in ms.items():
        print(f"phase 8: reduce sort of partition 0 ({b.num_rows} rows, "
              f"capacity {b.capacity}, {len(words)} words) by {name}: "
              f"{ev:.5f} ms by events, {pr} ms by profiler | {card}")


def profile_sort_tasks(cols, valid, svc, plans, dev, card: str) -> None:
    """Phase 9: a 64th of sort map task 0 (the first of 512 splits:
    reading a whole task's trace took 112-168 s on an H100, a quarter's
    41-48 s, an eighth's 16-22 s, a sixteenth's 8.4-10.6 s) and one
    sort reduce task."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    scratch = InProcessShuffleService()
    profile_task("phase 9: sort map task 0, its first 64th",
                 lambda: map_task(0, cols, valid, scratch, dev, plans[0],
                                  "sort", n_maps=64 * N_MAPS), card)
    profile_task("phase 9: sort reduce task 0",
                 lambda: sort_reduce_task(0, svc, plans[1], dev), card)

# ---------------------------------------------------------------------------
# TPC-DS q96, q88c and q01's aggregate stages (phases 10 to 12)
# ---------------------------------------------------------------------------

def make_sold_date_sk(rows: int, seed: int):
    """ss_sold_date_sk uniform over the TPC-DS sold-date keys, with
    NULL_FRACTION nulls, from a generator of its own (the other columns
    stay as phase 3 made them)."""
    rng = np.random.default_rng([seed, 96])
    lo, hi = SOLD_DATE_SK
    return (rng.integers(lo, hi + 1, rows, dtype=np.int64),
            rng.random(rows) >= NULL_FRACTION)


def make_store_returns(cols, valid, seed: int):
    """store_returns as `it/datagen.py` draws it, at the store_sales
    rows' scale (2,875,432 rows at SF 10): returned sales sampled without
    replacement, the sale's customer, a store uniform over the SF-10
    stores (the sales rows carry none), the amount round(quantity x
    price x U(0.1, 1.0), 2), each column with NULL_FRACTION nulls.
    Returns the columns, their validities and the sampled sales' rows."""
    rows = len(cols[0])
    n = max(1, rows * SF10_STORE_RETURNS_ROWS // SF10_STORE_SALES_ROWS)
    rng = np.random.default_rng([seed, 1])
    ridx = rng.choice(rows, n, replace=False)
    cust = cols[0][ridx]
    store = rng.integers(1, SF10_STORES + 1, n, dtype=np.int64)
    amt = np.round(cols[1][ridx].astype(np.float64) * cols[2][ridx] *
                   rng.uniform(0.1, 1.0, n), 2)
    return [cust, store, amt], [rng.random(n) >= NULL_FRACTION
                                for _ in range(3)], ridx


def store_sales_plans(name: str):
    """(map plan, reduce plan) of q96 or q88c in the port's IR, as the JAX
    package's converter lowers them (tests/test_torch_corpus_stages.py
    holds them to its JSON), the parquet scan an FFIReader."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    i32, i64, f64 = DataType.int32(), DataType.int64(), DataType.float64()
    qty, price = E.col("ss_quantity"), E.col("ss_sales_price")

    def lit(v, t):
        return E.Literal(value=v, dtype=t)

    def writer(child):
        return _writer(child, "single", 1)

    def agg(child, mode, aggs, names):
        return P.Agg(child=child, exec_mode=mode, aggs=aggs, agg_names=names)
    if name == "q96":
        scan = P.FFIReader(schema=_schema(
            ("ss_sold_date_sk", "i64"), *STORE_SALES[1:]),
            resource_id="store_sales")
        aggs = (E.AggExpr(fn="count", children=(qty,), return_type=i64),)
        filt = P.Filter(child=scan, predicates=(
            E.BinaryExpr(left=qty, op=">=", right=lit(20, i32)),
            E.BinaryExpr(left=price, op="<", right=lit(120.0, f64))))
        states = _schema(("cnt#count", "i64", False))
        return (writer(agg(filt, "partial", aggs, ("cnt",))),
                P.Limit(child=agg(P.IpcReader(schema=states,
                                              resource_id="shuffle_read"),
                                  "final", aggs, ("cnt",)), limit=100))
    scan = P.FFIReader(schema=_schema(*STORE_SALES[1:]),
                       resource_id="store_sales")

    def flag(cond):
        return E.Case(branches=(E.WhenThen(when=cond, then=lit(1, i64)),),
                      else_expr=lit(0, i64))
    bands = (flag(E.BinaryExpr(left=qty, op="<=", right=lit(20, i32))),
             flag(E.ScAnd(left=E.BinaryExpr(left=qty, op=">",
                                            right=lit(20, i32)),
                          right=E.BinaryExpr(left=qty, op="<=",
                                             right=lit(60, i32)))),
             flag(E.BinaryExpr(left=qty, op=">", right=lit(60, i32))))
    names = ("n1", "n2", "n3")
    aggs = tuple(E.AggExpr(fn="sum", children=(E.col(b),), return_type=i64)
                 for b in ("b1", "b2", "b3"))
    proj = P.Projection(child=scan, exprs=bands, names=("b1", "b2", "b3"))
    states = _schema(*((f"{n}#sum", "i64") for n in names))
    return (writer(agg(proj, "partial", aggs, names)),
            agg(P.IpcReader(schema=states, resource_id="shuffle_read"),
                "final", aggs, names))


def q01_plans():
    """The three aggregate stages of q01's threshold subtree in the port's
    IR, as the converter lowers them: (stage-1 map plan, stage-2 map plan,
    stage-3 plan)."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    f64 = DataType.float64()
    cust, store = E.col("sr_customer_sk"), E.col("sr_store_sk")
    keys, key_names = (cust, store), ("sr_customer_sk", "sr_store_sk")
    ctr = (E.AggExpr(fn="sum", children=(E.col("sr_return_amt"),),
                     return_type=f64),)
    avg = (E.AggExpr(fn="avg", children=(E.col("ctr_total_return"),),
                     return_type=f64),)
    scan = P.FFIReader(schema=_schema(
        ("sr_customer_sk", "i64"), ("sr_store_sk", "i64"),
        ("sr_return_amt", "f64")), resource_id="store_returns")
    stage1 = _writer(P.Agg(child=scan, exec_mode="partial", grouping=keys,
                           grouping_names=key_names, aggs=ctr,
                           agg_names=("ctr_total_return",)),
                     "hash", 4, keys)
    ctr_states = _schema(("sr_customer_sk", "i64"), ("sr_store_sk", "i64"),
                         ("ctr_total_return#sum", "f64"))
    final_ctr = P.Agg(child=P.IpcReader(schema=ctr_states,
                                        resource_id="shuffle_read"),
                      exec_mode="final", grouping=keys,
                      grouping_names=key_names, aggs=ctr,
                      agg_names=("ctr_total_return",))
    stage2 = _writer(P.Agg(child=final_ctr, exec_mode="partial",
                           grouping=(store,), grouping_names=("sr_store_sk",),
                           aggs=avg, agg_names=("avg_return",)),
                     "hash", 2, (store,))
    avg_states = _schema(("sr_store_sk", "i64"), ("avg_return#sum", "f64"),
                         ("avg_return#count", "i64", False))
    stage3 = P.Projection(
        child=P.Agg(child=P.IpcReader(schema=avg_states,
                                      resource_id="shuffle_read"),
                    exec_mode="final", grouping=(store,),
                    grouping_names=("sr_store_sk",), aggs=avg,
                    agg_names=("avg_return",)),
        exprs=(store, E.BinaryExpr(left=E.col("avg_return"), op="*",
                                   right=E.Literal(value=1.2, dtype=f64))),
        names=("avg_store_sk", "threshold"))
    return stage1, stage2, stage3


def reduce_task(plan, blocks, stage: int, p: int, dev, writer=None):
    """Task p of a stage that reads an exchange's per-partition `blocks`
    (and, with `writer`, writes into another exchange) through
    execute_task_bytes."""
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.ops.shuffle.writer import PartitionedBlocks
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    res = ResourceRegistry()
    res.put("shuffle_read", PartitionedBlocks(blocks))
    if writer is not None:
        res.put("shuffle_writer", writer)
    task = P.TaskDefinition(plan=plan, stage_id=stage, partition_id=p,
                            num_partitions=len(blocks))
    return execute_task_bytes(serde.serialize(task), res, device=dev)


def run_shuffle_stage(plan, svc, shuffle_id, n_tasks, task_fn):
    """Run n_tasks tasks (task_fn(m)), then return their results, the
    seconds they took and the exchange's blocks per reduce partition."""
    t0 = time.perf_counter()
    results = [task_fn(m) for m in range(n_tasks)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_parts = plan.partitioning.num_partitions
    return results, secs, [svc.reduce_blocks(shuffle_id, p)
                           for p in range(n_parts)]


def run_global_query(name: str, cols, valid, dev, K, card: str):
    """Phases 10 and 11: q96 or q88c, 8 map tasks into one partition and
    one reduce task.  Returns {column: (data, validity)}, the path's
    launches and its kernel shapes."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    map_plan, reduce_plan = store_sales_plans(name)
    svc = InProcessShuffleService()
    K.reset_launches()
    maps, map_s, blocks = run_shuffle_stage(
        map_plan, svc, name, N_MAPS,
        lambda m: map_task(m, cols, valid, svc, dev, map_plan, name))
    t = time.perf_counter()
    out = reduce_task(reduce_plan, blocks, 2, 0, dev).to_numpy()
    torch.cuda.synchronize()
    reduce_s = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    pushed, shapes = check_stage(name, launches, maps, 1, hash_pid=False)
    phase = {"q96": 10, "q88c": 11}[name]
    print(f"phase {phase}: {name} map stage {map_s:.3f} s "
          f"({len(cols[0]) / map_s:.0f} rows/s), reduce stage "
          f"{reduce_s:.4f} s, {pushed} map-side batches = "
          f"{launches['radix_bucket_hist']} radix-hist launches (b = 1), "
          f"0 hash-pid launches | {card}")
    return out, launches, shapes


def check_q96(out, cols, valid) -> int:
    _, qty, price = cols
    _, qv, pv = valid
    exp = int(np.sum(qv & pv & (qty >= 20) & (price < 120.0)))
    got, gv = out["cnt"]
    if got.tolist() != [exp] or not gv.all():
        raise AssertionError(f"q96 count {got.tolist()} != numpy {exp}")
    return exp


def check_q88c(out, cols, valid):
    qty, qv = cols[1], valid[1]
    exp = [int(np.sum(qv & (qty <= 20))),
           int(np.sum(qv & (qty > 20) & (qty <= 60))),
           int(np.sum(qv & (qty > 60)))]
    got = [out[n][0].tolist() for n in ("n1", "n2", "n3")]
    if got != [[e] for e in exp] or \
            not all(out[n][1].all() for n in ("n1", "n2", "n3")):
        raise AssertionError(f"q88c bands {got} != numpy {exp}")
    return exp


def run_q01_stages(rcols, rvalid, dev, K, card: str):
    """Phase 12: the three aggregate stages of q01's threshold subtree.
    Returns the stage-3 outputs, the path's launches and its kernel
    shapes."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    s1, s2, s3 = q01_plans()
    svc1, svc2 = InProcessShuffleService(), InProcessShuffleService()
    K.reset_launches()
    maps1, t1, blocks1 = run_shuffle_stage(
        s1, svc1, "ctr", N_RETURN_MAPS,
        lambda m: map_task(m, rcols, rvalid, svc1, dev, s1, "ctr",
                           "store_returns", N_RETURN_MAPS))
    after1 = dict(K.LAUNCHES)
    maps2, t2, blocks2 = run_shuffle_stage(
        s2, svc2, "avg", len(blocks1),
        lambda p: reduce_task(s2, blocks1, 2, p, dev,
                              svc2.rss_writer("avg", p)))
    after2 = dict(K.LAUNCHES)
    t = time.perf_counter()
    outs = [reduce_task(s3, blocks2, 3, p, dev).to_numpy()
            for p in range(len(blocks2))]
    torch.cuda.synchronize()
    t3 = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    # stage 1 hashes two keys, so no hash-pid there
    pushed1, shapes1 = check_stage("q01 stage 1", after1, maps1, 4,
                                   hash_pid=False)
    stage2 = _stage_launches(after1, after2)
    pushed2, shapes2 = check_stage("q01 stage 2", stage2, maps2, 2,
                                   hash_pid=True)
    if launches != after2:
        raise AssertionError("q01 stage 3 launched a kernel")
    print(f"phase 12: q01 stage 1 (scan -> partial sum -> hash(4)) "
          f"{t1:.3f} s ({len(rcols[0]) / t1:.0f} rows/s), stage 2 (final sum -> "
          f"partial avg -> hash(2)) {t2:.3f} s, stage 3 (final avg -> "
          f"threshold) {t3:.4f} s; stage 1: {pushed1} map-side batches = "
          f"{after1['radix_bucket_hist']} radix-hist launches (b = 2), 0 "
          f"hash-pid; stage 2: {pushed2} = {stage2['radix_bucket_hist']} "
          f"radix-hist (b = 1) = {stage2['hash_partition_ids_i64']} hash-pid "
          f"launches | {card}")
    return outs, launches, shapes1 + shapes2


def check_q01(outs, rcols, rvalid) -> int:
    """One row per store (the null store included), each 1.2 x the mean
    of the store's (customer, store) sums over numpy's group-by (a null
    customer is a group of its own), to relative 1e-9.  Returns the
    stores."""
    cust, store, amt = rcols
    cv, sv, av = rvalid
    ck = np.where(cv, cust, -1)
    sk = np.where(sv, store, -1)
    pair, inv = np.unique(ck * (SF10_STORES + 2) + (sk + 1),
                          return_inverse=True)
    sums = np.bincount(inv, weights=np.where(av, amt, 0.0))
    has = np.bincount(inv, weights=av) > 0
    pair_store = pair % (SF10_STORES + 2) - 1
    stores, sinv = np.unique(pair_store, return_inverse=True)
    n = np.bincount(sinv, weights=has)
    mean = np.bincount(sinv, weights=np.where(has, sums, 0.0)) / \
        np.maximum(n, 1)
    exp = {(None if s < 0 else int(s)): (1.2 * m if c else None)
           for s, m, c in zip(stores, mean, n)}
    got = {}
    for o in outs:
        (k, kv), (t, tv) = o["avg_store_sk"], o["threshold"]
        for key, ok, val, vok in zip(k, kv, t, tv):
            key = int(key) if ok else None
            if key in got:
                raise AssertionError(f"q01: store {key} appears twice")
            got[key] = float(val) if vok else None
    if set(got) != set(exp) or None not in got:
        raise AssertionError(f"q01: stores {sorted(got, key=str)} != numpy "
                             f"{sorted(exp, key=str)}")
    for key, e in exp.items():
        g = got[key]
        if (g is None) != (e is None) or \
                (e is not None and abs(g - e) > 1e-9 * abs(e)):
            raise AssertionError(f"q01: store {key} threshold {g} != numpy "
                                 f"{e}")
    return len(exp)


# ---------------------------------------------------------------------------
# q17m's and q39v's aggregations above their joins, and float keys
# (phases 13 and 14)
# ---------------------------------------------------------------------------

SF10_ITEMS = 102_000                 # TPC-DS item at scale factor 10
SF10_WAREHOUSES = 10                 # TPC-DS warehouse at scale factor 10
# SF-10 inventory: 133,110,000 rows = 261 weekly snapshots x 510,000
# (item, warehouse) pairs, half the items in each snapshot
INV_ITEMS = SF10_ITEMS // 2
N_AGG_PARTS = 4                      # the converter's q17m / q39v exchanges
Q39V_RATIO = 0.4                     # the corpus's sdev / mean threshold
FLOAT_KEY_ROWS = 1 << 20
FLOAT_KEY_VALUES = 1_000
# float64 bit patterns: -0.0, 0.0, +inf, -inf, the quiet NaN, its
# negative, a quiet NaN with a payload, a signalling NaN and a negative one
SPECIAL_F64_BITS = (0x8000000000000000, 0, 0x7FF0000000000000,
                    0xFFF0000000000000, 0x7FF8000000000000,
                    0xFFF8000000000000, 0x7FF8000000000001,
                    0x7FF0000000000123, 0xFFF4000000000000)
CANONICAL_NAN_BITS = 0x7FF8000000000000


Q17M_JOIN = (("ss_ticket_number", "i64"), ("ss_item_sk", "i64"),
             ("ss_store_sk", "i64"), ("ss_quantity", "i32"),
             ("sr_ticket_number", "i64"), ("sr_item_sk", "i64"),
             ("sr_return_amt", "f64"))
Q39V_JOIN = (("inv_date_sk", "i64"), ("inv_item_sk", "i64"),
             ("inv_warehouse_sk", "i64"), ("inv_quantity_on_hand", "i32"),
             ("d_date_sk", "i64"), ("d_moy", "i32"), ("d_year", "i32"))


def q17m_plans():
    """q17m above its sort-merge join in the port's IR, as the converter
    lowers it (tests/test_torch_corpus_aggs.py holds them to its JSON),
    the join an FFIReader of its output rows: (stage 1: partial Min, Max,
    Average, Count by ss_store_sk -> hash(4); stage 2: final -> Sort
    fetch 100 -> single; stage 3: Sort fetch 100 -> Projection)."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    i32, i64, f64 = DataType.int32(), DataType.int64(), DataType.float64()
    store = E.col("ss_store_sk")
    qty = E.col("ss_quantity")
    aggs = (E.AggExpr(fn="min", children=(qty,), return_type=i32),
            E.AggExpr(fn="max", children=(qty,), return_type=i32),
            E.AggExpr(fn="avg", children=(E.col("sr_return_amt"),),
                      return_type=f64),
            E.AggExpr(fn="count", children=(E.col("ss_ticket_number"),),
                      return_type=i64))
    names = ("min_q", "max_q", "avg_r", "n")

    def agg(child, mode):
        return P.Agg(child=child, exec_mode=mode, grouping=(store,),
                     grouping_names=("ss_store_sk",), aggs=aggs,
                     agg_names=names)
    join = P.FFIReader(schema=_schema(*Q17M_JOIN), resource_id="join")
    stage1 = _writer(agg(join, "partial"), "hash", N_AGG_PARTS, (store,))
    states = _schema(("ss_store_sk", "i64"), ("min_q#min", "i32"),
                     ("max_q#max", "i32"), ("avg_r#sum", "f64"),
                     ("avg_r#count", "i64", False), ("n#count", "i64", False))
    order = (E.SortExpr(child=store, asc=True, nulls_first=True),)
    out = _schema(("ss_store_sk", "i64"), ("min_q", "i32"),
                  ("max_q", "i32"), ("avg_r", "f64"), ("n", "i64"))
    return (stage1,) + _take_ordered(
        agg(P.IpcReader(schema=states, resource_id="shuffle_read"), "final"),
        order, 100, out, [f.name for f in out])


def _take_ordered(child, order, limit: int, out, names):
    """The converter's take-ordered over `child` (a plan of schema
    `out`): (Sort(fetch limit) -> single-partition writer, then
    Sort(fetch limit) -> Projection of `names`)."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    stage = _writer(P.Sort(child=child, sort_exprs=order, fetch_limit=limit),
                    "single", 1)
    top = P.Projection(
        child=P.Sort(child=P.IpcReader(schema=out,
                                       resource_id="shuffle_read"),
                     sort_exprs=order, fetch_limit=limit),
        exprs=tuple(E.col(n) for n in names), names=tuple(names))
    return stage, top


def q39v_plans(moy: int):
    """q39v's month_stats for month `moy` above its broadcast join, as
    the converter lowers it: (map: partial Average and StddevSamp of
    cast(qty as double) by (warehouse, item) -> hash(4); reduce: final
    -> Projection(rename) -> Filter(sdev / mean > 0.4) -> hash(4), the
    exchange of the self-join)."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    f64 = DataType.float64()
    keys = (E.col("inv_warehouse_sk"), E.col("inv_item_sk"))
    key_names = ("inv_warehouse_sk", "inv_item_sk")
    qty = E.Cast(child=E.col("inv_quantity_on_hand"), dtype=f64)
    aggs = (E.AggExpr(fn="avg", children=(qty,), return_type=f64),
            E.AggExpr(fn="stddev_samp", children=(qty,), return_type=f64))

    def agg(child, mode):
        return P.Agg(child=child, exec_mode=mode, grouping=keys,
                     grouping_names=key_names, aggs=aggs,
                     agg_names=("mean", "sdev"))
    join = P.FFIReader(schema=_schema(*Q39V_JOIN), resource_id="join")
    stage1 = _writer(agg(join, "partial"), "hash", N_AGG_PARTS, keys)
    states = _schema(("inv_warehouse_sk", "i64"), ("inv_item_sk", "i64"),
                     ("mean#sum", "f64"), ("mean#count", "i64", False),
                     ("sdev#sum", "f64"), ("sdev#sumsq", "f64"),
                     ("sdev#count", "i64", False))
    s = str(moy)
    renamed = P.Projection(
        child=agg(P.IpcReader(schema=states, resource_id="shuffle_read"),
                  "final"),
        exprs=keys + (E.col("mean"), E.col("sdev")),
        names=(f"w{s}", f"i{s}", f"mean{s}", f"sdev{s}"))
    cov = E.BinaryExpr(left=E.col(f"sdev{s}"), op="/",
                       right=E.col(f"mean{s}"))
    kept = P.Filter(child=renamed, predicates=(E.BinaryExpr(
        left=cov, op=">", right=E.Literal(value=Q39V_RATIO, dtype=f64)),))
    stage2 = _writer(kept, "hash", N_AGG_PARTS,
                     (E.col(f"w{s}"), E.col(f"i{s}")))
    return stage1, stage2


def inventory_dates(moy: int) -> np.ndarray:
    """The weekly inventory snapshots of month `moy` of 2000 on
    `it/datagen.py`'s grid: d_date_sk 2450815 is 1998-01-01, years of 365
    days, months of 30 (December the rest), a snapshot every 7th day."""
    idx = np.arange(0, 5 * 365, 7)
    doy, year = idx % 365, 1998 + idx // 365
    month = np.minimum(doy // 30 + 1, 12)
    return idx[(year == 2000) & (month == moy)] + 2_450_815


def make_inventory_month(moy: int, seed: int, items: int = INV_ITEMS):
    """The rows of q39v's broadcast join for month `moy`: its snapshots,
    each holding the 510,000 (item, warehouse) pairs of an SF-10 snapshot
    in the generator's order, inv_quantity_on_hand uniform over 0..999
    as `it/datagen.py` draws it with NULL_FRACTION nulls, the date
    columns of the matched date_dim row.  The keys are never null.
    `items` cuts the 51,000 items of a snapshot for a quick check."""
    dates = inventory_dates(moy)
    pairs = items * SF10_WAREHOUSES
    n = len(dates) * pairs
    rng = np.random.default_rng([seed, 39, moy])
    date = np.repeat(dates, pairs)
    item = np.tile(np.repeat(np.arange(1, items + 1, dtype=np.int64),
                             SF10_WAREHOUSES), len(dates))
    wh = np.tile(np.arange(1, SF10_WAREHOUSES + 1, dtype=np.int64),
                 len(dates) * items)
    qty = rng.integers(0, 1000, n).astype(np.int32)
    ones = np.ones(n, bool)
    return ([date, item, wh, qty, date, np.full(n, moy, np.int32),
             np.full(n, 2000, np.int32)],
            [ones, ones, ones, rng.random(n) >= NULL_FRACTION, ones, ones,
             ones])


def check_q17m(out, jcols, jvalid) -> int:
    """100 rows in store order, the null store first: per store the Min
    and Max of ss_quantity and the Count of tickets exact, the Average of
    sr_return_amt to relative 1e-9, against numpy.  Returns the stores."""
    store, qty, amt = jcols[2], jcols[3], jcols[6]
    sv, qv, av = jvalid[2], jvalid[3], jvalid[6]
    uk, inv = np.unique(np.where(sv, store, -1), return_inverse=True)
    g = len(uk)
    cnt = np.bincount(inv, minlength=g)
    qmin = np.full(g, np.iinfo(np.int32).max, np.int64)
    qmax = np.full(g, np.iinfo(np.int32).min, np.int64)
    np.minimum.at(qmin, inv[qv], qty[qv])
    np.maximum.at(qmax, inv[qv], qty[qv])
    has_q = np.bincount(inv, weights=qv, minlength=g) > 0
    asum = np.bincount(inv, weights=np.where(av, amt, 0.0), minlength=g)
    acnt = np.bincount(inv, weights=av, minlength=g)
    top = min(100, g)
    (k, kv), (mn, mnv), (mx, mxv), (a, avv), (n, nv) = (
        out[c] for c in ("ss_store_sk", "min_q", "max_q", "avg_r", "n"))
    if len(k) != top or uk[0] != -1:
        raise AssertionError(f"q17m: {len(k)} rows, want {top} with the "
                             f"null store")
    if not (np.array_equal(np.where(kv, k, -1), uk[:top]) and
            np.array_equal(mnv, has_q[:top]) and
            np.array_equal(mxv, has_q[:top]) and nv.all() and
            np.array_equal(mn[mnv], qmin[:top][has_q[:top]]) and
            np.array_equal(mx[mxv], qmax[:top][has_q[:top]]) and
            np.array_equal(n, cnt[:top])):
        raise AssertionError("q17m: stores, Min, Max or Count differ from "
                             "numpy")
    exp = asum[:top] / np.maximum(acnt[:top], 1)
    if not np.array_equal(avv, acnt[:top] > 0) or \
            np.any(np.abs(a[avv] - exp[avv]) > 1e-9 * np.abs(exp[avv])):
        raise AssertionError("q17m: Average differs from numpy")
    return g


def check_q39v(kept, icols, ivalid, moy: int):
    """The kept (warehouse, item) groups equal numpy's: mean and
    std(ddof=1) of each group's quantities to relative 1e-9, a group of
    one valid row with sdev NaN and kept (NaN > 0.4 in Spark's order; the
    NaN is the JAX package's and its oracle's, which Spark gives only
    with spark.sql.legacy.statisticalAggregate: ROADMAP Queue 3 item
    14), groups of no valid row or a zero mean dropped (a null ratio).
    Whether a group is kept is decided in exact integer arithmetic:
    sdev / mean > 0.4 iff 25 n (n sum(q^2) - s^2) > 4 (n - 1) s^2 for
    s > 0; a group on the tie (equality) may go either way in floating
    point and is counted, not checked.  Returns (kept, NaN sdevs,
    ties)."""
    snaps = len(inventory_dates(moy))
    q = icols[3].reshape(snaps, -1).astype(np.int64)
    v = ivalid[3].reshape(snaps, -1)
    n = v.sum(0)
    s = np.where(v, q, 0).sum(0)
    s2 = np.where(v, q * q, 0).sum(0)
    lhs = 25 * n * (n * s2 - s * s)
    rhs = 4 * (n - 1) * s * s
    want = (n > 0) & (s > 0) & ((n == 1) | (lhs > rhs))
    tie = (n > 1) & (s > 0) & (lhs == rhs)
    w, wv = kept[f"w{moy}"]
    it, iv = kept[f"i{moy}"]
    if not (wv.all() and iv.all()):
        raise AssertionError("q39v: a null key was kept")
    pair = (it - 1) * SF10_WAREHOUSES + (w - 1)
    if len(np.unique(pair)) != len(pair):
        raise AssertionError("q39v: a group was kept twice")
    got = np.zeros(len(n), bool)
    got[pair] = True
    if np.any((got != want) & ~tie):
        bad = np.flatnonzero((got != want) & ~tie)
        raise AssertionError(f"q39v month {moy}: kept set differs from "
                             f"numpy at {len(bad)} groups, e.g. pair "
                             f"{bad[0]}")
    mean = s / np.maximum(n, 1)
    dev = np.where(v, q - mean, 0.0)
    sd = np.sqrt((dev * dev).sum(0) / np.maximum(n - 1, 1))
    (m, mv), (d, dv) = kept[f"mean{moy}"], kept[f"sdev{moy}"]
    em, ed, en = mean[pair], sd[pair], n[pair]
    one = en == 1
    if not (mv.all() and dv.all() and
            np.all(np.abs(m - em) <= 1e-9 * np.abs(em)) and
            np.all(np.isnan(d[one])) and
            np.all(np.abs(d[~one] - ed[~one]) <= 1e-9 * np.abs(ed[~one]))):
        raise AssertionError(f"q39v month {moy}: a mean or sdev differs "
                             f"from numpy")
    return int(got.sum()), int(one.sum()), int(tie.sum())


def make_float_keys(seed: int, n: int = FLOAT_KEY_ROWS):
    """n rows of a float64 key drawn from FLOAT_KEY_VALUES
    values (the special patterns of SPECIAL_F64_BITS among them) and a
    float64 value drawn from the special patterns and 50 numbers, each
    column with NULL_FRACTION nulls."""
    rng = np.random.default_rng([seed, 64])
    special = np.array(SPECIAL_F64_BITS, np.uint64).view(np.float64)
    keys = np.concatenate([special, np.round(rng.normal(
        size=FLOAT_KEY_VALUES - len(special)) * 1e3, 2)])
    vals = np.concatenate([special, rng.normal(size=50)])
    return ([rng.choice(keys, n), rng.choice(vals, n)],
            [rng.random(n) >= NULL_FRACTION for _ in range(2)])


def float_key_plans(mode: str = "two-phase", fns=("count", "min", "max",
                                                   "first_ignores_null")):
    """Group by the float64 key k of (k, v): map partial Agg(fns of v) ->
    hash(4) on k, reduce final Agg; or, with mode "single", one single
    Agg."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    i64, f64 = DataType.int64(), DataType.float64()
    aggs = tuple(E.AggExpr(fn=f, children=(E.col("v"),),
                           return_type=i64 if f == "count" else f64)
                 for f in fns)
    names = tuple(f"a{i}" for i in range(len(fns)))
    key = (E.col("k"),)

    def agg(child, m):
        return P.Agg(child=child, exec_mode=m, grouping=key,
                     grouping_names=("k",), aggs=aggs, agg_names=names)
    src = P.FFIReader(schema=_schema(("k", "f64"), ("v", "f64")),
                      resource_id="floats")
    if mode == "single":
        return agg(src, "single")
    states = [("k", "f64")]
    for name, f in zip(names, fns):
        state = "first" if f == "first_ignores_null" else f
        states.append((f"{name}#{state}", "i64" if f == "count" else "f64",
                       f != "count"))
    reader = P.IpcReader(schema=_schema(*states), resource_id="shuffle_read")
    return (_writer(agg(src, "partial"), "hash", N_AGG_PARTS, key),
            agg(reader, "final"))


def _spark_key(k, kv):
    """int64 group ids of float64 keys under Spark's normalization: -0.0
    as 0.0, every NaN as one, null a group of its own."""
    kn = np.where(k == 0, 0.0, k)
    kn = np.where(np.isnan(kn), np.nan, kn).view(np.int64)
    # 0x7FF8000000000001 is no normalized key's pattern: the null group
    return np.where(kv, kn, np.int64(CANONICAL_NAN_BITS + 1))


def run_float_keys(fcols, fvalid, dev, K, card: str):
    """Phase 13: the float-key group-by (4 map tasks into hash(4) on the
    key, 4 reduce tasks).  Returns {column: (data, validity)}, the
    launches and the kernel shapes."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    mplan, rplan = float_key_plans()
    svc = InProcessShuffleService()
    K.reset_launches()
    maps, t1, blocks = run_shuffle_stage(
        mplan, svc, "floats", N_AGG_PARTS,
        lambda m: map_task(m, fcols, fvalid, svc, dev, mplan, "floats",
                           "floats", N_AGG_PARTS))
    t = time.perf_counter()
    outs = [reduce_task(rplan, blocks, 2, p, dev).to_numpy()
            for p in range(len(blocks))]
    torch.cuda.synchronize()
    t2 = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    pushed, shapes = check_stage("float keys map", launches, maps,
                                 N_AGG_PARTS, hash_pid=False)
    out = {c: tuple(np.concatenate([o[c][i] for o in outs]) for i in (0, 1))
           for c in outs[0]}
    print(f"phase 13: float-key group-by of {len(fcols[0])} rows: map "
          f"{t1:.3f} s, reduce {t2:.4f} s, {pushed} map-side batches = "
          f"{launches['radix_bucket_hist']} radix-hist (b = 2), 0 hash-pid "
          f"| {card}")
    return out, launches, shapes


def _spark_extremes(gid, g, x, xv):
    """Per group: Spark's Min and Max of float64 x (NaN the greatest,
    -0.0 equal to 0.0) and whether the group has a valid value."""
    nan = np.isnan(x)
    num = xv & ~nan
    mn = np.full(g, np.inf)
    mx = np.full(g, -np.inf)
    np.minimum.at(mn, gid[num], x[num])
    np.maximum.at(mx, gid[num], x[num])
    has_num = np.bincount(gid, weights=num, minlength=g) > 0
    has_nan = np.bincount(gid, weights=xv & nan, minlength=g) > 0
    mn = np.where(has_num, mn, np.nan)
    mx = np.where(has_nan, np.nan, mx)
    return mn, mx, has_num | has_nan


def check_float_keys(out, fcols, fvalid) -> int:
    """One group per normalized key (one for +-0.0, one for every NaN,
    one for null), each key normalized; Count exact, Min and Max as
    Spark orders floats (and normalized), first_ignores_null the first
    valid value in input order, bit for bit.  Returns the groups."""
    k, v = fcols
    kv, vv = fvalid
    uk, gid = np.unique(_spark_key(k, kv), return_inverse=True)
    g = len(uk)
    (gk, gkv), (cnt, _), (mn, mnv), (mx, mxv), (fst, fv) = (
        out[c] for c in ("k", "a0", "a1", "a2", "a3"))
    kb = gk.view(np.int64)
    if np.any((kb == np.int64(-(1 << 63))) & gkv) or \
            np.any(np.isnan(gk) & gkv & (kb != CANONICAL_NAN_BITS)):
        raise AssertionError("float keys: a key came out unnormalized")
    got_key = _spark_key(gk, gkv)
    order = np.argsort(got_key)
    if not np.array_equal(got_key[order], uk):
        raise AssertionError(f"float keys: {len(gk)} groups, numpy {g}")
    if (~gkv).sum() != 1 or (gkv & (gk == 0)).sum() != 1 or \
            (gkv & np.isnan(gk)).sum() != 1:
        raise AssertionError("float keys: want one null, one zero and one "
                             "NaN group")
    emn, emx, has = _spark_extremes(gid, g, v, vv)
    ecnt = np.bincount(gid, weights=vv, minlength=g).astype(np.int64)
    firsts = np.zeros(g, np.float64)
    rows = np.flatnonzero(vv)
    gids, at = np.unique(gid[rows], return_index=True)
    firsts[gids] = v[rows[at]]

    def same(a, b):
        return np.array_equal(np.isnan(a), np.isnan(b)) and \
            np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)])
    for got, gv, exp in ((mn, mnv, emn), (mx, mxv, emx)):
        got, gv = got[order], gv[order]
        bits = got[gv].view(np.int64)
        if not (np.array_equal(gv, has) and same(got[gv], exp[has]) and
                not np.any(bits == np.int64(-(1 << 63))) and
                np.all(bits[np.isnan(got[gv])] == CANONICAL_NAN_BITS)):
            raise AssertionError("float keys: Min or Max differs from "
                                 "Spark's order")
    if not (np.array_equal(cnt[order], ecnt) and
            np.array_equal(fv[order], has) and
            np.array_equal(fst[order][has].view(np.int64),
                           firsts[has].view(np.int64))):
        raise AssertionError("float keys: Count or first_ignores_null "
                             "differs from numpy")
    return g


def check_first_forms(fcols, fvalid, dev, card: str) -> None:
    """First and first_ignores_null on the card under both sort forms
    (the pack-sort and composed stable argsorts) equal numpy's first row
    and first valid row of each group in input order, over 2^18 rows of
    the float-key data."""
    from auron_tpu_torch.columnar.batch import bucket_capacity
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.ops import sort_keys as SK
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    n = min(1 << 18, len(fcols[0]))
    cols, valid = [c[:n] for c in fcols], [x[:n] for x in fvalid]
    plan = float_key_plans("single", ("first", "first_ignores_null"))
    uk, gid = np.unique(_spark_key(cols[0], valid[0]), return_inverse=True)
    _, first_row = np.unique(gid, return_index=True)
    rows = np.flatnonzero(valid[1])
    gids, at = np.unique(gid[rows], return_index=True)
    forms = []
    for strategy in ("radix", "argsort"):
        with conf.scoped({"auron.kernel.sort.strategy": strategy}):
            form = SK.sort_form(bucket_capacity(SCAN_BATCH), 2, dev.type)
            out = map_task(0, cols, valid, InProcessShuffleService(), dev,
                           plan, "first", "floats", 1).to_numpy()
        order = np.argsort(_spark_key(*out["k"]))
        (f, fv), (fi, fiv) = out["a0"], out["a1"]
        f, fv, fi, fiv = f[order], fv[order], fi[order], fiv[order]
        if not (np.array_equal(fv, valid[1][first_row]) and
                np.array_equal(f[fv].view(np.int64),
                               cols[1][first_row][fv].view(np.int64))):
            raise AssertionError(f"first differs from numpy as {form}")
        want = np.zeros(len(uk), bool)
        want[gids] = True
        if not (np.array_equal(fiv, want) and np.array_equal(
                fi[fiv].view(np.int64), cols[1][rows[at]].view(np.int64))):
            raise AssertionError(f"first_ignores_null differs from numpy "
                                 f"as {form}")
        forms.append(form)
    print(f"phase 13: first and first_ignores_null equal numpy's under "
          f"both sort forms ({', '.join(forms)}) over {n} rows | {card}")


def check_segments_on_card(dev, rng, card: str) -> None:
    """sorted_segment_min / max on the card equal the CPU's, bit for bit,
    for every type Min and Max reduce (every third segment empty; float64
    with NaNs of both signs, +-0.0 and +-inf)."""
    from auron_tpu_torch.ops import segments as S
    n, n_seg = 1 << 20, 3000
    used = np.arange(n_seg)[np.arange(n_seg) % 3 != 1]
    ids = torch.from_numpy(np.sort(rng.choice(used, n)))
    special = np.array(SPECIAL_F64_BITS, np.uint64).view(np.float64)
    for dt in (np.int8, np.int16, np.int32, np.int64, np.float64, np.bool_):
        if dt == np.float64:
            x = np.where(rng.random(n) < 0.01, rng.choice(special, n),
                         rng.normal(size=n))
        elif dt == np.bool_:
            x = rng.random(n) < 0.999
        else:
            info = np.iinfo(dt)
            x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        xt = torch.from_numpy(x)
        for f in (S.sorted_segment_min, S.sorted_segment_max):
            cpu = f(xt, ids, n_seg).numpy()
            card_out = f(xt.to(dev), ids.to(dev), n_seg).cpu().numpy()
            if cpu.tobytes() != card_out.tobytes():
                raise AssertionError(f"{f.__name__} over {np.dtype(dt)}: "
                                     f"the card differs from the CPU")
    print(f"phase 13: sorted_segment_min / max on the card equal the CPU's "
          f"bit for bit (int8, int16, int32, int64, float64 with NaNs and "
          f"+-0.0, bool; {n} rows, {n_seg} segments) | {card}")


# ---------------------------------------------------------------------------
# string columns: q09c and q41d whole, q01's customer exchange and its
# take-ordered, string keys at every width (phases 16 to 18)
# ---------------------------------------------------------------------------

SF10_BRANDS, SF10_CLASSES = 50, 20   # `it/datagen.py`'s i_brand, i_class
ITEM = (("i_brand", "str"), ("i_class", "str"), ("i_current_price", "f64"))
CUSTOMER = (("c_customer_sk", "i64"), ("c_customer_id", "str"))
Q01_JOIN = (("sr_customer_sk", "i64"), ("sr_store_sk", "i64"),
            ("ctr_total_return", "f64"), ("avg_store_sk", "i64"),
            ("threshold", "f64"), ("c_customer_sk", "i64"),
            ("c_customer_id", "str"))
N_CUSTOMER_MAPS = 2                  # customer's two chunks in `it/datagen.py`
STRING_KEY_ROWS = 1 << 20
STRING_KEY_VALUES = 1_000
STRING_KEY_MAX_BYTES = 40
# ASCII, NUL and characters whose UTF-8 bytes are >= 0x80
STRING_KEY_CHARS = ("a", "b", "Z", "~", "0", "\x00", "\x7f", "é", "ß", "€",
                    "日", "\U0001f600")
SPARK_HASH_SEED = 42


def q09c_plans():
    """q09c in the port's IR, as the converter lowers it
    (tests/test_torch_corpus_strings.py holds them to its JSON): (stage
    1: Projection(band CASE, price) -> partial Count, Average by band ->
    hash(4) on the band; stage 2: final -> Sort(fetch 10) -> single;
    stage 3: Sort(fetch 10) -> Projection)."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    i32, i64 = DataType.int32(), DataType.int64()
    f64, s = DataType.float64(), DataType.string()
    qty, price, band = E.col("ss_quantity"), E.col("ss_sales_price"), \
        E.col("band")

    def up_to(bound, label, otherwise):
        return E.Case(branches=(E.WhenThen(
            when=E.BinaryExpr(left=qty, op="<=",
                              right=E.Literal(value=bound, dtype=i32)),
            then=E.Literal(value=label, dtype=s)),), else_expr=otherwise)
    proj = P.Projection(
        child=P.FFIReader(schema=_schema(*STORE_SALES[1:]),
                          resource_id="store_sales"),
        exprs=(up_to(20, "1-20", up_to(60, "21-60",
                                       E.Literal(value="61-100", dtype=s))),
               price),
        names=("band", "ss_sales_price"))
    aggs = (E.AggExpr(fn="count", children=(price,), return_type=i64),
            E.AggExpr(fn="avg", children=(price,), return_type=f64))

    def agg(child, mode):
        return P.Agg(child=child, exec_mode=mode, grouping=(band,),
                     grouping_names=("band",), aggs=aggs,
                     agg_names=("cnt", "avg_price"))
    states = _schema(("band", "str"), ("cnt#count", "i64", False),
                     ("avg_price#sum", "f64"),
                     ("avg_price#count", "i64", False))
    out = _schema(("band", "str"), ("cnt", "i64"), ("avg_price", "f64"))
    return (_writer(agg(proj, "partial"), "hash", N_AGG_PARTS, (band,)),) + \
        _take_ordered(
            agg(P.IpcReader(schema=states, resource_id="shuffle_read"),
                "final"), (E.SortExpr(child=band, asc=True, nulls_first=True),),
            10, out, [f.name for f in out])


def q41d_plans():
    """q41d as the converter lowers it: (stage 1: Filter(30 <= price <=
    70) -> partial Count by (i_brand, i_class) -> hash(4) on both;
    stage 2: final -> Sort(fetch 100) -> single; stage 3: Sort(fetch
    100) -> Projection(i_brand, i_class))."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    i64, f64 = DataType.int64(), DataType.float64()
    price = E.col("i_current_price")
    names = ("i_brand", "i_class")
    keys = tuple(E.col(n) for n in names)
    aggs = (E.AggExpr(fn="count", children=(), return_type=i64),)

    def agg(child, mode):
        return P.Agg(child=child, exec_mode=mode, grouping=keys,
                     grouping_names=names, aggs=aggs, agg_names=("n",))
    banded = P.Filter(
        child=P.FFIReader(schema=_schema(*ITEM), resource_id="item"),
        predicates=(E.BinaryExpr(left=price, op=">=",
                                 right=E.Literal(value=30.0, dtype=f64)),
                    E.BinaryExpr(left=price, op="<=",
                                 right=E.Literal(value=70.0, dtype=f64))))
    states = _schema(("i_brand", "str"), ("i_class", "str"),
                     ("n#count", "i64", False))
    out = _schema(("i_brand", "str"), ("i_class", "str"), ("n", "i64"))
    order = tuple(E.SortExpr(child=k, asc=True, nulls_first=True)
                  for k in keys)
    return (_writer(agg(banded, "partial"), "hash", N_AGG_PARTS, keys),) + \
        _take_ordered(agg(P.IpcReader(schema=states,
                                      resource_id="shuffle_read"), "final"),
                      order, 100, out, names)


def q01_customer_plan():
    """The customer side of q01's sort-merge join as the converter lowers
    it: the scan straight into hash(4) by c_customer_sk."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    return _writer(P.FFIReader(schema=_schema(*CUSTOMER),
                               resource_id="customer"),
                   "hash", N_AGG_PARTS, (E.col("c_customer_sk"),))


def q01_top_plans():
    """q01's take-ordered above its sort-merge join, the join an
    FFIReader of its output rows: (Sort(fetch 100) by (c_customer_id,
    sr_store_sk, ctr_total_return DESC NULLS LAST) -> single;
    Sort(fetch 100) -> Projection(c_customer_id))."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    join = _schema(*Q01_JOIN)
    order = (E.SortExpr(child=E.col("c_customer_id"), asc=True,
                        nulls_first=True),
             E.SortExpr(child=E.col("sr_store_sk"), asc=True,
                        nulls_first=True),
             E.SortExpr(child=E.col("ctr_total_return"), asc=False,
                        nulls_first=False))
    return _take_ordered(P.FFIReader(schema=join, resource_id="join"), order,
                         100, join, ("c_customer_id",))


def string_key_plans():
    """Count and Sum of v by the string key k: map partial Agg -> hash(4)
    on k, reduce final Agg."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    i64 = DataType.int64()
    key = (E.col("k"),)
    aggs = (E.AggExpr(fn="count", children=(E.col("v"),), return_type=i64),
            E.AggExpr(fn="sum", children=(E.col("v"),), return_type=i64))

    def agg(child, mode):
        return P.Agg(child=child, exec_mode=mode, grouping=key,
                     grouping_names=("k",), aggs=aggs, agg_names=("n", "s"))
    src = P.FFIReader(schema=_schema(("k", "str"), ("v", "i64")),
                      resource_id="strings")
    states = _schema(("k", "str"), ("n#count", "i64", False), ("s#sum", "i64"))
    return (_writer(agg(src, "partial"), "hash", N_AGG_PARTS, key),
            agg(P.IpcReader(schema=states, resource_id="shuffle_read"),
                "final"))


def _objects(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def make_item(seed: int, rows: int = SF10_ITEMS):
    """SF-10 item as `it/datagen.py` draws the columns q41d reads:
    i_brand "brand#{sk % 50}", i_class "class#{sk % 20}", i_current_price
    uniform 0.5-100.0 in cents, each column with NULL_FRACTION nulls."""
    rng = np.random.default_rng([seed, 41])
    sk = np.arange(1, rows + 1)
    brands = _objects([f"brand#{i}" for i in range(SF10_BRANDS)])
    classes = _objects([f"class#{i}" for i in range(SF10_CLASSES)])
    price = np.round(rng.uniform(0.5, 100.0, rows), 2)
    return ([brands[sk % SF10_BRANDS], classes[sk % SF10_CLASSES], price],
            [rng.random(rows) >= NULL_FRACTION for _ in range(3)])


def customer_ids(sk: np.ndarray) -> np.ndarray:
    """c_customer_id of each customer key: "C" and the key in 9 digits."""
    return _objects([f"C{k:09d}" for k in sk.tolist()])


def make_customer(rows: int = SF10_CUSTOMERS):
    """SF-10 customer's join columns: c_customer_sk 1..rows and
    c_customer_id, neither null (the join key and TPC-DS's business
    key)."""
    sk = np.arange(1, rows + 1, dtype=np.int64)
    return [sk, customer_ids(sk)], [np.ones(rows, bool), np.ones(rows, bool)]


def make_q01_join(rcols, rvalid, K):
    """The rows q01's sort-merge join emits at SF 10, from phase 12's
    store_returns in numpy: the rows over their store's threshold
    (`q01_ctr`), inner-joined to customer (a null customer matches
    none).  Returns the 7 columns, all valid, in the 4 hash partitions
    of c_customer_sk and sorted by customer within each, and the
    partitions' row offsets."""
    p_cust, p_store, ctr, threshold, over = q01_ctr(rcols, rvalid)
    keep = over & (p_cust >= 0)
    c, st = p_cust[keep], p_store[keep]
    pid = K.hash_partition_ids_i64_plain(
        torch.from_numpy(c), torch.ones(len(c), dtype=torch.bool),
        N_AGG_PARTS).numpy()
    order = np.lexsort((c, pid))
    offsets = np.searchsorted(pid[order], np.arange(N_AGG_PARTS + 1))
    data = [c, st, ctr[keep], st, threshold[keep], c]
    cols = [d[order] for d in data]
    cols.append(customer_ids(cols[0]))
    return cols, [np.ones(len(c), bool)] * len(cols), offsets


def _string_key_pool(rng):
    """STRING_KEY_VALUES distinct keys of 0..STRING_KEY_MAX_BYTES UTF-8
    bytes: the edge cases (the empty string, keys apart only by a
    trailing NUL, non-ASCII first bytes), then random strings, half of
    them at most 8 bytes.  Returns (keys, whether each is <= 8 bytes)."""
    keys = ["", "ab", "ab\x00", "\x00", "\x00\x00", "é", "ÿ", "日本",
            "abcdefgh", "abcdefgh\x00", "\x80", "\U0001f600"]
    seen = set(keys)
    while len(keys) < STRING_KEY_VALUES:
        limit = 8 if len(keys) % 2 else STRING_KEY_MAX_BYTES
        s = "".join(rng.choice(STRING_KEY_CHARS, rng.integers(0, limit + 1)))
        while len(s.encode()) > limit:
            s = s[:-1]
        if s not in seen:
            seen.add(s)
            keys.append(s)
    short = np.array([len(k.encode()) <= 8 for k in keys])
    return _objects(keys), short


def make_string_keys(seed: int, n: int = STRING_KEY_ROWS):
    """n rows of (k, v): k from the key pool, v int64 in [-1000, 1000),
    each with NULL_FRACTION nulls.  Scan batch j draws only keys of at
    most 8 bytes when j is even or lies in map task 0, from every key
    otherwise, so batches of width 8 and of wider buckets alternate and
    map task 0's partial states are 8 bytes wide."""
    from auron_tpu_torch.config import conf
    rng = np.random.default_rng([seed, 18])
    keys, short = _string_key_pool(rng)
    short_ids = np.flatnonzero(short)
    bs = int(conf.get("auron.batch.size"))
    batch = np.arange(n) // bs
    narrow = (batch % 2 == 0) | (np.arange(n) < n // N_AGG_PARTS)
    kid = np.where(narrow, short_ids[rng.integers(0, len(short_ids), n)],
                   rng.integers(0, len(keys), n))
    return ([keys[kid], rng.integers(-1000, 1000, n, dtype=np.int64)],
            [rng.random(n) >= NULL_FRACTION for _ in range(2)])


def spark_hash_bytes(b: bytes, seed: int = SPARK_HASH_SEED) -> int:
    """Spark's Murmur3_x86_32.hashUnsafeBytes of b, in plain Python: the
    4-byte little-endian blocks, then each tail byte as a signed byte,
    then fmix with the length; the int32 result."""
    m32 = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & m32

    def mix(h, k):
        k = rotl((k * 0xCC9E2D51) & m32, 15) * 0x1B873593 & m32
        return (rotl(h ^ k, 13) * 5 + 0xE6546B64) & m32
    h = seed & m32
    n4 = len(b) // 4 * 4
    for i in range(0, n4, 4):
        h = mix(h, int.from_bytes(b[i:i + 4], "little"))
    for x in b[n4:]:
        h = mix(h, (x - 256 if x >= 128 else x) & m32)
    h ^= len(b)
    h = (h ^ (h >> 16)) * 0x85EBCA6B & m32
    h = (h ^ (h >> 13)) * 0xC2B2AE35 & m32
    h ^= h >> 16
    return h - (1 << 32) if h >= 1 << 31 else h


def _run_take_ordered(name, maps_fn, n_maps, plans, svc_ids, dev, K):
    """Stage 1 (n_maps tasks of maps_fn) into its exchange, then the
    take-ordered's stage 2 (one task per partition -> single) and stage
    3.  Returns (stage-3 output, launches by stage, results by stage,
    seconds by stage)."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    s1, s2, s3 = plans
    svc1, svc2 = InProcessShuffleService(), InProcessShuffleService()
    sid1, sid2 = svc_ids
    K.reset_launches()
    maps1, t1, blocks1 = run_shuffle_stage(s1, svc1, sid1, n_maps,
                                           lambda m: maps_fn(m, svc1))
    after1 = dict(K.LAUNCHES)
    maps2, t2, blocks2 = run_shuffle_stage(
        s2, svc2, sid2, len(blocks1),
        lambda p: reduce_task(s2, blocks1, 2, p, dev,
                              svc2.rss_writer(sid2, p)))
    after2 = dict(K.LAUNCHES)
    t = time.perf_counter()
    out = reduce_task(s3, blocks2, 3, 0, dev).to_numpy()
    torch.cuda.synchronize()
    t3 = time.perf_counter() - t
    if dict(K.LAUNCHES) != after2:
        raise AssertionError(f"{name} stage 3 launched a kernel")
    return out, (after1, _stage_launches(after1, after2)), (maps1, maps2), \
        (t1, t2, t3)


def run_q09c(cols, valid, dev, K, card: str):
    """Phase 16: q09c whole over the store_sales rows' (ss_quantity,
    ss_sales_price) (8 map tasks).  Returns the 3 rows, the path's
    launches and its kernel shapes."""
    def maps(m, svc):
        return map_task(m, cols, valid, svc, dev, plans[0], "q09c_agg")
    plans = q09c_plans()
    out, (l1, l2), (m1, m2), (t1, t2, t3) = _run_take_ordered(
        "q09c", maps, N_MAPS, plans, ("q09c_agg", "q09c_top"), dev, K)
    pushed1, shapes1 = check_stage("q09c stage 1", l1, m1, N_AGG_PARTS,
                                   hash_pid=False)
    pushed2, shapes2 = check_stage("q09c stage 2", l2, m2, 1, hash_pid=False)
    print(f"phase 16: q09c stage 1 (band CASE -> partial count, avg by the "
          f"string band -> hash(4)) {t1:.3f} s ({len(cols[0]) / t1:.0f} "
          f"rows/s), stage 2 (final -> sort fetch 10 -> single) {t2:.4f} s, "
          f"stage 3 {t3:.4f} s; stage 1: {pushed1} map-side batches = "
          f"{l1['radix_bucket_hist']} radix-hist (b = 2), 0 hash-pid (a "
          f"string key); stage 2: {pushed2} = {l2['radix_bucket_hist']} "
          f"radix-hist (b = 1) | {card}")
    return out, _sum_launches(l1, l2), shapes1 + shapes2


def _sum_launches(*parts):
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def check_q09c(out, cols, valid):
    """Three rows in band order, each band's Count of valid prices exact
    and its Average to relative 1e-9 against numpy; a null quantity fails
    both conditions and lands in "61-100".  Returns the counts."""
    qty, price = cols
    qv, pv = valid
    band = np.where(qv & (qty <= 20), 0, np.where(qv & (qty <= 60), 1, 2))
    cnt = np.bincount(band, weights=pv, minlength=3).astype(np.int64)
    avg = np.bincount(band, weights=np.where(pv, price, 0.0),
                      minlength=3) / cnt
    (b, bv), (c, cv), (a, avv) = (out[k] for k in ("band", "cnt",
                                                   "avg_price"))
    if list(b) != ["1-20", "21-60", "61-100"] or not (bv.all() and cv.all()
                                                     and avv.all()):
        raise AssertionError(f"q09c: bands {list(b)}, want the three")
    if not np.array_equal(c, cnt) or \
            np.any(np.abs(a - avg) > 1e-9 * np.abs(avg)):
        raise AssertionError(f"q09c: counts {c} / averages {a} differ from "
                             f"numpy {cnt} / {avg}")
    return cnt.tolist()


def run_q41d(icols, ivalid, dev, K, card: str):
    """Phase 16: q41d whole over SF-10 item (one map task)."""
    def maps(m, svc):
        return map_task(m, icols, ivalid, svc, dev, plans[0], "q41d_agg",
                        "item", 1)
    plans = q41d_plans()
    out, (l1, l2), (m1, m2), (t1, t2, t3) = _run_take_ordered(
        "q41d", maps, 1, plans, ("q41d_agg", "q41d_top"), dev, K)
    pushed1, shapes1 = check_stage("q41d stage 1", l1, m1, N_AGG_PARTS,
                                   hash_pid=False)
    pushed2, shapes2 = check_stage("q41d stage 2", l2, m2, 1, hash_pid=False)
    print(f"phase 16: q41d stage 1 (filter -> partial count by (i_brand, "
          f"i_class) -> hash(4) on both strings) {t1:.3f} s, stage 2 (4 "
          f"tasks: final -> sort fetch 100 -> single) {t2:.4f} s, stage 3 "
          f"{t3:.4f} s; {pushed1} + {pushed2} map-side batches = "
          f"{l1['radix_bucket_hist']} + {l2['radix_bucket_hist']} radix-hist, "
          f"0 hash-pid | {card}")
    return out, _sum_launches(l1, l2), shapes1 + shapes2


def check_q41d(out, icols, ivalid):
    """The first 100 (i_brand, i_class) groups of the rows with 30 <=
    price <= 70, nulls first, then by bytes, as Python sorts them.
    Returns the number of groups."""
    brand, cls, price = icols
    bv, cv, pv = ivalid
    kept = np.flatnonzero(pv & (price >= 30.0) & (price <= 70.0))
    groups = {(brand[i] if bv[i] else None, cls[i] if cv[i] else None)
              for i in kept.tolist()}

    def key(g):
        return tuple((0, b"") if v is None else (1, v.encode()) for v in g)
    exp = sorted(groups, key=key)[:100]
    (b, bvo), (c, cvo) = out["i_brand"], out["i_class"]
    got = [(x if xv else None, y if yv else None)
           for x, xv, y, yv in zip(b, bvo, c, cvo)]
    if got != exp:
        raise AssertionError(f"q41d: {len(got)} rows differ from Python's "
                             f"first 100 of {len(groups)} groups")
    return len(groups)


def check_q01_customer(blocks, ccols, K) -> list:
    """Every customer once, in partition pmod(murmur3(sk), 4) of the
    plain version, its c_customer_id intact; rows per partition as
    numpy counts them.  Returns the rows per partition."""
    sk = ccols[0]
    pid = K.hash_partition_ids_i64_plain(
        torch.from_numpy(sk), torch.ones(len(sk), dtype=torch.bool),
        N_AGG_PARTS).numpy()
    want = np.bincount(pid, minlength=N_AGG_PARTS).tolist()
    got, seen = [], []
    for p, part in enumerate(blocks):
        ks = [b.to_numpy() for b in part]
        k = np.concatenate([x[0][0] for x in ks])
        ids = np.concatenate([x[0][1] for x in ks])
        if not all(x[1][0].all() and x[1][1].all() for x in ks):
            raise AssertionError("q01 customer: a null came out")
        if np.any(pid[k - 1] != p):
            raise AssertionError(f"q01 customer: partition {p} holds a key "
                                 f"of another partition")
        if list(ids) != list(customer_ids(k)):
            raise AssertionError(f"q01 customer: partition {p} changed a "
                                 f"c_customer_id")
        got.append(len(k))
        seen.append(k)
    if got != want or not np.array_equal(np.sort(np.concatenate(seen)), sk):
        raise AssertionError(f"q01 customer: rows per partition {got}, "
                             f"numpy {want}")
    return got


def _q01_key(cols, i):
    """Spark's order of q01's take-ordered for join row i: c_customer_id
    by bytes, sr_store_sk, ctr_total_return descending (none is null)."""
    return (cols[6][i].encode(), cols[1][i], -cols[2][i])


def check_q01_top(out, blocks, jcols, offsets):
    """Each task's block holds the first 100 rows of its partition, all
    seven columns (the keys and ids exact, ctr and the threshold, which
    the engine sums in another order than numpy, to relative 1e-9), and
    the last task's c_customer_id list is the first 100 of all rows, as
    Python sorts them.  (customer, store) is unique in the join's rows,
    so the order does not rest on the float ctr."""
    import heapq
    for p, b in enumerate(blocks[0]):
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        top = heapq.nsmallest(100, range(lo, hi),
                              key=lambda i: _q01_key(jcols, i))
        vals, _ = b.to_numpy()
        for ci, (name, kind) in enumerate(Q01_JOIN):
            want = np.array([jcols[ci][i] for i in top], dtype=vals[ci].dtype)
            if len(vals[ci]) != len(want) or not (
                    np.allclose(vals[ci], want, rtol=1e-9, atol=0)
                    if kind == "f64" else list(vals[ci]) == list(want)):
                raise AssertionError(f"q01 take-ordered: task {p}'s "
                                     f"{name} differs from Python's sort")
    return check_q01_ids(out, jcols)


def check_q01_ids(out, jcols):
    """q01's result, the top 100 c_customer_id, is the first 100 of the
    join's rows as Python sorts them."""
    import heapq
    top = heapq.nsmallest(100, range(len(jcols[0])),
                          key=lambda i: _q01_key(jcols, i))
    ids, idv = out["c_customer_id"]
    if not idv.all() or list(ids) != [jcols[6][i] for i in top]:
        raise AssertionError("q01 take-ordered: the top 100 c_customer_id "
                             "differ from Python's sort")
    return ids[0], ids[-1]


def run_string_keys(scols, svalid, dev, K, card: str):
    """Phase 18: the string-key group-by (4 map tasks into hash(4) on the
    key, 4 reduce tasks).  Returns the reduce outputs per partition,
    launches and kernel shapes."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    mplan, rplan = string_key_plans()
    svc = InProcessShuffleService()
    K.reset_launches()
    maps, t1, blocks = run_shuffle_stage(
        mplan, svc, "strings", N_AGG_PARTS,
        lambda m: map_task(m, scols, svalid, svc, dev, mplan, "strings",
                           "strings", N_AGG_PARTS))
    widths = sorted({b.columns[0].width for part in blocks for b in part})
    t = time.perf_counter()
    outs = [reduce_task(rplan, blocks, 2, p, dev).to_numpy()
            for p in range(len(blocks))]
    torch.cuda.synchronize()
    t2 = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    pushed, shapes = check_stage("string keys map", launches, maps,
                                 N_AGG_PARTS, hash_pid=False)
    if len(widths) < 2:
        raise AssertionError(f"string keys: the reduce side got blocks of "
                             f"one width {widths}, want several")
    print(f"phase 18: string-key group-by of {len(scols[0])} rows: map "
          f"{t1:.3f} s, reduce {t2:.4f} s (blocks {widths} bytes wide), "
          f"{pushed} map-side batches = {launches['radix_bucket_hist']} "
          f"radix-hist (b = 2), 0 hash-pid | {card}")
    return outs, launches, shapes


def check_string_keys(outs, scols, svalid) -> int:
    """One group per key (one null group), each in partition
    pmod(Spark's hashUnsafeBytes of the key, 4) (a null key: pmod(42,
    4)), Count and Sum of the valid values exact, against Python.
    Returns the groups."""
    keys, v = scols
    kv, vv = svalid
    exp = {}
    for k, ok, x, xok in zip(keys.tolist(), kv.tolist(), v.tolist(),
                             vv.tolist()):
        n, s = exp.get(k if ok else None, (0, None))
        exp[k if ok else None] = (n + xok, (s or 0) + x if xok else s)
    got = {}
    for p, o in enumerate(outs):
        (k, kok), (n, _), (s, sok) = o["k"], o["n"], o["s"]
        for key, ok, cnt, sm, smok in zip(k.tolist(), kok.tolist(),
                                          n.tolist(), s.tolist(),
                                          sok.tolist()):
            key = key if ok else None
            h = SPARK_HASH_SEED if key is None else \
                spark_hash_bytes(key.encode())
            if h % N_AGG_PARTS != p:
                raise AssertionError(f"string keys: {key!r} in partition "
                                     f"{p}, Spark's is {h % N_AGG_PARTS}")
            if key in got:
                raise AssertionError(f"string keys: {key!r} formed two "
                                     f"groups")
            got[key] = (cnt, sm if smok else None)
    if got != exp:
        bad = [k for k in exp if got.get(k) != exp[k]]
        raise AssertionError(f"string keys: {len(got)} groups, Python "
                             f"{len(exp)}; first difference {bad[:1]!r}")
    return len(got)


# ---------------------------------------------------------------------------
# joins: q01, q17m and q39v whole (phases 13, 14 and 17), every join type
# (phase 19)
# ---------------------------------------------------------------------------

Q17M_SALES = (("ss_ticket_number", "i64"), ("ss_item_sk", "i64"),
              ("ss_store_sk", "i64"), ("ss_quantity", "i32"))
Q17M_RETURNS = (("sr_ticket_number", "i64"), ("sr_item_sk", "i64"),
                ("sr_return_amt", "f64"))
INVENTORY = (("inv_date_sk", "i64"), ("inv_item_sk", "i64"),
             ("inv_warehouse_sk", "i64"), ("inv_quantity_on_hand", "i32"))
DATE_DIM = (("d_date_sk", "i64"), ("d_moy", "i32"), ("d_year", "i32"))
SF10_DATE_DIM_ROWS = 73_049          # TPC-DS date_dim, 1900-01-02 on
DATE_DIM_FIRST_SK = 2_415_022
GRID_FIRST_SK = 2_450_815            # `it/datagen.py`'s 1998-01-01
Q39V_MONTHS = (1, 2, 3)              # the inventory snapshots scanned
N_INVENTORY_MAPS = 4
SLICE9_QUERIES = ("q13a", "q65w", "q27r", "q33b")


def _replaced(node, swap):
    """The port plan with every node `swap` maps (by its result for the
    node, None keeps it) replaced, children first (a union's inputs
    too)."""
    import dataclasses
    from auron_tpu_torch.ir import plan as P

    def child(v):
        return isinstance(v, (P.PlanNode, P.UnionInput)) or (
            isinstance(v, tuple) and v and isinstance(v[0], P.UnionInput))
    if isinstance(node, tuple):
        return tuple(_replaced(x, swap) for x in node)
    kids = {f.name: _replaced(getattr(node, f.name), swap)
            for f in dataclasses.fields(node) if child(getattr(node, f.name))}
    if kids:
        node = dataclasses.replace(node, **kids)
    new = swap(node)
    return node if new is None else new


def _ipc_renamed(plan, ids):
    """The plan with each IpcReader's resource id looked up in `ids`."""
    import dataclasses
    return _replaced(plan, lambda n: dataclasses.replace(
        n, resource_id=ids[n.resource_id])
        if n.kind == "ipc_reader" else None)


def _reader_replaced(plan, rid, subtree):
    """The plan with its FFIReader `rid` replaced by `subtree`."""
    return _replaced(plan, lambda n: subtree if n.kind == "ffi_reader"
                     and n.resource_id == rid else None)


def _sorted_by(child, names):
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    return P.Sort(child=child, sort_exprs=tuple(
        E.SortExpr(child=E.col(n), asc=True, nulls_first=True)
        for n in names))


def _smj(left, right, lkeys, rkeys):
    """The converter's sort-merge join: each side sorted by its keys,
    inner, ascending nulls first."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    return P.SortMergeJoin(
        left=_sorted_by(left, lkeys), right=_sorted_by(right, rkeys),
        on=P.JoinOn(left_keys=tuple(E.col(k) for k in lkeys),
                    right_keys=tuple(E.col(k) for k in rkeys)),
        join_type="inner", sort_options=((True, True),) * len(lkeys))


def _bhj(left, broadcast, schema, lkey, rkey, cache_id):
    """The converter's broadcast join: the right side a build-map stage
    over the broadcast's IPC reader."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    build = P.BroadcastJoinBuildHashMap(
        child=P.IpcReader(schema=schema, resource_id=broadcast),
        keys=(E.col(rkey),), cache_id=cache_id)
    return P.BroadcastJoin(
        left=left, right=build,
        on=P.JoinOn(left_keys=(E.col(lkey),), right_keys=(E.col(rkey),)),
        join_type="inner", broadcast_side="right",
        cached_build_hash_map_id=cache_id)


def join_query_plans(name: str, parts=None) -> dict:
    """The stages of q01, q17m, q39v (or, `slice9_plans`, q13a, q65w,
    q27r and q33b) whole in the port's IR, as the converter lowers them
    (tests/test_torch_corpus_joins.py holds them to its JSON), in the
    order they run: {resource id: plan}, then "root".  Ids are the converter's with the query's name for its plan
    hash ("shuffle:q01:5", "broadcast:q01:3", "bhm:q01:4"); a shuffle
    stage is its RssShuffleWriter, a broadcast stage the plan whose
    batches it collects; each scan is an FFIReader of its table."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType

    def rid(kind, n):
        return f"{kind}:{name}:{n}"
    if name == "q01":
        s1, s2, s3 = q01_plans()
        stage, top = q01_top_plans()
        ctr = _ipc_renamed(s2.child.child, {"shuffle_read": rid("shuffle", 0)})
        over = P.Filter(
            child=_bhj(ctr, rid("broadcast", 3),
                       _schema(("avg_store_sk", "i64"), ("threshold", "f64")),
                       "sr_store_sk", "avg_store_sk", rid("bhm", 4)),
            predicates=(E.BinaryExpr(left=E.col("ctr_total_return"), op=">",
                                     right=E.col("threshold")),))
        join = _smj(P.IpcReader(schema=_schema(*Q01_JOIN[:5]),
                                resource_id=rid("shuffle", 5)),
                    P.IpcReader(schema=_schema(*CUSTOMER),
                                resource_id=rid("shuffle", 6)),
                    ["sr_customer_sk"], ["c_customer_sk"])
        return {
            rid("shuffle", 0): s1, rid("shuffle", 1): s1,
            rid("shuffle", 2): _ipc_renamed(
                s2, {"shuffle_read": rid("shuffle", 1)}),
            rid("broadcast", 3): _ipc_renamed(
                s3, {"shuffle_read": rid("shuffle", 2)}),
            rid("shuffle", 5): _writer(over, "hash", N_AGG_PARTS,
                                       (E.col("sr_customer_sk"),)),
            rid("shuffle", 6): q01_customer_plan(),
            rid("shuffle", 7): _reader_replaced(stage, "join", join),
            "root": _ipc_renamed(top, {"shuffle_read": rid("shuffle", 7)})}
    if name == "q17m":
        s1, s2, s3 = q17m_plans()
        sales = ("ss_ticket_number", "ss_item_sk")
        rets = ("sr_ticket_number", "sr_item_sk")
        join = _smj(P.IpcReader(schema=_schema(*Q17M_SALES),
                                resource_id=rid("shuffle", 0)),
                    P.IpcReader(schema=_schema(*Q17M_RETURNS),
                                resource_id=rid("shuffle", 1)),
                    list(sales), list(rets))
        return {
            rid("shuffle", 0): _writer(
                P.FFIReader(schema=_schema(*Q17M_SALES),
                            resource_id="store_sales"),
                "hash", N_AGG_PARTS, tuple(E.col(k) for k in sales)),
            rid("shuffle", 1): _writer(
                P.FFIReader(schema=_schema(*Q17M_RETURNS),
                            resource_id="store_returns"),
                "hash", N_AGG_PARTS, tuple(E.col(k) for k in rets)),
            rid("shuffle", 2): _reader_replaced(s1, "join", join),
            rid("shuffle", 3): _ipc_renamed(
                s2, {"shuffle_read": rid("shuffle", 2)}),
            "root": _ipc_renamed(s3, {"shuffle_read": rid("shuffle", 3)})}
    if name in SLICE9_QUERIES:
        return slice9_plans(name, parts)
    if name != "q39v":
        raise ValueError(f"no join query {name!r}")
    i32 = DataType.int32()
    out = {}
    for moy, base in ((1, 0), (2, 4)):
        m1, m2 = q39v_plans(moy)
        bc = rid("broadcast", base)
        out[bc] = P.Filter(
            child=P.FFIReader(schema=_schema(*DATE_DIM),
                              resource_id="date_dim"),
            predicates=(E.BinaryExpr(left=E.col("d_moy"), op="==",
                                     right=E.Literal(value=moy, dtype=i32)),
                        E.BinaryExpr(left=E.col("d_year"), op="==",
                                     right=E.Literal(value=2000,
                                                     dtype=i32))))
        scan = P.FFIReader(schema=_schema(*INVENTORY),
                           resource_id="inventory")
        out[rid("shuffle", base + 2)] = _reader_replaced(
            m1, "join", _bhj(scan, bc, _schema(*DATE_DIM), "inv_date_sk",
                             "d_date_sk", rid("bhm", base + 1)))
        out[rid("shuffle", base + 3)] = _ipc_renamed(
            m2, {"shuffle_read": rid("shuffle", base + 2)})
    kept = [_schema((f"w{m}", "i64"), (f"i{m}", "i64"), (f"mean{m}", "f64"),
                    (f"sdev{m}", "f64")) for m in (1, 2)]
    join = _smj(P.IpcReader(schema=kept[0], resource_id=rid("shuffle", 3)),
                P.IpcReader(schema=kept[1], resource_id=rid("shuffle", 7)),
                ["w1", "i1"], ["w2", "i2"])
    order = tuple(E.SortExpr(child=E.col(n), asc=True, nulls_first=True)
                  for n in ("w1", "i1", "mean1", "mean2"))
    joined = _schema(*((f.name, {"INT64": "i64", "FLOAT64": "f64"}[
        f.dtype.id.name]) for s in kept for f in s))
    stage, top = _take_ordered(
        P.FFIReader(schema=joined, resource_id="join"), order, 100,
        joined, ("w1", "i1", "mean1", "sdev1", "mean2", "sdev2"))
    out[rid("shuffle", 8)] = _reader_replaced(stage, "join", join)
    out["root"] = _ipc_renamed(top, {"shuffle_read": rid("shuffle", 8)})
    return out


# ---------------------------------------------------------------------------
# TPC-DS q13a, q65w, q27r and q33b whole (phases 21 to 24)
# ---------------------------------------------------------------------------

SF10_CATALOG_SALES_ROWS = 14_401_261  # TPC-DS catalog_sales at SF 10
SF10_WEB_SALES_ROWS = 7_197_566      # TPC-DS web_sales at SF 10
N_CATALOG_MAPS = 4                   # half the store_sales splits
N_WEB_MAPS = 2                       # a quarter
STATES = ("TN", "CA", "TX", "OH", "GA", "MI", "NY", "WA", "IL", "FL")
CATEGORIES = ("Books", "Home", "Electronics", "Jewelry", "Music", "Shoes",
              "Sports", "Women", "Men", "Children")
Q13A_STATES = ("TN", "CA", "TX", "OH")
Q13A_YEAR = 2001
Q33B_YEAR_MOY = (1999, 3)
Q65W_TOP = 5
Q13A_SALES = (("ss_sold_date_sk", "i64"), ("ss_store_sk", "i64"),
              ("ss_quantity", "i32"), ("ss_sales_price", "f64"),
              ("ss_net_profit", "f64"))
Q65W_SALES = (("ss_item_sk", "i64"), ("ss_store_sk", "i64"),
              ("ss_sales_price", "f64"), ("ss_quantity", "i32"))
Q27R_SALES = (("ss_item_sk", "i64"), ("ss_store_sk", "i64"),
              ("ss_quantity", "i32"))
STORE = (("s_store_sk", "i64"), ("s_state", "str"))
ITEM_CATEGORY = (("i_item_sk", "i64"), ("i_category", "str"))
ITEM_MANUFACT = (("i_item_sk", "i64"), ("i_manufact_id", "i32"))
DATE_YEAR = (("d_date_sk", "i64"), ("d_year", "i32"))
DATE_YEAR_MOY = (("d_date_sk", "i64"), ("d_year", "i32"), ("d_moy", "i32"))
# q33b's channels: (table, column prefix)
CHANNELS = (("store_sales", "ss"), ("catalog_sales", "cs"),
            ("web_sales", "ws"))


def channel_schema(prefix: str):
    return _schema((f"{prefix}_sold_date_sk", "i64"),
                   (f"{prefix}_item_sk", "i64"),
                   (f"{prefix}_ext_sales_price", "f64"))


def _agg_of(child, mode, keys, aggs, names):
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    return P.Agg(child=child, exec_mode=mode,
                 grouping=tuple(E.col(k) for k in keys),
                 grouping_names=tuple(keys), aggs=aggs, agg_names=names)


def _states_of(key_fields, aggs, names):
    """The partial states' schema of an Agg: its keys, then per aggregate
    avg -> (#sum, #count), sum -> #sum, count -> #count (counts never
    null)."""
    fields = list(key_fields)
    for a, n in zip(aggs, names):
        t = {"FLOAT64": "f64", "INT64": "i64", "INT32": "i32"}[
            a.return_type.id.name]
        if a.fn in ("avg", "sum"):
            fields.append((f"{n}#sum", "f64" if a.fn == "avg" else t))
        if a.fn in ("avg", "count"):
            fields.append((f"{n}#count", "i64", False))
    return _schema(*fields)


def _two_phase(name, child, keys, key_fields, aggs, names, order, limit,
               start: int):
    """The converter's two-phase aggregation under a take-ordered, its
    stages under ids `start` (partial -> hash(4) on the keys) and
    `start + 1` (final -> Sort fetch -> single), then the root."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    s1, s2 = f"shuffle:{name}:{start}", f"shuffle:{name}:{start + 1}"
    partial = _writer(_agg_of(child, "partial", keys, aggs, names), "hash",
                      N_AGG_PARTS, tuple(E.col(k) for k in keys))
    final = _agg_of(P.IpcReader(schema=_states_of(key_fields, aggs, names),
                                resource_id=s1), "final", keys, aggs, names)
    out = _schema(*(tuple(key_fields) + tuple(
        (n, {"FLOAT64": "f64", "INT64": "i64"}[a.return_type.id.name])
        for a, n in zip(aggs, names))))
    stage, top = _take_ordered(final, order, limit, out, [f.name for f in out])
    return {s1: partial, s2: stage,
            "root": _ipc_renamed(top, {"shuffle_read": s2})}


def slice9_plans(name: str, parts=None) -> dict:
    """The stages of q13a, q65w, q27r or q33b whole in the port's IR, as
    the converter lowers them (tests/test_torch_corpus_new.py holds them
    to its JSON), in the order they run, ids as `join_query_plans`'.
    q33b's union takes `parts[table]` partitions of each channel's scan
    (the converter's: one a file group)."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    i32, i64, f64 = DataType.int32(), DataType.int64(), DataType.float64()
    st = DataType.string()

    def rid(kind, n):
        return f"{kind}:{name}:{n}"

    def lit(v, t):
        return E.Literal(value=v, dtype=t)

    def eq(c, v, t=i32):
        return E.BinaryExpr(left=E.col(c), op="==", right=lit(v, t))

    def scan(cols, table):
        return P.FFIReader(schema=_schema(*cols), resource_id=table)

    def asc(c):
        return E.SortExpr(child=E.col(c), asc=True, nulls_first=True)

    def fn(f, child, t):
        return E.AggExpr(fn=f, children=(child,), return_type=t)
    if name == "q13a":
        dates = P.Filter(child=scan(DATE_YEAR, "date_dim"),
                         predicates=(eq("d_year", Q13A_YEAR),))
        stores = P.Filter(child=scan(STORE, "store"), predicates=(
            E.InList(child=E.col("s_state"),
                     values=tuple(lit(x, st) for x in Q13A_STATES)),))
        join = _bhj(_bhj(scan(Q13A_SALES, "store_sales"),
                         rid("broadcast", 0), _schema(*DATE_YEAR),
                         "ss_sold_date_sk", "d_date_sk", rid("bhm", 1)),
                    rid("broadcast", 2), _schema(*STORE), "ss_store_sk",
                    "s_store_sk", rid("bhm", 3))
        aggs = (fn("avg", E.Cast(child=E.col("ss_quantity"), dtype=f64), f64),
                fn("avg", E.col("ss_sales_price"), f64),
                fn("sum", E.col("ss_net_profit"), f64))
        return {rid("broadcast", 0): dates, rid("broadcast", 2): stores,
                **_two_phase(name, join, ("s_state",), (("s_state", "str"),),
                             aggs, ("avg_q", "avg_p", "profit"),
                             (asc("s_state"),), 100, 4)}
    if name == "q65w":
        keys = ("ss_store_sk", "ss_item_sk")
        rev = (fn("sum", E.col("ss_sales_price"), f64),)
        states = _states_of((("ss_store_sk", "i64"), ("ss_item_sk", "i64")),
                            rev, ("revenue",))
        final = _agg_of(P.IpcReader(schema=states,
                                    resource_id=rid("shuffle", 0)),
                        "final", keys, rev, ("revenue",))
        window = P.Window(
            child=P.IpcReader(schema=_schema(
                ("ss_store_sk", "i64"), ("ss_item_sk", "i64"),
                ("revenue", "f64")), resource_id=rid("shuffle", 1)),
            window_funcs=(P.WindowFuncCall(fn="rank", return_type=i32,
                                           name="rk"),),
            partition_by=(E.col("ss_store_sk"),),
            order_by=(E.SortExpr(child=E.col("revenue"), asc=False,
                                 nulls_first=False), asc("ss_item_sk")))
        top5 = P.Filter(child=window, predicates=(E.BinaryExpr(
            left=E.col("rk"), op="<=", right=lit(Q65W_TOP, i32)),))
        out = _schema(("ss_store_sk", "i64"), ("ss_item_sk", "i64"),
                      ("revenue", "f64"), ("rk", "i32"))
        stage, top = _take_ordered(
            top5, (asc("ss_store_sk"), asc("rk"), asc("ss_item_sk")), 200,
            out, [f.name for f in out])
        return {
            rid("shuffle", 0): _writer(
                _agg_of(scan(Q65W_SALES, "store_sales"), "partial", keys,
                        rev, ("revenue",)),
                "hash", N_AGG_PARTS, tuple(E.col(k) for k in keys)),
            rid("shuffle", 1): _writer(final, "hash", N_AGG_PARTS,
                                       (E.col("ss_store_sk"),)),
            rid("shuffle", 2): stage,
            "root": _ipc_renamed(top, {"shuffle_read": rid("shuffle", 2)})}
    if name == "q27r":
        join = _bhj(_bhj(scan(Q27R_SALES, "store_sales"),
                         rid("broadcast", 0), _schema(*ITEM_CATEGORY),
                         "ss_item_sk", "i_item_sk", rid("bhm", 1)),
                    rid("broadcast", 2), _schema(*STORE), "ss_store_sk",
                    "s_store_sk", rid("bhm", 3))
        pre = P.Projection(child=join, exprs=(
            E.col("i_category"), E.col("s_state"),
            E.Cast(child=E.col("ss_quantity"), dtype=f64)),
            names=("i_category", "s_state", "qty"))
        cat, state, qty = E.col("i_category"), E.col("s_state"), E.col("qty")
        expand = P.Expand(
            child=pre, projections=(
                (cat, state, qty, lit(0, i64)),
                (cat, lit(None, st), qty, lit(1, i64)),
                (lit(None, st), lit(None, st), qty, lit(3, i64))),
            names=("i_category", "s_state", "qty", "spark_grouping_id"),
            types=(st, st, f64, i64))
        keys = ("i_category", "s_state", "spark_grouping_id")
        return {rid("broadcast", 0): scan(ITEM_CATEGORY, "item"),
                rid("broadcast", 2): scan(STORE, "store"),
                **_two_phase(name, expand, keys, (
                    ("i_category", "str"), ("s_state", "str"),
                    ("spark_grouping_id", "i64")),
                    (fn("avg", qty, f64), fn("count", qty, i64)),
                    ("avg_qty", "n"), (asc("spark_grouping_id"),
                                       asc("i_category"), asc("s_state")),
                    200, 4)}
    if name != "q33b":
        raise ValueError(f"no query {name!r}")
    parts = parts or {"store_sales": N_MAPS, "catalog_sales": N_CATALOG_MAPS,
                      "web_sales": N_WEB_MAPS}
    out, inputs = {}, []
    for j, (table, x) in enumerate(CHANNELS):
        out[rid("broadcast", 4 * j)] = P.Filter(
            child=scan(DATE_YEAR_MOY, "date_dim"),
            predicates=(eq("d_year", Q33B_YEAR_MOY[0]),
                        eq("d_moy", Q33B_YEAR_MOY[1])))
        out[rid("broadcast", 4 * j + 2)] = scan(ITEM_MANUFACT, "item")
        join = _bhj(_bhj(P.FFIReader(schema=channel_schema(x),
                                     resource_id=table),
                         rid("broadcast", 4 * j), _schema(*DATE_YEAR_MOY),
                         f"{x}_sold_date_sk", "d_date_sk",
                         rid("bhm", 4 * j + 1)),
                    rid("broadcast", 4 * j + 2), _schema(*ITEM_MANUFACT),
                    f"{x}_item_sk", "i_item_sk", rid("bhm", 4 * j + 3))
        proj = P.Projection(child=join, exprs=(
            E.col("i_manufact_id"), E.col(f"{x}_ext_sales_price")),
            names=("i_manufact_id", "ext_price"))
        inputs += [P.UnionInput(child=proj, partition=q,
                                out_partition=len(inputs) + q)
                   for q in range(parts[table])]
    union = P.Union(inputs=tuple(inputs), schema=_schema(
        ("i_manufact_id", "i32"), ("ext_price", "f64")),
        num_partitions=len(inputs))
    out.update(_two_phase(
        name, union, ("i_manufact_id",), (("i_manufact_id", "i32"),),
        (fn("sum", E.col("ext_price"), f64),), ("total",),
        (E.SortExpr(child=E.col("total"), asc=False, nulls_first=False),
         asc("i_manufact_id")), 100, 12))
    return out


def make_store(rows: int = SF10_STORES):
    """SF-10 store's s_store_sk 1..rows and s_state = STATES[sk % 10], as
    `it/datagen.py` sets it; neither null."""
    sk = np.arange(1, rows + 1, dtype=np.int64)
    ones = np.ones(rows, bool)
    return [sk, _objects([STATES[k % len(STATES)] for k in sk.tolist()])], \
        [ones, ones]


def make_item_dims(seed: int, rows: int = SF10_ITEMS):
    """SF-10 item's i_item_sk 1..rows with i_category =
    CATEGORIES[sk % 10] (`it/datagen.py`'s) and i_manufact_id uniform
    over 1..1000; none null.  Returns ((sk, category), (sk, manufact))
    tables."""
    rng = np.random.default_rng([seed, 33])
    sk = np.arange(1, rows + 1, dtype=np.int64)
    ones = np.ones(rows, bool)
    cat = _objects([CATEGORIES[k % len(CATEGORIES)] for k in sk.tolist()])
    manu = rng.integers(1, 1001, rows).astype(np.int32)
    return ([sk, cat], [ones, ones]), ([sk, manu], [ones, ones])


def make_ss_keys(rows: int, seed: int):
    """store_sales' ss_item_sk (uniform over the SF-10 items, never null)
    and ss_store_sk (uniform over the stores, NULL_FRACTION nulls), and
    ss_net_profit round(N(10, 40), 2) as `it/datagen.py` draws it, with
    NULL_FRACTION nulls: (item, store, store valid, profit, profit
    valid)."""
    rng = np.random.default_rng([seed, 65])
    return (rng.integers(1, SF10_ITEMS + 1, rows, dtype=np.int64),
            rng.integers(1, SF10_STORES + 1, rows, dtype=np.int64),
            rng.random(rows) >= NULL_FRACTION,
            np.round(rng.normal(10, 40, rows), 2),
            rng.random(rows) >= NULL_FRACTION)


def make_channel(rows: int, seed: int, tag: int):
    """A sales channel's sold date (uniform over the sold-date keys),
    item (uniform over the items) and ext_sales_price round(price x
    quantity, 2) (price 1..200, quantity 1..99, as `it/datagen.py`), each
    with NULL_FRACTION nulls."""
    rng = np.random.default_rng([seed, tag])
    lo, hi = SOLD_DATE_SK
    ext = np.round(np.round(rng.uniform(1.0, 200.0, rows), 2) *
                   rng.integers(1, 100, rows), 2)
    return ([rng.integers(lo, hi + 1, rows, dtype=np.int64),
             rng.integers(1, SF10_ITEMS + 1, rows, dtype=np.int64), ext],
            [rng.random(rows) >= NULL_FRACTION for _ in range(3)])


def _calendar(sk):
    """(year, month) of date keys on `make_date_dim`'s calendar."""
    day = sk - GRID_FIRST_SK
    return 1998 + day // 365, np.minimum(day % 365 // 30 + 1, 12)


def check_q13a(out, ss, ssv) -> int:
    """q13a in numpy: store_sales rows of 2001 in a store of TN, CA, TX
    or OH (a null date or store joins nothing), Average of quantity and
    sales price and Sum of net profit by s_state, in state order: keys
    exact, the rest to relative 1e-9.  Returns the groups."""
    date, store, qty, price, profit = ss
    dv, sv, qv, pv, fv = ssv
    year, _ = _calendar(date)
    state = store % len(STATES)
    keep = dv & sv & (year == Q13A_YEAR) & (state < len(Q13A_STATES))
    names = sorted(Q13A_STATES)
    exp = []
    for name in names:
        rows = keep & (state == STATES.index(name))
        exp.append((name, qty[rows & qv].mean(), price[rows & pv].mean(),
                    profit[rows & fv].sum()))
    got = list(zip(*(out[c][0].tolist() for c in ("s_state", "avg_q",
                                                    "avg_p", "profit"))))
    if [g[0] for g in got] != names or not all(
            abs(g - e) <= 1e-9 * abs(e) for gr, er in zip(got, exp)
            for g, e in zip(gr[1:], er[1:])):
        raise AssertionError(f"q13a: {got} != numpy's {exp}")
    return len(got)


def _top_rows_match(what, got_vals, exp, kth: float,
                    rel: float = 1e-9) -> None:
    """A top-k by a float sum computed in another order: each row's value
    is numpy's for its key, `exp` (relative `rel`), the values do not
    rise, and the last is no lower than numpy's k-th, so no row numpy
    ranks above it is missing (only a tie within `rel` may take another
    key)."""
    got = np.asarray(got_vals)
    if np.any(np.abs(got - exp) > rel * np.abs(exp)) or \
            np.any(np.diff(got) > rel * np.abs(got[1:])) or \
            got[-1] < kth * (1 - rel * np.sign(kth)):
        raise AssertionError(f"{what}: the top rows differ from numpy's")


def check_q65w(out, ss, ssv) -> int:
    """q65w in numpy: revenue = Sum of ss_sales_price by (store, item)
    (the null store a partition of its own, ordered first), per store the
    5 items of the highest revenue ranked 1..5 (ties by item), the first
    200 rows by (store, rank, item); revenues to relative 1e-9 and the
    ranked items numpy's up to a tie within it.  Returns the groups."""
    item, store, price = ss
    _, sv, pv = ssv
    s = np.where(sv, store, 0)
    pair, inv = np.unique(s * (SF10_ITEMS + 1) + item, return_inverse=True)
    rev = np.bincount(inv, weights=np.where(pv, price, 0.0))
    has = np.bincount(inv, weights=pv) > 0
    p_store = pair // (SF10_ITEMS + 1)
    (k, kv), (it, _), (r, rv), (rk, _) = (out[c] for c in (
        "ss_store_sk", "ss_item_sk", "revenue", "rk"))
    ks = np.where(kv, k, 0)
    stores = np.unique(p_store)[:200 // Q65W_TOP]
    if len(k) != 200 or not rv.all() or \
            not np.array_equal(ks, np.repeat(stores, Q65W_TOP)) or \
            not np.array_equal(rk, np.tile(np.arange(1, Q65W_TOP + 1),
                                           len(stores))):
        raise AssertionError("q65w: the rows are not 5 ranked items of "
                             "each of the first 40 stores")
    for j, st in enumerate(stores.tolist()):
        mine = (p_store == st) & has
        kth = np.sort(rev[mine])[-Q65W_TOP]
        sl = slice(j * Q65W_TOP, (j + 1) * Q65W_TOP)
        keys = st * (SF10_ITEMS + 1) + it[sl]
        at = np.minimum(np.searchsorted(pair, keys), len(pair) - 1)
        if not np.array_equal(pair[at], keys):
            raise AssertionError(f"q65w: store {st} has an item numpy "
                                 f"has no sale of")
        _top_rows_match(f"q65w store {st}", r[sl], rev[at], kth)
    return len(pair)


def check_q27r(out, ss, ssv) -> int:
    """q27r in numpy: Average and Count of quantity by (category, state),
    by category and overall (a null store joins nothing), ordered by
    grouping id, category and state: keys and counts exact, averages to
    relative 1e-9.  Returns the groups."""
    item, store, qty = ss
    _, sv, qv = ssv
    cat, state = item % len(CATEGORIES), store % len(STATES)
    exp = {}
    for gid, key in ((0, cat * 16 + state), (1, cat * 16 + 15),
                     (3, np.full(len(item), 255))):
        keys = np.where(sv, key, -1)
        n = np.bincount(keys[sv], weights=qv[sv], minlength=256)
        tot = np.bincount(keys[sv], weights=np.where(qv, qty, 0)[sv],
                          minlength=256)
        for g in np.flatnonzero(np.bincount(keys[sv], minlength=256)):
            c = None if g == 255 else CATEGORIES[g // 16]
            st = None if g % 16 == 15 else STATES[g % 16]
            exp[(gid, c, st)] = (int(n[g]), tot[g] / n[g])
    got = list(zip(*(out[c][0].tolist() for c in (
        "spark_grouping_id", "i_category", "s_state", "n", "avg_qty"))))
    valid = [out[c][1].tolist() for c in ("i_category", "s_state")]
    got = [(g, c if cv else None, s if stv else None, n, a)
           for (g, c, s, n, a), cv, stv in zip(got, *valid)]
    order = sorted(exp, key=lambda t: (t[0], t[1] is not None, t[1] or "",
                                       t[2] is not None, t[2] or ""))
    if [g[:3] for g in got] != order or not all(
            g[3] == exp[g[:3]][0] and
            abs(g[4] - exp[g[:3]][1]) <= 1e-9 * exp[g[:3]][1] for g in got):
        raise AssertionError(f"q27r: {len(got)} groups differ from numpy's "
                             f"{len(exp)}")
    return len(got)


def check_q33b(out, channels, manufact) -> int:
    """q33b in numpy: each channel's rows of March 1999 joined to item's
    i_manufact_id, the three channels' Sum of ext_sales_price by
    manufacturer, the top 100 by (total desc, manufacturer); totals to
    relative 1e-9, the manufacturers numpy's up to a tie within it.
    Returns the groups."""
    total = np.zeros(1001)
    seen = np.zeros(1001, bool)
    has = np.zeros(1001, bool)
    for (date, item, ext), (dv, iv, ev) in channels:
        year, moy = _calendar(date)
        keep = dv & iv & (year == Q33B_YEAR_MOY[0]) & \
            (moy == Q33B_YEAR_MOY[1])
        m = manufact[item[keep] - 1]
        total += np.bincount(m, weights=np.where(ev[keep], ext[keep], 0.0),
                             minlength=1001)
        seen |= np.bincount(m, minlength=1001) > 0
        has |= np.bincount(m, weights=ev[keep], minlength=1001) > 0
    (m, _), (t, tv) = out["i_manufact_id"], out["total"]
    groups = int(seen.sum())
    kth = np.sort(total[has])[-100]
    if len(m) != min(100, groups) or not tv.all():
        raise AssertionError(f"q33b: {len(m)} rows of {groups} groups")
    _top_rows_match("q33b", t, total[m], kth)
    return groups


def run_slice9_query(name, tables, n_maps, dev, K, card: str):
    """One of q13a, q65w, q27r and q33b whole on the card (`JoinQuery`):
    its stage report, and the query run."""
    torch.cuda.reset_peak_memory_stats()
    q = JoinQuery(name, tables, n_maps, dev, K).run()
    q.report(SLICE9_PHASES[name], card)
    return q


SLICE9_PHASES = {"q13a": 21, "q65w": 22, "q27r": 23, "q33b": 24}


@contextlib.contextmanager
def recorded_shapes(K, shapes: list):
    """Record the (kernel, rows, n_parts) of every writer-side kernel
    call into `shapes` (for phase 15): the histogram through the
    writer's `sizes_by_hist`, hash-pid through its wrapper, both called
    through unchanged, so the launch counts stay the wrappers' own."""
    from auron_tpu_torch.ops.shuffle import writer as W
    hist, pid = W.sizes_by_hist, K.hash_partition_ids_i64

    @functools.wraps(hist)
    def sizes_by_hist(pids, n_parts):
        shapes.append(("hist", int(pids.shape[0]), n_parts))
        return hist(pids, n_parts)

    @functools.wraps(pid)
    def hash_partition_ids_i64(data, validity, n_parts):
        shapes.append(("hash_pid", int(data.shape[0]), n_parts))
        return pid(data, validity, n_parts)
    W.sizes_by_hist, K.hash_partition_ids_i64 = sizes_by_hist, \
        hash_partition_ids_i64
    try:
        yield
    finally:
        W.sizes_by_hist, K.hash_partition_ids_i64 = hist, pid


def _reader_ids(plan, kind: str) -> list:
    out = []
    _replaced(plan, lambda n: out.append(n.resource_id)
              if n.kind == kind else None)
    return out


def _scan_batches(cols, valid, lo: int, hi: int):
    """The front end's scan batches of rows [lo, hi): batch-size
    slices."""
    from auron_tpu_torch.config import conf
    bs = int(conf.get("auron.batch.size"))
    return [([c[s:min(s + bs, hi)] for c in cols],
             [v[s:min(s + bs, hi)] for v in valid])
            for s in range(lo, hi, bs)]


def join_stage_task(plan, m: int, n: int, res, stage: int, dev,
                    scans=(), writer=None):
    """Task m of n of a stage through execute_task_bytes, `res` the
    stage's registry (its tasks share it: a broadcast's build table is
    cached there); each of `scans`, (table, cols, valid, k, parts), puts
    split k of the table's rows cut `parts` ways; `writer` is the
    stage's shuffle service and id."""
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    for table, cols, valid, k, parts in scans:
        rows = len(cols[0])
        res.put(table, _scan_batches(cols, valid, k * rows // parts,
                                     (k + 1) * rows // parts))
    if writer is not None:
        svc, sid = writer
        res.put("shuffle_writer", svc.rss_writer(sid, m))
    task = P.TaskDefinition(plan=plan, stage_id=stage, partition_id=m,
                            num_partitions=n)
    return execute_task_bytes(serde.serialize(task), res, device=dev)


class JoinQuery:
    """One run of q01, q17m or q39v whole on the card: its stages in
    order (`join_query_plans`), each over its scan's table split
    `n_maps[table]` ways or over the partitions of the exchange it
    reads.  Keeps, per stage id: the seconds, the task results, the
    launches, and a shuffle's blocks per partition or a broadcast's
    batches; `shapes` gets every writer-side kernel shape."""

    def __init__(self, name, tables, n_maps, dev, K):
        self.name, self.tables, self.n_maps = name, tables, n_maps
        self.dev, self.K = dev, K
        self.plans = join_query_plans(name, n_maps)
        self.secs, self.results, self.launches = {}, {}, {}
        self.blocks, self.shapes = {}, []

    def registry(self, plan, cut: int = 1):
        """A stage's registry: every exchange and broadcast it reads; with
        `cut`, only the first 1/cut of each partition's blocks."""
        from auron_tpu_torch.ops.shuffle.writer import PartitionedBlocks
        from auron_tpu_torch.runtime.resources import ResourceRegistry
        res = ResourceRegistry()
        for r in _reader_ids(plan, "ipc_reader"):
            b = self.blocks[r]
            res.put(r, PartitionedBlocks([p[:max(1, len(p) // cut)]
                                          for p in b])
                    if r.startswith("shuffle") else b)
        return res

    def tasks(self, plan):
        """(task count, task -> the scan splits it reads, as
        `join_stage_task` takes them).  A stage over a union of scans
        runs a task per union partition, which reads split `partition`
        of its input's table (cut `n_maps[table]` ways); a stage over one
        scan a task per split; any other a task per partition of the
        exchange it reads."""
        scans = list(dict.fromkeys(_reader_ids(plan, "ffi_reader")))
        unions = []
        _replaced(plan, lambda n: unions.append(n) if n.kind == "union"
                  else None)
        if unions and scans:
            [union] = unions
            assign = {}
            for inp in union.inputs:
                [table] = set(_reader_ids(inp.child, "ffi_reader"))
                assign[inp.out_partition] = (table, inp.partition)

            def split(m):
                table, k = assign[m]
                return [(table,) + self.tables[table] +
                        (k, self.n_maps[table])]
            return union.num_partitions, split
        if scans:
            [table] = scans
            n = self.n_maps[table]
            return n, lambda m: [(table,) + self.tables[table] + (m, n)]
        first = next(r for r in _reader_ids(plan, "ipc_reader")
                     if r.startswith("shuffle"))
        return len(self.blocks[first]), lambda m: []

    def run_task(self, rid, m: int, svc=None, res=None):
        """Task m of stage `rid` (into `svc` when it writes), reading
        `res` or all its inputs."""
        plan = self.plans[rid]
        n, scans = self.tasks(plan)
        return join_stage_task(plan, m, n, res or self.registry(plan),
                               list(self.plans).index(rid) + 1, self.dev,
                               scans(m), None if svc is None else (svc, rid))

    def run(self):
        from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
        K = self.K
        K.reset_launches()
        with recorded_shapes(K, self.shapes):
            for rid, plan in self.plans.items():
                before = dict(K.LAUNCHES)
                t0 = time.perf_counter()
                n, _ = self.tasks(plan)
                res = self.registry(plan)
                svc = InProcessShuffleService() \
                    if rid.startswith("shuffle") else None
                results = [self.run_task(rid, m, svc, res)
                           for m in range(n)]
                torch.cuda.synchronize()
                self.secs[rid] = time.perf_counter() - t0
                self.results[rid] = results
                launches = _stage_launches(before, dict(K.LAUNCHES))
                self.launches[rid] = launches
                if svc is not None:
                    self._check_writers(rid, plan, results, launches)
                    self.blocks[rid] = [
                        svc.reduce_blocks(rid, p)
                        for p in range(plan.partitioning.num_partitions)]
                elif any(launches.values()):
                    raise AssertionError(f"{rid} launched a kernel: "
                                         f"{launches}")
                else:
                    self.blocks[rid] = [b for r in results
                                        for b in r.batches]
        return self

    @staticmethod
    def _check_writers(rid, plan, results, launches):
        """The histogram on every writer batch, hash-pid on each too when
        the exchange hashes one int64 key."""
        from auron_tpu_torch.exprs.typing import infer_type
        from auron_tpu_torch.runtime.planner import PhysicalPlanner
        p = plan.partitioning
        pushed = sum(r.metrics.get("shuffle_write_batches", 0)
                     for r in results)
        by_hist = sum(r.metrics.get("sizes_by_hist", 0) for r in results)
        one_i64 = p.mode == "hash" and len(p.expressions) == 1 and \
            infer_type(p.expressions[0], PhysicalPlanner().create_plan(
                plan.child).schema).id.name == "INT64"
        want_pid = pushed if one_i64 else 0
        if not pushed or launches["radix_bucket_hist"] != pushed or \
                by_hist != pushed or \
                launches["hash_partition_ids_i64"] != want_pid:
            raise AssertionError(f"{rid}: {launches} for {pushed} writer "
                                 f"batches (want the histogram on each, "
                                 f"hash-pid on {want_pid})")

    def total_launches(self) -> dict:
        return {k: sum(v[k] for v in self.launches.values())
                for k in self.K.LAUNCHES}

    def rows_written(self, rid) -> int:
        return sum(r.metrics.get("shuffle_write_rows", 0)
                   for r in self.results[rid])

    def report(self, phase: int, card: str) -> None:
        for rid, secs in self.secs.items():
            la = self.launches[rid]
            print(f"phase {phase}: {rid} {len(self.results[rid])} tasks "
                  f"{secs:.3f} s, {la['hash_partition_ids_i64']} hash-pid, "
                  f"{la['radix_bucket_hist']} radix-hist launches | {card}")

    def out(self):
        return self.results["root"][0].to_numpy()


def _blocks_numpy(blocks, names) -> dict:
    """{name: (data, validity)} of a list of batches' live rows."""
    parts = [b.to_numpy() for b in blocks]
    return {n: (np.concatenate([p[0][i] for p in parts]),
                np.concatenate([p[1][i] for p in parts]))
            for i, n in enumerate(names)}


def make_q17m_tables(cols, valid, ridx, rcols, rvalid, seed: int):
    """store_sales as q17m scans it, all rows: ss_ticket_number the row
    number + 1 (never null), ss_item_sk uniform over the SF-10 items,
    ss_store_sk over the SF-10 stores with NULL_FRACTION nulls (a
    generator of its own), ss_quantity phase 3's; store_returns: each
    returned sale's ticket and item, phase 12's sr_return_amt.  Returns
    the two tables and the join's rows in numpy (one per return, in
    Q17M_JOIN's layout)."""
    rng = np.random.default_rng([seed, 17])
    rows = len(cols[0])
    ticket = np.arange(1, rows + 1, dtype=np.int64)
    item = rng.integers(1, SF10_ITEMS + 1, rows, dtype=np.int64)
    store = rng.integers(1, SF10_STORES + 1, rows, dtype=np.int64)
    store_valid = rng.random(rows) >= NULL_FRACTION
    ones = np.ones(rows, bool)
    sales = ([ticket, item, store, cols[1]],
             [ones, ones, store_valid, valid[1]])
    n = len(ridx)
    rones = np.ones(n, bool)
    returns = ([ticket[ridx], item[ridx], rcols[2]],
               [rones, rones, rvalid[2]])
    join = ([ticket[ridx], item[ridx], store[ridx], cols[1][ridx],
             ticket[ridx], item[ridx], rcols[2]],
            [rones, rones, store_valid[ridx], valid[1][ridx], rones, rones,
             rvalid[2]])
    return sales, returns, join


def check_q17m_join_rows(q: JoinQuery, n_join: int) -> int:
    """Every store group reaches the single exchange (at most 100 a
    partition), and their counts of tickets sum to the join's rows."""
    groups = _blocks_numpy(q.blocks["shuffle:q17m:3"][0],
                           ("ss_store_sk", "min_q", "max_q", "avg_r", "n"))
    got = int(groups["n"][0].sum())
    if got != n_join or len(groups["n"][0]) != SF10_STORES + 1:
        raise AssertionError(f"q17m: the join gave {got} rows in "
                             f"{len(groups['n'][0])} store groups, numpy "
                             f"{n_join} rows in {SF10_STORES + 1}")
    return got


def make_date_dim(rows: int = SF10_DATE_DIM_ROWS):
    """TPC-DS date_dim's keys and month and year: d_date_sk from
    2,415,022 on, on `it/datagen.py`'s calendar extended both ways
    (2,450,815 is 1998-01-01, years of 365 days, months of 30 with
    December the rest); none null."""
    sk = DATE_DIM_FIRST_SK + np.arange(rows, dtype=np.int64)
    day = sk - GRID_FIRST_SK
    doy, year = day % 365, 1998 + day // 365
    ones = np.ones(rows, bool)
    return ([sk, np.minimum(doy // 30 + 1, 12).astype(np.int32),
             year.astype(np.int32)], [ones, ones, ones])


def make_inventory(seed: int, items: int):
    """The inventory snapshots q39v's scan reads: those of January to
    March 2000 (`make_inventory_month`'s rows, its first four columns),
    and each month's join rows."""
    months = {m: make_inventory_month(m, seed, items) for m in Q39V_MONTHS}
    cols = [np.concatenate([months[m][0][i] for m in Q39V_MONTHS])
            for i in range(4)]
    valid = [np.concatenate([months[m][1][i] for m in Q39V_MONTHS])
             for i in range(4)]
    return (cols, valid), months


def check_q39v_top(out, kept1, kept2) -> int:
    """The root's rows are the first 100, by (w, i, mean1, mean2), of
    the two months' kept groups joined on (w, i), their values those the
    two exchanges hold.  Returns the joined groups."""
    def rows(kept, m):
        w, i, mean, sd = (kept[f"{c}{m}"][0] for c in ("w", "i", "mean",
                                                       "sdev"))
        return {(int(a), int(b)): (float(c), float(d))
                for a, b, c, d in zip(w, i, mean, sd)}
    r1, r2 = rows(kept1, 1), rows(kept2, 2)
    both = sorted((k + (r1[k][0], r2[k][0]), k) for k in r1.keys() & r2.keys())
    want = [(k[0], k[1], r1[k][0], r1[k][1], r2[k][0], r2[k][1])
            for _, k in both[:100]]
    cols = [out[c] for c in ("w1", "i1", "mean1", "sdev1", "mean2",
                             "sdev2")]
    if not all(v.all() for _, v in cols[:2]):
        raise AssertionError("q39v: a null key came out")
    got = [tuple(c[0][j].item() for c in cols) for j in range(len(cols[0][0]))]
    if [tuple(map(repr, g)) for g in got] != \
            [tuple(map(repr, w)) for w in want]:
        raise AssertionError("q39v: the top 100 differ from the two "
                             "months' kept groups joined in Python")
    return len(both)


def q01_ctr(rcols, rvalid):
    """q01 in numpy over phase 12's store_returns: ctr = Sum of
    sr_return_amt by (customer, store), each store's threshold 1.2 x its
    mean ctr.  Returns (customer, store, ctr, threshold, the rows the
    broadcast join and its filter keep); a null key is -1."""
    cust, store, amt = rcols
    cv, sv, av = rvalid
    width = SF10_STORES + 2
    pair, inv = np.unique(np.where(cv, cust, -1) * width +
                          np.where(sv, store, -1) + 1, return_inverse=True)
    ctr = np.bincount(inv, weights=np.where(av, amt, 0.0))
    has = np.bincount(inv, weights=av) > 0
    p_cust, p_store = pair // width, pair % width - 1
    stores, sinv = np.unique(p_store, return_inverse=True)
    n = np.bincount(sinv, weights=has)
    threshold = 1.2 * (np.bincount(sinv, weights=np.where(has, ctr, 0.0)) /
                       np.maximum(n, 1))[sinv]
    over = has & (p_store >= 0) & (n[sinv] > 0) & (ctr > threshold)
    return p_cust, p_store, ctr, threshold, over


# every join type (phase 19)
JOIN_SIDE_ROWS = 1 << 16
JOIN_KEYS = 1 << 12                  # ~16 rows a key on each side
JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
              "right_semi", "right_anti", "existence")
# the JAX package's broadcast legality (runtime/adaptive.py
# _BCAST_SAFE_TYPES): the side a broadcast join may build on
BROADCAST_LEFT = ("right", "right_semi", "right_anti")
JOIN_LEFT = (("lk", "i64"), ("lv", "i64"))
JOIN_RIGHT = (("rk", "i64"), ("rv", "f64"), ("rs", "str"))
# string keys (phase 19): 0-40 bytes, the left side's at most 8
STRING_JOIN_ROWS = 1 << 15
STRING_JOIN_KEYS = 1 << 12
SIDES = {"int64": (JOIN_LEFT, JOIN_RIGHT),
         "string": ((("lk", "str"),) + JOIN_LEFT[1:],
                    (("rk", "str"),) + JOIN_RIGHT[1:])}


def join_type_cases():
    """(operator, join type, build side) of every legal combination: a
    broadcast join (all but full), the shuffled hash join built on each
    side it may be, the sort-merge join streaming and whole-side."""
    out = []
    for jt in JOIN_TYPES:
        if jt != "full":
            out.append(("broadcast", jt,
                        "left" if jt in BROADCAST_LEFT else "right"))
        if jt not in ("right_semi", "right_anti"):
            out.append(("hash", jt, "right"))
        if jt not in ("left_semi", "left_anti", "existence"):
            out.append(("hash", jt, "left"))
        out += [("smj", jt, None), ("smj_whole", jt, None)]
    return out


def join_type_plan(op: str, jt: str, build: str, keys: str = "int64"):
    """A join of FFIReaders "left" and "right" on lk = rk, keys of type
    `keys` (`SIDES`)."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    ls, rs = SIDES[keys]
    left = P.FFIReader(schema=_schema(*ls), resource_id="left")
    right = P.FFIReader(schema=_schema(*rs), resource_id="right")
    on = P.JoinOn(left_keys=(E.col("lk"),), right_keys=(E.col("rk"),))
    if op == "broadcast":
        cache = "bhm:phase19:1"
        keys = on.left_keys if build == "left" else on.right_keys
        if build == "left":
            left = P.BroadcastJoinBuildHashMap(child=left, keys=keys,
                                               cache_id=cache)
        else:
            right = P.BroadcastJoinBuildHashMap(child=right, keys=keys,
                                                cache_id=cache)
        return P.BroadcastJoin(left=left, right=right, on=on, join_type=jt,
                               broadcast_side=build,
                               cached_build_hash_map_id=cache)
    if op == "hash":
        return P.HashJoin(left=left, right=right, on=on, join_type=jt,
                          build_side=build)
    return P.SortMergeJoin(left=_sorted_by(left, ["lk"]),
                           right=_sorted_by(right, ["rk"]), on=on,
                           join_type=jt, sort_options=((True, True),))


def make_join_sides(seed: int, n: int = JOIN_SIDE_ROWS):
    """Two sides of n rows on JOIN_KEYS keys, each key on ~16 rows a
    side; an eighth of each side's keys lie where the other side has
    none; NULL_FRACTION nulls in every column, a string payload on the
    right."""
    rng = np.random.default_rng([seed, 19])
    lk = rng.integers(0, JOIN_KEYS + JOIN_KEYS // 8, n, dtype=np.int64)
    rk = rng.integers(-(JOIN_KEYS // 8), JOIN_KEYS, n, dtype=np.int64)
    lv = rng.integers(-10**9, 10**9, n, dtype=np.int64)
    rv = np.round(rng.random(n) * 1000.0, 2)
    rs = customer_ids(rng.integers(1, SF10_CUSTOMERS + 1, n))
    valid = [rng.random(n) >= NULL_FRACTION for _ in range(5)]
    return ([lk, lv], valid[:2]), ([rk, rv, rs], valid[2:])


def make_string_join_sides(seed: int, n: int = STRING_JOIN_ROWS):
    """Two sides of n rows on string keys of 0-40 UTF-8 bytes (the edge
    cases of `_string_key_pool` among them): the left side's keys at
    most 8 bytes (width 8), an eighth of them on the left only; the
    right side's from every key, half of them 9-40 bytes (width 64), so
    the build and the probe side lie in different width buckets;
    NULL_FRACTION nulls in every column."""
    rng = np.random.default_rng([seed, 191])
    keys, short = _string_key_pool(rng)
    extra = STRING_JOIN_KEYS - len(keys)
    pool = list(keys) + [f"k{i}" + ("-" * (i % 2) * 30) for i in
                         range(extra)]
    pool = _objects(pool)
    is_short = np.array([len(x.encode()) <= 8 for x in pool])
    short_ids = np.flatnonzero(is_short)
    left_only = short_ids[:len(short_ids) // 8]
    both = np.setdiff1d(np.arange(len(pool)), left_only)
    lk = pool[short_ids[rng.integers(0, len(short_ids), n)]]
    rk = pool[both[rng.integers(0, len(both), n)]]
    lv = rng.integers(-10**9, 10**9, n, dtype=np.int64)
    rv = np.round(rng.random(n) * 1000.0, 2)
    rs = customer_ids(rng.integers(1, SF10_CUSTOMERS + 1, n))
    valid = [rng.random(n) >= NULL_FRACTION for _ in range(5)]
    return ([lk, lv], valid[:2]), ([rk, rv, rs], valid[2:])


def join_type_rows(jt: str, left, right) -> int:
    """The rows a join of type jt gives, counted in numpy."""
    (lk, _), (lkv, _) = left
    (rk, _, _), (rkv, _, _) = right
    keys = np.union1d(lk[lkv], rk[rkv])
    cl = np.bincount(np.searchsorted(keys, lk[lkv]), minlength=len(keys))
    cr = np.bincount(np.searchsorted(keys, rk[rkv]), minlength=len(keys))
    inner = int((cl * cr).sum())
    l_hit = int(cl[cr > 0].sum())
    r_hit = int(cr[cl > 0].sum())
    nl, nr = len(lk), len(rk)
    return {"inner": inner, "left": inner + nl - l_hit,
            "right": inner + nr - r_hit,
            "full": inner + nl - l_hit + nr - r_hit, "left_semi": l_hit,
            "left_anti": nl - l_hit, "right_semi": r_hit,
            "right_anti": nr - r_hit, "existence": nl}[jt]


def run_join_type(plan, left, right, dev, streaming: bool):
    """One join task through execute_task_bytes: (its rows on the host,
    its root metrics)."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    res = ResourceRegistry()
    for rid, (cols, valid) in (("left", left), ("right", right)):
        res.put(rid, _scan_batches(cols, valid, 0, len(cols[0])))
    with conf.scoped({"auron.smj.streaming.enable": streaming}):
        out = execute_task_bytes(serde.serialize(P.TaskDefinition(plan=plan)),
                                 res, device=dev)
    return out.to_numpy(), out.metrics


def _same_rows(a: dict, b: dict) -> bool:
    """The same columns, validities and values under them, in order."""
    return a.keys() == b.keys() and all(
        np.array_equal(a[k][1], b[k][1]) and
        list(a[k][0][a[k][1]]) == list(b[k][0][b[k][1]]) for k in a)


def check_join_types(dev, seed: int, card: str, keys: str = "int64"
                     ) -> int:
    """Phase 19: every join type through each operator on the card,
    equal row for row to the port's own run on the CPU and in count to
    numpy; the probe batches span several pair chunks; and with an empty
    build side; on int64 keys, or on string keys whose two sides lie in
    different width buckets.  Returns the cases run."""
    left, right = make_join_sides(seed) if keys == "int64" else \
        make_string_join_sides(seed)
    empty = ([c[:0] for c in right[0]], [v[:0] for v in right[1]])
    t0 = time.perf_counter()
    cases = 0
    for op, jt, build in join_type_cases():
        plan = join_type_plan(op, jt, build, keys)
        streaming = op != "smj_whole"
        runs = [(left, right)]
        if build != "left" and jt in ("inner", "left", "left_anti",
                                      "existence"):
            runs.append((left, empty))
        for lt, rt in runs:
            got, metrics = run_join_type(plan, lt, rt, dev, streaming)
            exp, _ = run_join_type(plan, lt, rt, "cpu", streaming)
            n = len(next(iter(got.values()))[0])
            want = join_type_rows(jt, lt, rt)
            if n != want or not _same_rows(got, exp):
                raise AssertionError(
                    f"phase 19: {op} {jt} (build {build}) on "
                    f"{len(rt[0][0])} build rows: {n} rows, numpy {want}, "
                    f"the CPU's {len(next(iter(exp.values()))[0])}")
            if jt == "existence":
                ex = got["exists"][0]
                if int(ex.sum()) != join_type_rows("left_semi", lt, rt):
                    raise AssertionError(f"phase 19: {op} existence flags")
            if op == "hash" and jt == "inner" and len(rt[0][0]) and \
                    metrics.get("probe_chunks", 0) <= 2 * (
                        len(lt[0][0]) // SCAN_BATCH):
                raise AssertionError("phase 19: the probe batches did not "
                                     "span several pair chunks")
            cases += 1
    print(f"phase 19: {cases} joins on {keys} keys (every join type x "
          f"broadcast, hash built left and right, sort-merge streaming and "
          f"whole-side; {len(left[0][0])} rows a side, empty build sides) "
          f"equal to the CPU's rows and numpy's counts in "
          f"{time.perf_counter() - t0:.1f} s | {card}")
    return cases


# string comparisons and the two scalar functions (phase 20)
COMPARE_COLS = (("k", "str"), ("t", "str"), ("v", "i64"), ("x", "f64"),
                ("q", "i32"))
COMPARE_OPS = ("==", "!=", "<=>", "<", "<=", ">", ">=")


def compare_plans():
    """(projection, filter) plans over the "strings" FFIReader: every
    comparison of k with t and with a literal, IN over strings with and
    without a null, NOT IN, round at scales -2, 0, 2 and 6 (q74y's
    round(x / y, 6)) over float64, int32 and int64, coalesce over a
    float (q40c's coalesce(x, 0.0)), an int and strings, nvl; and a
    FilterExec by a string order and an IN, with its projection."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    st, i32, i64, f64 = DataType.string(), DataType.int32(), \
        DataType.int64(), DataType.float64()
    k, t, v, x, q = (E.col(c) for c, _ in COMPARE_COLS)

    def lit(val, dt):
        return E.Literal(value=val, dtype=dt)

    def fn(name, *args, rt):
        return E.ScalarFunctionCall(name=name, args=args, return_type=rt)
    exprs, names = [], []
    for i, op in enumerate(COMPARE_OPS):
        for rhs, tag in ((t, "t"), (lit("ab", st), "ab"),
                         (lit("a literal wider than 8 bytes", st), "wide")):
            exprs.append(E.BinaryExpr(left=k, op=op, right=rhs))
            names.append(f"cmp{i}_{tag}")
    in_list = tuple(lit(w, st) for w in ("ab", "", "é", "ab\x00"))
    exprs += [E.InList(child=k, values=in_list),
              E.InList(child=k, values=in_list + (lit(None, st),)),
              E.InList(child=t, values=in_list, negated=True)]
    names += ["in", "in_null", "not_in"]
    for scale in (-2, 0, 2):
        for c, dt, tag in ((x, f64, "x"), (q, i32, "q"), (v, i64, "v")):
            exprs.append(fn("round", c, lit(scale, i32), rt=dt))
            names.append(f"round_{tag}{scale}")
    exprs += [fn("round", E.BinaryExpr(left=x, op="/", right=E.Cast(
                  child=q, dtype=f64)), lit(6, i32), rt=f64),
              fn("coalesce", x, lit(0.0, f64), rt=f64),
              fn("nvl", v, lit(0, i64), rt=i64),
              fn("coalesce", k, t, lit("none", st), rt=st)]
    names += ["round_ratio6", "coalesce_x", "nvl_v", "coalesce_kt"]
    scan = P.FFIReader(schema=_schema(*COMPARE_COLS), resource_id="strings")
    proj = P.Projection(child=scan, exprs=tuple(exprs), names=tuple(names))
    filt = P.Projection(
        child=P.Filter(child=scan, predicates=(
            E.BinaryExpr(left=k, op=">=", right=lit("b", st)),
            E.InList(child=t, values=in_list + (k,), negated=True))),
        exprs=(k, t, E.BinaryExpr(left=k, op="<", right=t)),
        names=("k", "t", "k_lt_t"))
    return proj, filt


def _float_ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in units of the last place of two float64
    arrays."""
    ia, ib = a.view(np.int64), b.view(np.int64)
    ia = np.where(ia < 0, np.int64(-2**63) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2**63) - ib, ib)
    return int(np.abs(ia - ib).max()) if len(a) else 0


def check_string_compare(scols, svalid, cols, valid, dev, card: str):
    """Phase 20: the comparisons, IN, round and coalesce of
    `compare_plans` over phase 18's string keys (k, and t the keys
    shifted by a row) with phase 3's price and quantity, on the card and
    on the CPU: bools, ints and strings exact, round's float64 bits
    exact or within the one ulp it prints."""
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    n = len(scols[0])
    k, v = scols
    data = [k, np.roll(k, 1), v, cols[2][:n], cols[1][:n]]
    dvalid = [svalid[0], np.roll(svalid[0], 1), svalid[1], valid[2][:n],
              valid[1][:n]]
    for plan in compare_plans():
        outs, secs = [], []
        for d in (dev, "cpu"):
            res = ResourceRegistry()
            res.put("strings", _scan_batches(data, dvalid, 0, n))
            t0 = time.perf_counter()
            out = execute_task_bytes(serde.serialize(P.TaskDefinition(
                plan=plan)), res, device=d)
            outs.append(out.to_numpy())
            secs.append(time.perf_counter() - t0)
        got, exp = outs
        floats = [c for c in got if got[c][0].dtype == np.float64]
        ulps = {c: _float_ulps(got[c][0][got[c][1]], exp[c][0][exp[c][1]])
                for c in floats
                if np.array_equal(got[c][1], exp[c][1])}
        flat = {c: got[c] for c in got if c not in floats}
        if not _same_rows(flat, {c: exp[c] for c in flat}) or \
                len(ulps) != len(floats) or any(u > 1 for u in ulps.values()):
            raise AssertionError(f"phase 20: the card's columns differ from "
                                 f"the CPU's (float ulps {ulps})")
        rows = len(next(iter(got.values()))[0])
        off = {c: u for c, u in ulps.items() if u}
        print(f"phase 20: {len(got)} columns over {n} rows ({rows} out) on "
              f"the card in {secs[0]:.3f} s equal to the CPU's ({secs[1]:.3f}"
              f" s); float64 columns off by an ulp: {off or 'none'} | "
              f"{card}")


# the window functions on the card (phase 20)
WINDOW_COLS = (("k1", "i32"), ("k2", "str"), ("o", "f64"), ("x", "f64"),
               ("i", "i64"), ("s", "str"))
WINDOW_KEYS = {"no key": (), "one key": ("k1",), "two keys": ("k1", "k2")}
WINDOW_ORDER = (("o", True, True), ("i", False, False))
# float columns summed by `index_add_`, whose order the card does not fix
WINDOW_SUMMED = ("sum_x", "avg_x")


def window_plans():
    """(what, plan) of a Window over the "window" blocks: every window
    function the port has (the ranks, percent_rank, cume_dist, lead/lag
    with and without a default, a string default among them,
    first_value, nth_value, nth_value_ignore_nulls, last_value; count,
    sum, avg, min and max over the window) with no partition key, one
    int key and two keys (int and string), each with an order (a RANGE
    frame) and without (OVER (PARTITION BY ...), OVER () with no key);
    then the group limit under each rank function."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    st, i32, i64, f64 = DataType.string(), DataType.int32(), \
        DataType.int64(), DataType.float64()
    x, i, s = E.col("x"), E.col("i"), E.col("s")

    def lit(val, dt):
        return E.Literal(value=val, dtype=dt)

    def call(fn, name, rt, *args, agg=None):
        return P.WindowFuncCall(fn=fn, args=args, agg=agg, return_type=rt,
                                name=name)

    def agg(fn, name, rt, c=None):
        return call("agg", name, rt, agg=E.AggExpr(
            fn=fn, children=(E.col(c),) if c else (), return_type=rt))
    calls = (call("row_number", "rn", i32), call("rank", "rk", i32),
             call("dense_rank", "drk", i64),
             call("percent_rank", "prk", f64), call("cume_dist", "cd", f64),
             call("lead", "lead_x", f64, x, lit(1, i32)),
             call("lead", "lead_s", st, s, lit(2, i32), lit("none", st)),
             call("lag", "lag_i", i64, i, lit(3, i32), lit(-7, i64)),
             call("lag", "lag_s", st, s, lit(1, i32)),
             call("first_value", "fv", f64, x),
             call("nth_value", "nth_i", i64, i, lit(3, i32)),
             call("nth_value_ignore_nulls", "nth_s", st, s, lit(2, i32)),
             call("last_value", "lv", st, s),
             agg("count", "cnt_x", i64, "x"), agg("count", "cnt", i64),
             agg("sum", "sum_x", f64, "x"), agg("sum", "sum_i", i64, "i"),
             agg("avg", "avg_x", f64, "x"), agg("min", "min_x", f64, "x"),
             agg("max", "max_x", f64, "x"), agg("min", "min_i", i64, "i"),
             agg("max", "max_i", i64, "i"))
    scan = P.IpcReader(schema=_schema(*WINDOW_COLS), resource_id="window")
    order = tuple(E.SortExpr(child=E.col(c), asc=a, nulls_first=nf)
                  for c, a, nf in WINDOW_ORDER)

    def window(keys, order, funcs=calls, limit=None, output=True):
        return P.Window(child=scan, window_funcs=funcs,
                        partition_by=tuple(E.col(k) for k in keys),
                        order_by=order, group_limit=limit,
                        output_window_cols=output)
    plans = [(f"{what}, {'ordered' if o else 'no order'}", window(keys, o))
             for what, keys in WINDOW_KEYS.items() for o in (order, ())]
    two = WINDOW_KEYS["two keys"]
    for fn, k, funcs in (("row_number", 3, ()), ("rank", 5, calls[1:2]),
                         ("dense_rank", 2, calls[2:3])):
        plans.append((f"two keys, top {k} by {fn}", window(
            two, order, funcs or calls[:1],
            P.WindowGroupLimit(k=k, rank_fn=fn), output=bool(funcs))))
    return plans


def _same_columns(got, exp, summed=()) -> bool:
    """Two runs' batches hold the same columns: every validity, length
    and byte under it equal, a float's bits too, but for the `summed`
    columns' values, to relative 1e-9.  Compared as tensors: the
    object arrays of `to_numpy` cost seconds a million strings."""
    from auron_tpu_torch.columnar.batch import DeviceStringColumn
    if [b.num_rows for b in got] != [b.num_rows for b in exp]:
        return False
    for gb, eb in zip(got, exp):
        for f, g, e in zip(gb.schema, gb.columns, eb.columns):
            n = gb.num_rows
            v = e.validity[:n]
            if not torch.equal(g.validity[:n].cpu(), v):
                return False
            if isinstance(e, DeviceStringColumn):
                gd, ed = g.data[:n].cpu(), e.data[:n]
                if gd.shape != ed.shape or not torch.equal(
                        g.lengths[:n].cpu()[v], e.lengths[:n][v]) or \
                        not torch.equal(gd[v], ed[v]):
                    return False
                continue
            gd, ed = g.data[:n].cpu()[v], e.data[:n][v]
            if f.name in summed:
                if not torch.allclose(gd, ed, rtol=1e-9, atol=0.0):
                    return False
            elif gd.dtype == torch.float64:
                if not torch.equal(gd.view(torch.int64),
                                   ed.view(torch.int64)):
                    return False
            elif not torch.equal(gd, ed):
                return False
    return True


def check_windows(scols, svalid, cols, valid, dev, card: str) -> None:
    """Phase 20: every plan of `window_plans` on the card and on the CPU
    over phase 18's string keys (k2, and s the keys shifted by a row),
    phase 3's quantity (k1, 100 values) and price (o, and x the prices
    shifted by 7 rows) and phase 18's ints (i): the same rows in the
    same order, ints, ranks, strings and float bits exact, the float
    sums and averages summed by `index_add_` to relative 1e-9."""
    from auron_tpu_torch.columnar.batch import from_numpy
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    n = len(scols[0])
    data = [cols[1][:n], scols[0], cols[2][:n], np.roll(cols[2][:n], 7),
            scols[1], np.roll(scols[0], 1)]
    dvalid = [valid[1][:n], svalid[0], valid[2][:n],
              np.roll(valid[2][:n], 7), svalid[1], np.roll(svalid[0], 1)]
    schema = _schema(*WINDOW_COLS)
    # the window's input as shuffle blocks on each device, made once
    blocks = [[from_numpy(schema, a, v, device=d)
               for a, v in _scan_batches(data, dvalid, 0, n)]
              for d in (dev, "cpu")]
    secs = [0.0, 0.0]
    plans = window_plans()
    for what, plan in plans:
        outs = []
        for j, d in enumerate((dev, "cpu")):
            res = ResourceRegistry()
            res.put("window", blocks[j])
            t0 = time.perf_counter()
            out = execute_task_bytes(serde.serialize(P.TaskDefinition(
                plan=plan)), res, device=d)
            if j == 0:
                torch.cuda.synchronize()
            secs[j] += time.perf_counter() - t0
            outs.append(out.batches)
        if not _same_columns(*outs, summed=WINDOW_SUMMED):
            raise AssertionError(f"phase 20: the window over {what}: the "
                                 f"card's columns differ from the CPU's")
    print(f"phase 20: {len(plans)} windows over {n} rows (no key, "
          f"one and two keys, with and without an order, the group limits; "
          f"22 functions) on the card in {secs[0]:.3f} s equal to the CPU's "
          f"({secs[1]:.3f} s) | {card}")


# ---------------------------------------------------------------------------
# Phase 27, first part: q01, q13a and q65w at SF 10 through the session
# ---------------------------------------------------------------------------

# the columns of each phase table, as the IT schema names and types them
FOREIGN_TABLES = {
    "q01": {"store_returns": (("sr_customer_sk", "i64"),
                              ("sr_store_sk", "i64"),
                              ("sr_return_amt", "f64")),
            "customer": CUSTOMER},
    "q13a": {"store_sales": Q13A_SALES, "store": STORE,
             "date_dim": DATE_YEAR},
    "q65w": {"store_sales": Q65W_SALES},
}


def same_result(what, got, exp, phase: int = 27) -> None:
    """The same rows in the same order: validity, keys, counts and
    strings exact, float columns to relative 1e-9 (another summation
    order)."""
    for name, (d, v) in exp.items():
        gd, gv = got[name]
        ok = len(gd) == len(d) and np.array_equal(gv, v)
        if ok and d.dtype.kind == "f":
            ok = np.allclose(gd[gv], d[v], rtol=1e-9, atol=0)
        elif ok:
            ok = list(gd[gv]) == list(d[v])
        if not ok:
            raise AssertionError(f"phase {phase}: {what}: column {name} "
                                 f"differs")


def run_sf10_session(queries, q01_serial, dev, K, card: str):
    """Phase 27's SF-10 part: each of `queries` ({name: (tables, n_maps,
    serial out, numpy check)}) from its foreign plan, built by the port's
    `it/queries.py` over a catalog of its phase's tables (the IT schema's
    names and types, one chunk a split, `TableEngine` serving the scans),
    through `AuronSession.execute` once: the stage path, its phase's
    serial result, numpy's check, no kernel launch.  Then q01 with the
    stage executor off, on the session's serial path: phase 17's result,
    both kernels launched, and phase 17's launches where the task counts
    are equal (`q01_serial`, (tasks, launches)).  Returns the launches of
    the stage executes and of the serial q01."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.frontend import converters as C
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.it import queries as Q
    from auron_tpu_torch.it.datagen import Catalog, TableDef, TableEngine

    def session(name):
        tables, n_maps = queries[name][:2]
        catalog = Catalog("card", {
            t: TableDef(t, _schema(*FOREIGN_TABLES[name][t]),
                        [f"{t}/part-{k:05d}"
                         for k in range(n_maps.get(t, 1))])
            for t in tables})
        return AuronSession(foreign_engine=TableEngine(catalog, tables)), \
            Q.build(name, catalog)

    def execute(name):
        s, plan = session(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = s.execute(plan, dev)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    provider = C.ScanSourceProvider()
    C.register_provider(provider)
    try:
        K.reset_launches()
        for name, (_, _, serial, check) in queries.items():
            res, secs = execute(name)
            if not res.spmd:
                raise AssertionError(f"phase 27: {name} at SF 10 off the "
                                     f"stage path ({res.spmd_rejection})")
            same_result(f"{name} at SF 10 against its phase", res.columns,
                        serial)
            print(f"phase 27: {name} at SF 10 from its foreign plan on the "
                  f"stage path {secs:.4f} s (cold), tag and convert "
                  f"{res.convert_s * 1e3:.3f} ms, {res.num_rows} rows equal "
                  f"to its phase's serial result and numpy "
                  f"({check(res.columns)}) | {card}")
        stage_launches = dict(K.LAUNCHES)
        if any(stage_launches.values()):
            raise AssertionError(f"phase 27: the SF-10 stage executes "
                                 f"launched {stage_launches}")
        K.reset_launches()
        with conf.scoped({"auron.spmd.singleDevice.enable": False,
                          "auron.trace.enable": True}):
            res, secs = execute("q01")
    finally:
        C.unregister_provider(provider)
    launches = dict(K.LAUNCHES)
    tasks = res.metrics["serial_tasks"]
    # the foreign plan converts q01's two `ctr` subtrees to two exchanges,
    # so its task count may differ from phase 17's
    if res.spmd or not all(launches.values()) or \
            (tasks == q01_serial[0] and launches != q01_serial[1]):
        raise AssertionError(f"phase 27: the serial q01 ran {tasks} tasks "
                             f"with {launches} (stage path {res.spmd}); "
                             f"phase 17: {q01_serial}")
    same_result("the serial q01 against phase 17", res.columns,
                queries["q01"][2])
    print(f"phase 27: q01 at SF 10 from its foreign plan on the session's "
          f"serial path {secs:.3f} s (traced), phase 17's result in {tasks} "
          f"tasks (phase 17: {q01_serial[0]}), "
          f"{launches['hash_partition_ids_i64']} hash-pid, "
          f"{launches['radix_bucket_hist']} radix-hist launches | {card}")
    report_serial_trace(27, "the serial q01 at SF 10", res, card)
    return stage_launches, launches


SERIAL_TRACE_FAMILIES = ("query", "plan.convert", "task.execute",
                         "shuffle.push", "shuffle.fetch.part", "op.complete")


def checked_trace(phase: int, what: str, res, families=()) -> dict:
    """The session result's trace as a Chrome-trace document: fails
    unless it was recorded, validates, was not truncated and holds
    every span family of `families`."""
    from auron_tpu_torch.runtime import tracing
    if res.trace is None:
        raise AssertionError(f"phase {phase}: {what} recorded no trace")
    doc = res.trace.to_chrome_trace()
    errors = tracing.validate_chrome_trace(doc)
    missing = set(families) - {e["name"] for e in doc["traceEvents"]}
    if errors or missing or doc["otherData"]["trace_truncated"]:
        raise AssertionError(
            f"phase {phase}: {what}'s trace: errors {errors[:3]}, missing "
            f"{sorted(missing)}, truncated "
            f"{doc['otherData']['trace_truncated']}")
    return doc


def root_output_rows(res) -> int:
    """`output_rows` of the merged tree of the query's root stage (the
    group of the last task's tree, the root stage running last)."""
    from auron_tpu_torch.runtime.explain_analyze import merge_metric_trees

    def shape(n):
        return n.name, tuple(shape(c) for c in n.children)
    last = shape(res.metric_trees[-1])
    return next(t.get("output_rows")
                for t, _ in merge_metric_trees(res.metric_trees)
                if shape(t) == last)


def report_serial_trace(phase: int, what: str, res, card: str) -> None:
    """Check a traced serial execute (checked_trace with the serial span
    families; the EXPLAIN ANALYZE root's output rows its result's rows)
    and print its trace summary and EXPLAIN ANALYZE."""
    from auron_tpu_torch.runtime import tracing
    doc = checked_trace(phase, what, res, SERIAL_TRACE_FAMILIES)
    rows = root_output_rows(res)
    if rows != res.num_rows:
        raise AssertionError(f"phase {phase}: {what}: EXPLAIN ANALYZE "
                             f"root output_rows {rows}, result "
                             f"{res.num_rows} rows")
    n_ops = sum(1 for e in doc["traceEvents"] if e["name"] == "op.complete")
    print(f"phase {phase}: {what}: valid trace of "
          f"{len(doc['traceEvents'])} events ({n_ops} op.complete), "
          f"EXPLAIN ANALYZE root output_rows {rows} = its rows; spans by "
          f"host time | {card}")
    print(tracing.summarize_chrome_trace(doc, top=10))
    print(res.explain_analyze())


# ---------------------------------------------------------------------------
# Phase 27: the whole TPC-DS corpus from its foreign plans at SF 1
# ---------------------------------------------------------------------------

CORPUS_SF, CORPUS_SEED, CORPUS_CHUNKS = 1.0, 7, 4


def corpus_line(r) -> str:
    """One query's line of phase 27."""
    path = "stage" if r.spmd else f"serial ({r.spmd_rejection})"
    if r.native_warm_s is None:     # it raised
        return f"phase 27: {r.name} FAIL: {r.error}"
    syncs = "-" if r.host_syncs is None else "/".join(map(str, r.host_syncs))
    up = "-" if r.bytes_uploaded is None else \
        "/".join(map(str, r.bytes_uploaded))
    peak = "-" if r.peak_bytes is None else f"{r.peak_bytes / 2**20:.1f}"
    warm = "/".join(f"{w:.4f}" for w in r.warm_s)
    gcs = "/".join(f"{g:.4f}" for g in r.gc_s)
    return (f"phase 27: {r.name} {'ok' if r.ok else 'FAIL'} {path}, "
            f"convert {r.convert_s * 1e3:.3f} ms, cold {r.native_s:.4f} s, "
            f"warm {r.native_warm_s:.4f} s (median of {warm}), collector "
            f"{gcs} s, syncs {syncs}, uploaded {up} "
            f"B, peak {peak} MiB, {r.rows} rows, "
            f"launches {r.launches['hash_partition_ids_i64']}/"
            f"{r.launches['radix_bucket_hist']}")


def run_corpus(dev, K, card: str):
    """Phase 27: generate SF 1, seed 7 with the port's numpy generator,
    run all 103 IT queries from their foreign plans through the port's
    `QueryRunner` on the card, cold and warm, against the committed
    expected results of the JAX package's oracle, one line a query (the
    warm time the median of three executes, and the seconds the Python
    collector ran in each timed execute); fail after the sweep if any
    query raised or differed.  Returns the runner and the sweep's kernel
    launches."""
    from auron_tpu_torch.it.datagen import generate
    from auron_tpu_torch.it.runner import QueryRunner, load_expected
    t = time.perf_counter()
    cat, tables = generate("tpcds-sf1-seed7", sf=CORPUS_SF,
                           seed=CORPUS_SEED, fact_chunks=CORPUS_CHUNKS)
    rows = sum(len(a[0]) for a, _ in tables.values())
    print(f"phase 27: SF {CORPUS_SF:g}, seed {CORPUS_SEED} generated by "
          f"the port's numpy generator: {rows} rows in {len(tables)} "
          f"tables in {time.perf_counter() - t:.2f} s (store_sales "
          f"{len(tables['store_sales'][0][0])}, inventory "
          f"{len(tables['inventory'][0][0])} rows)")
    _, expected = load_expected(CORPUS_SF, CORPUS_SEED, CORPUS_CHUNKS)
    runner = QueryRunner(cat, tables, expected, dev)
    K.reset_launches()
    t = time.perf_counter()
    runner.run_all(on_result=lambda r: print(corpus_line(r), flush=True))
    sweep_s = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    failed = [r for r in runner.results if not r.ok]
    for r in failed:
        print(f"phase 27: {r.name}: {r.error}")
        if r.trace:
            print(r.trace)
    if failed:
        raise AssertionError(f"phase 27: {len(failed)} of "
                             f"{len(runner.results)} queries failed: "
                             f"{','.join(r.name for r in failed)}")
    res = runner.results
    serial = [r.name for r in res if not r.spmd]
    print(f"phase 27: {len(res)} queries equal the oracle's results cold "
          f"and warm in {sweep_s:.1f} s ({len(res) - len(serial)} on the "
          f"stage path, serial: {','.join(serial) or 'none'}); launches "
          f"{launches} | {card}")
    for what, key, fmt in (
            ("cold", lambda r: r.native_s, "{:.4f} s"),
            ("warm (median of 3)", lambda r: r.native_warm_s, "{:.4f} s"),
            ("warm, the slowest of 3", lambda r: max(r.warm_s), "{:.4f} s"),
            ("collector in the slowest warm execute",
             lambda r: r.gc_s[1 + r.warm_s.index(max(r.warm_s))],
             "{:.4f} s"),
            ("collector, all executes", lambda r: sum(r.gc_s), "{:.4f} s"),
            ("tag and convert", lambda r: r.convert_s * 1e3, "{:.3f} ms"),
            ("host syncs, cold", lambda r: (r.host_syncs or (0,))[0], "{:d}"),
            ("uploaded cold", lambda r: (r.bytes_uploaded or (0,))[0],
             "{:d} B"),
            ("peak", lambda r: (r.peak_bytes or 0) / 2**20, "{:.1f} MiB")):
        ordered = sorted(res, key=key)
        least, most = ordered[0], ordered[-1]
        print(f"phase 27: {what}: least {fmt.format(key(least))} "
              f"({least.name}), median "
              f"{fmt.format(key(ordered[len(res) // 2]))}, most "
              f"{fmt.format(key(most))} ({most.name}), "
              f"{fmt.format(sum(map(key, res)))} in all")
    slow = max(res, key=lambda r: max(r.warm_s))
    k = slow.warm_s.index(max(slow.warm_s))
    print(f"phase 27: the slowest warm execute: {slow.name}'s "
          f"{max(slow.warm_s):.4f} s (its median {slow.native_warm_s:.4f} "
          f"s), the collector ran {slow.gc_s[1 + k]:.4f} s of it | {card}")
    return runner, launches


def profile_corpus_query(runner, dev, card: str) -> None:
    """Phase 27: where the warm execute of the query with the largest
    median warm time goes (profile_task)."""
    from auron_tpu_torch.frontend import converters as C
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.it import queries as Q
    r = max(runner.results, key=lambda r: r.native_warm_s)
    plan = Q.build(r.name, runner.catalog)
    session = AuronSession(foreign_engine=runner.engine)
    provider = C.ScanSourceProvider()
    C.register_provider(provider)
    try:
        session.execute(plan, dev)
        profile_task(f"phase 27: {r.name} warm execute (the largest median "
                     f"warm time, {r.native_warm_s:.4f} s)",
                     lambda: session.execute(plan, dev), card)
    finally:
        C.unregister_provider(provider)


# ---------------------------------------------------------------------------
# Phase 30: tracing on the card, over phase 27's SF-1 catalog
# ---------------------------------------------------------------------------

TRACED_QUERIES = ("q01", "q03", "q65w", "q75y", "q23m")
TRACED_SERIAL = ("q01", "q03", "q65w")
TRACED_RUNS = 3
WRAPPER_BATCHES = 20_000             # batches a pull of the wrapper probe


def wrapper_cost_ns(dev) -> float:
    """Host nanoseconds that `Operator.execute_with_metrics` adds to one
    batch with tracing off: the best of five pulls of WRAPPER_BATCHES
    batches of one 8-row device batch through it, less the best of five
    pulls of the same stream straight from `execute`.  The metric tree
    and the span sites cost every query this much per batch per
    operator, traced or not."""
    from auron_tpu_torch.columnar.batch import from_numpy
    from auron_tpu_torch.ops.base import Operator, TaskContext
    schema = _schema(("k", "i64"))
    b = from_numpy(schema, [np.arange(8, dtype=np.int64)], device=dev)

    class Repeat(Operator):
        def execute(self, ctx):
            for _ in range(WRAPPER_BATCHES):
                yield b

    ctx = TaskContext(device=torch.device(dev))

    def best(pull) -> int:
        times = []
        for _ in range(5):
            t0 = time.perf_counter_ns()
            for _ in pull():
                pass
            times.append(time.perf_counter_ns() - t0)
        return min(times)

    op = Repeat(schema, [])
    raw = best(lambda: op.execute(ctx))
    wrapped = best(lambda: op.execute_with_metrics(ctx))
    if op.metrics.get("output_batches") != 5 * WRAPPER_BATCHES:
        raise AssertionError(f"phase 30: the wrapper probe counted "
                             f"{op.metrics.get('output_batches')} batches")
    return (wrapped - raw) / WRAPPER_BATCHES
STAGE_TRACE_FAMILIES = ("query", "plan.convert", "spmd.execute",
                        "spmd.launch", "spmd.ingest", "spmd.run",
                        "spmd.gather")


def run_phase30(runner, dev, K, card: str,
                serial=TRACED_SERIAL) -> None:
    """Phase 30: each of TRACED_QUERIES from its foreign plan through
    `AuronSession.execute` over the corpus runner's catalog and engine:
    once to warm, then TRACED_RUNS executes untraced and TRACED_RUNS
    traced.  Fails unless each execute equals the expected results and
    the two sets have equal results, host syncs, bytes uploaded, kernel
    launches and normalized EXPLAIN ANALYZE, and every trace validates;
    prints both warm medians and their ratio.  Then the host time the
    operator wrapper adds a batch (`wrapper_cost_ns`), and each of `serial`
    with the stage executor off, traced, once: equal to the expected
    results, its trace valid; prints its wall time."""
    import statistics

    from auron_tpu_torch.config import conf
    from auron_tpu_torch.frontend import converters as C
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.it import compare
    from auron_tpu_torch.it import queries as Q
    from auron_tpu_torch.it.compare import HostTable
    from auron_tpu_torch.runtime.explain_analyze import metric_totals
    started = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def execute(session, plan, name, ordered):
        sync()
        t0 = time.perf_counter()
        res = session.execute(plan, dev)
        sync()
        secs = time.perf_counter() - t0
        diff = compare.compare_tables(HostTable.from_result(res),
                                      runner.expected[name],
                                      ordered=ordered)
        if diff is not None:
            raise AssertionError(f"phase 30: {name}: {diff}")
        return res, secs

    provider = C.ScanSourceProvider()
    C.register_provider(provider)
    try:
        for name in TRACED_QUERIES:
            plan = Q.build(name, runner.catalog)
            ordered = compare.plan_is_ordered(plan)
            session = AuronSession(foreign_engine=runner.engine)
            execute(session, plan, name, ordered)
            sets = {}
            for traced in (False, True):
                K.reset_launches()
                with conf.scoped({"auron.trace.enable": traced}):
                    runs = [execute(session, plan, name, ordered)
                            for _ in range(TRACED_RUNS)]
                sets[traced] = (runs, dict(K.LAUNCHES))
            (plain, plain_la), (traced, traced_la) = sets[False], sets[True]
            for res, _ in traced:
                checked_trace(30, name, res, STAGE_TRACE_FAMILIES
                              if res.spmd else SERIAL_TRACE_FAMILIES)
            for res, _ in plain:
                if res.trace is not None:
                    raise AssertionError(f"phase 30: {name}: a trace "
                                         f"with tracing off")

            def readings(runs):
                return [(r.spmd, r.metrics.get("host_syncs"),
                         r.metrics.get("bytes_uploaded"),
                         r.explain_analyze(normalize=True)) for r, _ in runs]
            if readings(plain) != readings(traced) or plain_la != traced_la:
                raise AssertionError(
                    f"phase 30: {name}: untraced {readings(plain)} "
                    f"launches {plain_la}, traced {readings(traced)} "
                    f"launches {traced_la}")
            for (a, _), (b, _) in zip(plain, traced):
                same_result(f"{name} traced against untraced", b.columns,
                            a.columns, phase=30)
            m0 = statistics.median(t for _, t in plain)
            m1 = statistics.median(t for _, t in traced)
            r = plain[0][0]
            print(f"phase 30: {name} {'stage' if r.spmd else 'serial'} path, "
                  f"{r.num_rows} rows, host syncs {r.metrics.get('host_syncs')}"
                  f", uploaded {r.metrics.get('bytes_uploaded')} B, launches "
                  f"{plain_la['hash_partition_ids_i64']}/"
                  f"{plain_la['radix_bucket_hist']}, equal traced and not: "
                  f"warm median untraced {m0:.6f} s "
                  f"({'/'.join(f'{t:.6f}' for _, t in plain)}), traced "
                  f"{m1:.6f} s ({'/'.join(f'{t:.6f}' for _, t in traced)}), "
                  f"ratio {m1 / m0:.4f} | {card}")
        per_batch = wrapper_cost_ns(dev)
        print(f"phase 30: execute_with_metrics adds {per_batch:.1f} ns of "
              f"host time a batch, tracing off | {card}")
        serial_s = 0.0
        for name in serial:
            plan = Q.build(name, runner.catalog)
            session = AuronSession(foreign_engine=runner.engine)
            K.reset_launches()
            with conf.scoped({"auron.spmd.singleDevice.enable": False,
                              "auron.trace.enable": True}):
                res, secs = execute(session, plan, name,
                                    compare.plan_is_ordered(plan))
            if res.spmd:
                raise AssertionError(f"phase 30: serial {name} ran on the "
                                     f"stage path")
            doc = checked_trace(30, f"serial {name}", res,
                                SERIAL_TRACE_FAMILIES)
            serial_s += secs
            batches = metric_totals(res.metric_trees)["output_batches"]
            print(f"phase 30: {name} serial (traced) {secs:.4f} s, "
                  f"{res.metrics['serial_tasks']} tasks, {res.num_rows} rows "
                  f"equal to the expected results, valid trace of "
                  f"{len(doc['traceEvents'])} events, launches "
                  f"{K.LAUNCHES['hash_partition_ids_i64']}/"
                  f"{K.LAUNCHES['radix_bucket_hist']}; {batches} operator "
                  f"batches, so the wrapper's share "
                  f"{batches * per_batch / 1e9:.6f} s | {card}")
    finally:
        C.unregister_provider(provider)
    print(f"phase 30: serial runs {serial_s:.2f} s; phase 30 "
          f"{time.perf_counter() - started:.1f} s | {card}")


# ---------------------------------------------------------------------------
# Phase 31: the task pipeline (verify -> fuse -> build) on the serial path
# ---------------------------------------------------------------------------

# q01, q03, q65w and q96 hold no chain of two row-local operators; q27r's
# partial aggregations sit over expand <- projection fragments, q74y's
# exchanges over projection <- filter ones, their ids fused
FUSION_QUERIES = ("q01", "q03", "q65w", "q96", "q27r", "q74y")


def _metric_nodes(root):
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(node.children)


def fusion_readings(res) -> dict:
    """What fusion did in one serial execute, over its task trees: the
    fragment operators, the operators they fused, the batches whose
    partition ids a fragment computed, and the fragments an aggregation
    took in as its prologue."""
    out = {"fragments": 0, "ops_fused": 0, "pid_fused_batches": 0,
           "prologues": 0}
    for tree in res.metric_trees:
        for n in _metric_nodes(tree):
            if n.name == "FusedFragmentExec":
                out["fragments"] += 1
                out["ops_fused"] += n.get("ops_fused")
                out["prologues"] += n.get("fused_into_parent")
            elif n.name == "RssShuffleWriterExec":
                out["pid_fused_batches"] += n.get("pid_fused_batches")
    return out


@contextlib.contextmanager
def counted_syncs(cuda: bool):
    """Count the host's waits on the card inside the block: every
    synchronizing CUDA call (a read back of a count, `nonzero`, `.item`,
    a device-to-host copy) raises a warning under
    `torch.cuda.set_sync_debug_mode("warn")`; the block's list holds one
    entry a wait (none without a card)."""
    import warnings
    waits: list = []
    if not cuda:
        yield waits
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield waits
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits.extend(w for w in caught
                 if "synchroniz" in str(w.message).lower())


def _span_s(doc, name: str) -> float:
    """Seconds of host time in the trace's spans of one name."""
    return sum(e.get("dur", 0.0) for e in doc["traceEvents"]
               if e["name"] == name and e.get("ph") == "X") / 1e6


def run_phase31(runner, cols, valid, dev, K, card: str) -> dict:
    """Phase 31: (a) each of FUSION_QUERIES from its foreign plan through
    `AuronSession.execute` on the serial path (the stage executor off)
    over phase 27's SF-1 catalog, with the verifier on and fusion off,
    then on: once traced with the syncs counted (`counted_syncs`; the
    verifier's and the fusion pass's host time from the `plan.verify`
    and `plan.fuse` spans), then timed untraced in turns (off, on, on,
    off); every execute equal to the expected results, and fused equal
    to unfused; prints what fusion did (fragments, operators fused,
    pid-fused batches, prologues), each kernel's launches, the syncs and
    the walls.  (b) the partial-
    aggregation prologue at SF 10: phase 3's first map split through
    Filter -> Projection -> partial Agg -> hash exchange by customer,
    fused (the aggregation takes the fragment in) and unfused, equal
    blocks (keys and counts exact, sums to 1e-9) and launches.  Returns
    the launches of every run, by its name."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.frontend import converters as C
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.it import compare
    from auron_tpu_torch.it import queries as Q
    from auron_tpu_torch.it.compare import HostTable
    started = time.perf_counter()
    all_launches = {}
    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def execute(plan, name, ordered, fuse, traced):
        session = AuronSession(foreign_engine=runner.engine)
        with conf.scoped({"auron.spmd.singleDevice.enable": False,
                          "auron.plan.verify": True,
                          "auron.fuse.enable": fuse,
                          "auron.trace.enable": traced}):
            sync()
            t0 = time.perf_counter()
            res = session.execute(plan, dev)
            sync()
            secs = time.perf_counter() - t0
        if res.spmd:
            raise AssertionError(f"phase 31: {name} ran on the stage path")
        diff = compare.compare_tables(HostTable.from_result(res),
                                      runner.expected[name],
                                      ordered=ordered)
        if diff is not None:
            raise AssertionError(f"phase 31: {name} fuse={fuse}: {diff}")
        return res, secs

    provider = C.ScanSourceProvider()
    C.register_provider(provider)
    try:
        for name in FUSION_QUERIES:
            plan = Q.build(name, runner.catalog)
            ordered = compare.plan_is_ordered(plan)
            seen, walls = {}, {False: [], True: []}
            for fuse in (False, True):
                with counted_syncs(cuda) as waits:
                    traced, _ = execute(plan, name, ordered, fuse, True)
                doc = checked_trace(31, name, traced, SERIAL_TRACE_FAMILIES)
                seen[fuse] = (traced, len(waits),
                              _span_s(doc, "plan.verify"),
                              _span_s(doc, "plan.fuse"),
                              fusion_readings(traced))
            launches = {}
            for fuse in (False, True, True, False):    # in turns
                K.reset_launches()
                res, secs = execute(plan, name, ordered, fuse, False)
                walls[fuse].append(secs)
                if launches.setdefault(fuse, dict(K.LAUNCHES)) != \
                        K.LAUNCHES:
                    raise AssertionError(f"phase 31: {name}: launches "
                                         f"{K.LAUNCHES} after "
                                         f"{launches[fuse]}")
                same_result(f"{name} fused={fuse} against the traced "
                            f"unfused run", res.columns,
                            seen[False][0].columns, phase=31)
            for fuse, tag in ((False, "unfused"), (True, "fused")):
                all_launches[f"{name}_{tag}"] = launches[fuse]
            (off, off_sy, off_v, _, off_f) = seen[False]
            (on, on_sy, on_v, on_fuse_s, on_f) = seen[True]
            off_la, on_la = launches[False], launches[True]
            same_result(f"{name} fused against unfused", on.columns,
                        off.columns, phase=31)
            if off_f["fragments"]:
                raise AssertionError(f"phase 31: {name} unfused ran "
                                     f"fragments {off_f}")
            if on_la["hash_partition_ids_i64"] != \
                    off_la["hash_partition_ids_i64"]:
                raise AssertionError(f"phase 31: {name}: hash-pid "
                                     f"launches {on_la} fused, {off_la} "
                                     f"unfused")

            def fmt(ts):
                return "/".join(f"{t:.4f}" for t in ts)
            print(f"phase 31: {name} serial, verified, "
                  f"{on.num_rows} rows equal fused and unfused and to the "
                  f"expected results; fused: {on_f['fragments']} fragment "
                  f"operators, {on_f['ops_fused']} operators fused, "
                  f"{on_f['pid_fused_batches']} pid-fused batches, "
                  f"{on_f['prologues']} prologue-fused aggregations; "
                  f"launches hash-pid/radix-hist "
                  f"{on_la['hash_partition_ids_i64']}/"
                  f"{on_la['radix_bucket_hist']} fused, "
                  f"{off_la['hash_partition_ids_i64']}/"
                  f"{off_la['radix_bucket_hist']} unfused; host syncs "
                  f"{on_sy} fused, {off_sy} unfused; wall {fmt(walls[True])} "
                  f"s fused, {fmt(walls[False])} s unfused (off, on, on, "
                  f"off); verifier host time {on_v * 1e3:.3f} ms fused, "
                  f"{off_v * 1e3:.3f} ms unfused; fusion pass "
                  f"{on_fuse_s * 1e3:.3f} ms | {card}")
    finally:
        C.unregister_provider(provider)
    all_launches.update(run_prologue_task(cols, valid, dev, K, card))
    print(f"phase 31: {time.perf_counter() - started:.1f} s | {card}")
    return all_launches


def prologue_plan():
    """Phase 31 (b)'s map task: store_sales rows with ss_quantity > 50,
    key and quantity x price, partial Sum and Count by customer, hash
    exchange by customer."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType
    f64, i64 = DataType.float64(), DataType.int64()
    key = (E.col("ss_customer_sk"),)
    proj = P.Projection(
        child=P.Filter(
            child=P.FFIReader(schema=_schema(*STORE_SALES),
                              resource_id="store_sales"),
            predicates=(E.BinaryExpr(
                left=E.col("ss_quantity"), op=">",
                right=E.Literal(value=50, dtype=DataType.int32())),)),
        exprs=(E.col("ss_customer_sk"),
               E.BinaryExpr(left=E.Cast(child=E.col("ss_quantity"),
                                        dtype=f64),
                            op="*", right=E.col("ss_sales_price"))),
        names=("ss_customer_sk", "sales"))
    aggs = (E.AggExpr(fn="sum", children=(E.col("sales"),), return_type=f64),
            E.AggExpr(fn="count", children=(E.col("sales"),),
                      return_type=i64))
    return _writer(P.Agg(child=proj, exec_mode="partial", grouping=key,
                         grouping_names=("ss_customer_sk",), aggs=aggs,
                         agg_names=("sum_sales", "cnt_sales")),
                   "hash", N_REDUCE, key)


def run_prologue_task(cols, valid, dev, K, card: str) -> dict:
    """Phase 31 (b): the prologue map task, fused and unfused."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    names = ("ss_customer_sk", "sum_sales#sum", "cnt_sales#count")
    plan = prologue_plan()
    out, launches, walls = {}, {}, {False: [], True: []}
    cuda = torch.device(dev).type == "cuda"
    for fuse in (False, True, True, False):         # in turns
        svc = InProcessShuffleService()
        with conf.scoped({"auron.fuse.enable": fuse}):
            K.reset_launches()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = map_task(0, cols, valid, svc, dev, plan, "prologue")
            if cuda:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches[f"prologue_{'fused' if fuse else 'unfused'}"] = \
            dict(K.LAUNCHES)
        frag = [m for n, m in res.operator_metrics
                if n == "FusedFragmentExec"]
        if (fuse and (len(frag) != 1 or frag[0].get("fused_into_parent") != 1
                      or frag[0].get("output_batches"))) or \
                (not fuse and frag):
            raise AssertionError(f"phase 31: prologue fuse={fuse}: "
                                 f"fragments {[dict(m) for m in frag]}")
        groups = {}
        for p in range(N_REDUCE):
            blocks = svc.reduce_blocks("prologue", p)
            if not blocks:
                continue
            rows = _blocks_numpy(blocks, names)
            for i, k in enumerate(rows[names[0]][0].tolist()):
                key = k if rows[names[0]][1][i] else None
                groups[(p, key)] = (
                    rows[names[1]][0][i] if rows[names[1]][1][i] else None,
                    int(rows[names[2]][0][i]))
        walls[fuse].append(secs)
        out[fuse] = (groups, res.metrics.get("shuffle_write_batches"))
    (g0, b0), (g1, b1) = out[False], out[True]
    if set(g0) != set(g1) or b0 != b1 or any(
            g0[k][1] != g1[k][1] or (g0[k][0] is None) != (g1[k][0] is None)
            or (g0[k][0] is not None and
                abs(g0[k][0] - g1[k][0]) > 1e-9 * abs(g0[k][0]))
            for k in g0):
        raise AssertionError("phase 31: the prologue's blocks differ from "
                             "the unfused task's")
    la0, la1 = launches["prologue_unfused"], launches["prologue_fused"]
    # one of each kernel a writer batch, on the card (the CPU runs the
    # plain versions)
    if la0 != la1 or (cuda and (la1["hash_partition_ids_i64"] != b1 or
                                la1["radix_bucket_hist"] != b1)):
        raise AssertionError(f"phase 31: prologue launches {la1} fused, "
                             f"{la0} unfused, {b1} writer batches")
    print(f"phase 31: the prologue at SF 10 (map split 0, "
          f"{len(cols[0]) // N_MAPS} rows): {len(g1)} (partition, customer) "
          f"groups equal fused and unfused, {b1} writer batches, launches "
          f"hash-pid/radix-hist {la1['hash_partition_ids_i64']}/"
          f"{la1['radix_bucket_hist']} both ways; wall "
          f"{'/'.join(f'{t:.4f}' for t in walls[True])} s fused (the "
          f"aggregation's prologue), "
          f"{'/'.join(f'{t:.4f}' for t in walls[False])} s unfused (off, "
          f"on, on, off) | {card}")
    return launches


# ---------------------------------------------------------------------------
# Phase 28: serial SF-10 tasks under a memory budget
# ---------------------------------------------------------------------------

SPILL_BUDGET = 32 << 20              # the phase's memory budget, bytes
SPILL_TRIGGER = 4 << 20              # its auron.memory.spill.min.trigger
GIANT_BUILD_ROWS = 1 << 20           # the giant-group join's build side
GIANT_GROUP_ROWS = 1 << 19           # of them under one key
GIANT_PROBE_ROWS = 1 << 15           # its probe side
GIANT_PROBE_HITS = 8                 # of them on that key
GIANT_WINDOW_CAP = 1 << 16           # auron.smj.window.max.rows
GIANT_PAYLOADS = 7                   # int64 payloads a build row


def no_spills(phases: str, card: str) -> None:
    """Print the memory manager's spills and pool peak over `phases`,
    which run under the default budget, and fail if one spilled; a
    fresh manager then counts the next phases."""
    from auron_tpu_torch.memmgr import manager as M
    mgr = M.get_manager()
    print(f"phase{'s' if '-' in phases else ''} {phases}: "
          f"{mgr.num_spills} spills under the default "
          f"budget ({mgr.budget} bytes), pool peak {mgr.peak_used} bytes "
          f"| {card}")
    if mgr.num_spills:
        raise AssertionError(f"phases {phases} spilled under the default "
                             f"budget: {mgr.spill_records()[:3]}")
    M.reset_manager()


def _concat_columns(batches, schema):
    """Every column's live rows concatenated on the device, as
    (data, validity) pairs (string columns padded to one width)."""
    from auron_tpu_torch.columnar.batch import concat_batches
    b = concat_batches(schema, batches)
    n = b.num_rows
    out = []
    for c in b.columns:
        out.append((c.data[:n], c.validity[:n]))
        if c.data.dim() == 2:
            out.append((c.lengths[:n], c.validity[:n]))
    return out


def _same_tensors(what, got, exp, float_cols=()) -> None:
    for i, ((gd, gv), (ed, ev)) in enumerate(zip(got, exp)):
        ok = gd.shape == ed.shape and torch.equal(gv, ev)
        if ok and i in float_cols:
            ok = bool(torch.all(torch.isclose(gd, ed, rtol=1e-9, atol=0) |
                                (gd == ed)))
        elif ok:
            ok = torch.equal(gd, ed)
        if not ok:
            raise AssertionError(f"phase 28: {what}: column {i} differs "
                                 f"from the unbudgeted run")


def _spill_run(label, run, K, card: str, budgeted: bool,
               traced: bool = False):
    """One run of a spill-phase task: under the phase's budget or the
    default one, traced or not.  Prints wall time, spills, spilled
    bytes, the tier, the manager's pool peak and the device peak;
    returns (result, manager, launches, the trace's document or
    None)."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.memmgr import manager as M
    from auron_tpu_torch.runtime import tracing
    kv = {"auron.memory.budget.bytes": SPILL_BUDGET,
          "auron.memory.spill.min.trigger.bytes": SPILL_TRIGGER} \
        if budgeted else {}
    scope = tracing.trace_scope(recorder=tracing.TraceRecorder(
        "phase-28")) if traced else contextlib.nullcontext()
    with conf.scoped(kv), scope:
        mgr = M.reset_manager()
        K.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    res = out[0] if isinstance(out, tuple) else out
    tiers = {t: res.summed(f"mem_spill_{t}") for t in ("host", "file")}
    by = {n: t["spills"] for n, t in mgr.consumer_totals().items()
          if t["spills"]}
    under = f"under a {SPILL_BUDGET}-byte budget" if budgeted else \
        "under the default budget"
    print(f"phase 28: {label} {under}: "
          f"{secs:.3f} s, {mgr.num_spills} spills by the manager {by}, "
          f"{res.summed('mem_spill_count')} spill writes of "
          f"{res.summed('mem_spill_size')} bytes (tiers {tiers}), pool "
          f"peak {mgr.peak_used} bytes, device peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB | {card}")
    M.reset_manager()
    doc = scope.recorder.to_chrome_trace() if traced else None
    return out, mgr, dict(K.LAUNCHES), doc


def check_spill_trace(label, doc, mgr, res, card: str) -> None:
    """A traced budgeted run: the trace validates, holds one `mem.spill`
    event for each spill the memory manager arbitrated and one
    `spill.write` span for each spill the task's operators wrote
    (`mem_spill_count`), each naming a tier the task counted."""
    from auron_tpu_torch.runtime import tracing
    errors = tracing.validate_chrome_trace(doc)
    events = [e for e in doc["traceEvents"] if e["name"] == "mem.spill"]
    writes = [e for e in doc["traceEvents"] if e["name"] == "spill.write"]
    tiers = {t for t in ("host", "file") if res.summed(f"mem_spill_{t}")}
    named = {e["args"]["tier"] for e in writes}
    count = res.summed("mem_spill_count")
    if errors or doc["otherData"]["trace_truncated"] or \
            len(events) != mgr.num_spills or len(writes) != count or \
            named != tiers:
        raise AssertionError(
            f"phase 28: {label}: {len(events)} mem.spill events for "
            f"{mgr.num_spills} manager spills, {len(writes)} spill.write "
            f"spans (tiers {named}) for mem_spill_count {count} (tiers "
            f"{tiers}), trace errors {errors[:3]}")
    print(f"phase 28: {label} traced: {len(events)} mem.spill events = "
          f"the manager's {mgr.num_spills} spills, {len(writes)} "
          f"spill.write spans to the {', '.join(sorted(named))} tier = "
          f"the task's mem_spill_count {count} | {card}")


def giant_group_sides(seed: int):
    """The giant-group join's sides, key-sorted (int64 keys, no nulls):
    the build side GIANT_BUILD_ROWS rows, GIANT_GROUP_ROWS of them under
    one key, with a row id and GIANT_PAYLOADS - 1 more int64 payloads;
    the probe side GIANT_PROBE_ROWS rows, GIANT_PROBE_HITS of them on
    that key, with a row id."""
    rng = np.random.default_rng([seed, 28])
    span = 1 << 24
    key = span // 2
    other = rng.integers(0, span, GIANT_BUILD_ROWS - GIANT_GROUP_ROWS)
    other[other == key] += 1
    bk = np.sort(np.concatenate([other, np.full(GIANT_GROUP_ROWS, key)]))
    build = [bk.astype(np.int64), np.arange(GIANT_BUILD_ROWS,
                                            dtype=np.int64)] + \
        [rng.integers(-2**62, 2**62, GIANT_BUILD_ROWS)
         for _ in range(GIANT_PAYLOADS - 1)]
    pother = rng.integers(0, span, GIANT_PROBE_ROWS - GIANT_PROBE_HITS)
    pother[pother == key] += 1
    pk = np.sort(np.concatenate([pother, np.full(GIANT_PROBE_HITS, key)]))
    probe = [pk.astype(np.int64), np.arange(GIANT_PROBE_ROWS,
                                            dtype=np.int64)]
    return build, probe


def giant_group_plan():
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    build = _schema(("bk", "i64"), ("bid", "i64"),
                    *((f"b{j}", "i64") for j in range(GIANT_PAYLOADS - 1)))
    probe = _schema(("pk", "i64"), ("pid", "i64"))
    return P.SortMergeJoin(
        left=P.FFIReader(schema=probe, resource_id="probe"),
        right=P.FFIReader(schema=build, resource_id="build"),
        on=P.JoinOn(left_keys=(E.col("pk"),), right_keys=(E.col("bk"),)),
        join_type="inner")


def run_spill_phase(cols, valid, keys, window, dev, K, seed: int,
                    card: str, shapes: list) -> dict:
    """Phase 28: five serial SF-10 tasks through `execute_task_bytes`,
    each under a SPILL_BUDGET budget (SPILL_TRIGGER trigger) and under
    the default one: (a) phase 3's first map split sorted by the global
    sort's keys, equal row for row; (b) the same rows grouped by (store,
    item) of `make_ss_keys`, Sum and Count of the price, keys and counts
    exact, sums to relative 1e-9; (c) q65w's window task 0 (`window`:
    plan, task count, stage, and its input blocks held in a host
    spill), equal; (d) a sort-merge join of
    a giant group past the window cap, equal as a row multiset to the
    uncapped join; (e) (b)'s aggregation under a Filter -> Projection,
    budgeted fused (the aggregation's prologue) and unfused, equal to
    the unbudgeted run as (b).  Each budgeted run must spill from its
    operator, and (d) take the escape.  Returns each task's launches."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.ir.schema import DataType
    from auron_tpu_torch.ops.shuffle.writer import (
        InProcessShuffleService, PartitionedBlocks,
    )
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    f64, i64 = DataType.float64(), DataType.int64()
    started = time.perf_counter()
    rows = len(cols[0]) // N_MAPS

    def task(plan, inputs):
        def run():
            res = ResourceRegistry()
            for rid, (c, v) in inputs.items():
                res.put(rid, _scan_batches(c, v, 0, len(c[0])))
            return execute_task_bytes(serde.serialize(P.TaskDefinition(
                plan=plan)), res, device=dev)
        return run

    def spilled(label, mgr, res, consumer):
        if not (mgr.consumer_totals().get(consumer, {}).get("spills") and
                res.summed("mem_spill_count")):
            raise AssertionError(f"phase 28: {label}: {consumer} never "
                                 f"spilled under the budget")

    launches = {}
    # (a) the sort
    ss = _schema(("ss_customer_sk", "i64"), ("ss_quantity", "i32"),
                 ("ss_sales_price", "f64"))
    split = ([c[:rows] for c in cols], [v[:rows] for v in valid])
    sort = P.Sort(child=P.FFIReader(schema=ss, resource_id="ss"),
                  sort_exprs=(E.SortExpr(child=E.col("ss_sales_price"),
                                         asc=False, nulls_first=False),
                              E.SortExpr(child=E.col("ss_customer_sk"),
                                         asc=True, nulls_first=True)))
    runs = [_spill_run(f"(a) the sort of {rows} rows", task(sort, {
        "ss": split}), K, card, b) for b in (True, False)]
    spilled("(a)", runs[0][1], runs[0][0], "SortExec")
    _same_tensors("(a) the sort", *[_concat_columns(r[0].batches, ss)
                                     for r in runs])
    launches["sort"] = runs[0][2]
    del runs
    # (b) the aggregation
    item_k, store_k, store_v = keys
    agg_in = _schema(("ss_store_sk", "i64"), ("ss_item_sk", "i64"),
                     ("ss_sales_price", "f64"))
    price = E.col("ss_sales_price")
    agg = P.Agg(child=P.FFIReader(schema=agg_in, resource_id="ss"),
                exec_mode="single",
                grouping=(E.col("ss_store_sk"), E.col("ss_item_sk")),
                grouping_names=("ss_store_sk", "ss_item_sk"),
                aggs=(E.AggExpr(fn="sum", children=(price,),
                                return_type=f64),
                      E.AggExpr(fn="count", children=(price,),
                                return_type=i64)),
                agg_names=("revenue", "cnt"))
    ones = np.ones(rows, bool)
    runs = [_spill_run(f"(b) the aggregation of {rows} rows", task(agg, {
        "ss": ([store_k[:rows], item_k[:rows], cols[2][:rows]],
               [store_v[:rows], ones, valid[2][:rows]])}), K, card, b)
        for b in (True, False)]
    spilled("(b)", runs[0][1], runs[0][0], "AggExec")
    got, exp = [_concat_columns(r[0].batches, runs[1][0].schema)
                for r in runs]
    _same_tensors("(b) the aggregation", got, exp, float_cols=(2,))
    print(f"phase 28: (b) {len(got[0][0])} groups, keys and counts exact, "
          f"sums within 1e-9 | {card}")
    launches["agg"] = runs[0][2]
    del runs, got, exp
    # (c) q65w's window task 0, its blocks back from host memory
    plan, n_tasks, stage, held = window
    rid = "shuffle:q65w:2"
    registry = ResourceRegistry()
    registry.put("shuffle:q65w:1",
                 PartitionedBlocks([list(held.read_batches())]))
    held.release()

    def window_task():
        svc = InProcessShuffleService()
        res = join_stage_task(plan, 0, n_tasks, registry, stage, dev, (),
                              (svc, rid))
        return res, [b for p in range(plan.partitioning.num_partitions)
                     for b in svc.reduce_blocks(rid, p)]
    with recorded_shapes(K, shapes):
        runs = [_spill_run("(c) q65w's window task 0", window_task, K, card,
                           b, traced=b) for b in (True, False)]
    spilled("(c)", runs[0][1], runs[0][0][0], "WindowExec")
    check_spill_trace("(c) q65w's window task 0", runs[0][3], runs[0][1],
                      runs[0][0][0], card)
    out_schema = runs[1][0][1][0].schema
    _same_tensors("(c) the window task", *[
        _concat_columns(r[0][1], out_schema) for r in runs])
    launches["window"] = runs[0][2]
    del runs
    # (d) the giant group
    build, probe = giant_group_sides(seed)
    plan = giant_group_plan()
    inputs = {"build": (build, [np.ones(GIANT_BUILD_ROWS, bool)] *
                        len(build)),
              "probe": (probe, [np.ones(GIANT_PROBE_ROWS, bool)] * 2)}
    runs = []
    for budgeted, cap in ((True, GIANT_WINDOW_CAP), (False, 0)):
        with conf.scoped({"auron.smj.window.max.rows": cap}):
            runs.append(_spill_run(
                f"(d) the giant-group join (window cap {cap})",
                task(plan, inputs), K, card, budgeted))
    spilled("(d)", runs[0][1], runs[0][0], "SortMergeJoinExec")
    escapes = runs[0][0].metrics.get("giant_group_escapes", 0)
    if not escapes or runs[1][0].metrics.get("giant_group_escapes", 0):
        raise AssertionError(f"phase 28: (d) escapes {escapes} capped, "
                             f"{runs[1][0].metrics} uncapped")
    outs = []
    for r in runs:
        c = _concat_columns(r[0].batches, r[0].schema)
        # (probe row, build row) identifies an output row
        order = torch.sort(c[1][0] * GIANT_BUILD_ROWS + c[3][0]).indices
        outs.append([(d[order], v[order]) for d, v in c])
    _same_tensors("(d) the giant-group join", *outs)
    print(f"phase 28: (d) {len(outs[0][0][0])} rows equal the uncapped "
          f"join's as a multiset, {escapes} giant-group escape | {card}")
    launches["giant_group"] = runs[0][2]
    del runs, outs
    # (e) (b)'s aggregation under a Filter -> Projection: fused, the
    # aggregation's prologue groups the fragment's live rows
    prologue = P.Agg(
        child=P.Projection(
            child=P.Filter(child=P.FFIReader(schema=agg_in, resource_id="ss"),
                           predicates=(E.BinaryExpr(
                               left=price, op=">=",
                               right=E.Literal(value=20.0, dtype=f64)),)),
            exprs=(E.col("ss_store_sk"), E.col("ss_item_sk"),
                   E.BinaryExpr(left=price, op="-",
                                right=E.Literal(value=20.0, dtype=f64))),
            names=("ss_store_sk", "ss_item_sk", "excess")),
        exec_mode="single",
        grouping=(E.col("ss_store_sk"), E.col("ss_item_sk")),
        grouping_names=("ss_store_sk", "ss_item_sk"),
        aggs=(E.AggExpr(fn="sum", children=(E.col("excess"),),
                        return_type=f64),
              E.AggExpr(fn="count", children=(E.col("excess"),),
                        return_type=i64)),
        agg_names=("excess", "cnt"))
    inputs = {"ss": ([store_k[:rows], item_k[:rows], cols[2][:rows]],
                     [store_v[:rows], ones, valid[2][:rows]])}
    runs = []
    for fuse, budgeted in ((True, True), (False, True), (False, False)):
        with conf.scoped({"auron.fuse.enable": fuse}):
            runs.append(_spill_run(
                f"(e) the prologue aggregation, fusion "
                f"{'on' if fuse else 'off'},", task(prologue, inputs), K,
                card, budgeted))
    spilled("(e) fused", runs[0][1], runs[0][0], "AggExec")
    spilled("(e) unfused", runs[1][1], runs[1][0], "AggExec")
    frag = [[m.get("fused_into_parent") for n, m in r[0].operator_metrics
             if n == "FusedFragmentExec"] for r in runs]
    if frag != [[1], [], []]:
        raise AssertionError(f"phase 28: (e) fragments {frag}: the fused "
                             f"run did not take the prologue")
    got = [_concat_columns(r[0].batches, runs[2][0].schema) for r in runs]
    for g, what in zip(got[:2], ("fused", "unfused")):
        _same_tensors(f"(e) the prologue aggregation {what}", g, got[2],
                      float_cols=(2,))
    print(f"phase 28: (e) {len(got[0][0][0])} groups, fused and unfused "
          f"under the budget equal the unbudgeted run (keys and counts "
          f"exact, sums within 1e-9) | {card}")
    launches["prologue_agg"] = runs[0][2]
    del runs, got
    print(f"phase 28: {time.perf_counter() - started:.1f} s | {card}")
    return launches


# ---------------------------------------------------------------------------
# Phase 29: float32 and decimal(p <= 18) columns
# ---------------------------------------------------------------------------

DECIMAL_PARTS = 16                   # the phase's exchanges (reduce tasks)
DECIMAL_SALES = (("ss_customer_sk", "i64"), ("ss_quantity", "i32"),
                 ("ss_sales_price", "dec(7,2)"))  # TPC-DS's money type
AVG_SHIFT = 4                        # avg(decimal(7,2)) is decimal(11,6)
F32_ROWS = 1 << 20
F32_KEY_VALUES = 1_000
N_F32_MAPS = 4
# float32 bit patterns: -0.0, 0.0, +inf, -inf, the quiet NaN, its
# negative, a quiet NaN with a payload, a signalling NaN, the least
# subnormal and the largest negative one
SPECIAL_F32_BITS = (0x80000000, 0, 0x7F800000, 0xFF800000, 0x7FC00000,
                    0xFFC00000, 0x7FC00001, 0x7F800123, 0x00000001,
                    0x807FFFFF)
CANONICAL_NAN32_BITS = 0x7FC00000
NULL_KEY = np.iinfo(np.int64).min    # no key's value: the null group


def decimal_sales(cols, valid, rows: int):
    """Phase 3's first `rows` rows with ss_sales_price as decimal(7,2):
    its cents, the int64 unscaled value."""
    cents = np.round(cols[2][:rows] * 100).astype(np.int64)
    return [cols[0][:rows], cols[1][:rows], cents], [v[:rows] for v in valid]


DECIMAL_AGGS = {
    # name, function, input, Spark's result type
    "customer": (("s", "sum", "price", "dec(17,2)"),
                 ("m", "avg", "price", "dec(11,6)"),
                 ("lo", "min", "amt", "dec(18,2)"),
                 ("hi", "max", "amt", "dec(18,2)")),
    "price": (("n", "count", "ss_quantity", "i64"),
              ("q", "sum", "ss_quantity", "i64")),
}
DECIMAL_STATES = {
    "customer": (("ss_customer_sk", "i64"), ("s#sum", "dec(17,2)"),
                 ("m#sum", "dec(7,2)"), ("m#count", "i64", False),
                 ("lo#min", "dec(18,2)"), ("hi#max", "dec(18,2)")),
    "price": (("ss_sales_price", "dec(7,2)"), ("n#count", "i64", False),
              ("q#sum", "i64")),
}


def decimal_plans(kind: str, bounds=()):
    """(map plan, reduce plan) of one of phase 29's decimal stage pairs
    over DECIMAL_SALES, with Spark's result types.  "customer": group by
    ss_customer_sk, Sum and Average of the price and Min and Max of
    CheckOverflow(Cast(qty as decimal(10,0)) * price, decimal(18,2)),
    the product as Spark's converter writes it.  "price": group by the
    price (the single-decimal-key exchange), Count and Sum of the
    quantity.  "sort": a range exchange by the price's `bounds`, then
    Sort by the price DESC NULLS LAST."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    src = P.FFIReader(schema=_schema(*DECIMAL_SALES),
                      resource_id="store_sales")
    price = E.col("ss_sales_price")
    if kind == "sort":
        names = tuple(n for n, _ in DECIMAL_SALES)
        order = (E.SortExpr(child=price, asc=False, nulls_first=False),)
        return (_writer(P.Projection(child=src, exprs=tuple(
                    E.col(n) for n in names), names=names),
                    "range", DECIMAL_PARTS, sort_orders=order,
                    range_bounds=bounds),
                P.Sort(child=P.IpcReader(schema=_schema(*DECIMAL_SALES),
                                         resource_id="shuffle_read"),
                       sort_exprs=order))
    child = src
    if kind == "customer":
        amt = E.ScalarFunctionCall(
            name="check_overflow", return_type=_dtype("dec(18,2)"),
            args=(E.BinaryExpr(left=E.Cast(child=E.col("ss_quantity"),
                                           dtype=_dtype("dec(10,0)")),
                               op="*", right=price),))
        child = P.Projection(child=src, exprs=(E.col("ss_customer_sk"),
                                               price, amt),
                             names=("ss_customer_sk", "price", "amt"))
    states = DECIMAL_STATES[kind]
    key = (E.col(states[0][0]),)
    aggs = tuple(E.AggExpr(fn=f, children=(E.col(c),),
                           return_type=_dtype(t))
                 for _, f, c, t in DECIMAL_AGGS[kind])
    names = tuple(a[0] for a in DECIMAL_AGGS[kind])

    def agg(c, mode):
        return P.Agg(child=c, exec_mode=mode, grouping=key,
                     grouping_names=(states[0][0],), aggs=aggs,
                     agg_names=names)
    reader = P.IpcReader(schema=_schema(*states),
                         resource_id="shuffle_read")
    return (_writer(agg(child, "partial"), "hash", DECIMAL_PARTS, key),
            agg(reader, "final"))


def run_phase29_pair(name: str, plans, cols, valid, source: str,
                     n_maps: int, dev, K, hash_pid: bool,
                     scan_batch: int = 0):
    """n_maps map tasks of `plans` over the rows into the writer's
    partitions, then a reduce task each; checks that the histogram ran on
    every writer batch, and hash-pid too where `hash_pid` (one int64 or
    decimal key); -> (the reduce outputs concatenated in partition
    order, the map stage's launches, its kernel shapes, its batches, the
    seconds)."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    mplan, rplan = plans
    svc = InProcessShuffleService()
    K.reset_launches()
    t0 = time.perf_counter()
    maps, _, blocks = run_shuffle_stage(
        mplan, svc, name, n_maps,
        lambda m: map_task(m, cols, valid, svc, dev, mplan, name, source,
                           n_maps))
    launches = dict(K.LAUNCHES)
    pushed, shapes = check_stage(f"phase 29: {name} map", launches, maps,
                                 len(blocks), hash_pid=hash_pid,
                                 scan_batch=scan_batch)
    outs = [reduce_task(rplan, blocks, 2, p, dev).to_numpy()
            for p in range(len(blocks))]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = {c: tuple(np.concatenate([o[c][i] for o in outs]) for i in (0, 1))
           for c in outs[0]}
    return out, launches, shapes, pushed, secs


def _keyed(out, key: str):
    """A grouped output's columns sorted by `key` (null first), and the
    keys (null as NULL_KEY); each key once."""
    kd, kv = out[key]
    k = np.where(kv, kd, NULL_KEY).astype(np.int64)
    order = np.argsort(k, kind="stable")
    if len(np.unique(k)) != len(k):
        raise AssertionError(f"phase 29: a {key} group appears twice")
    return {c: (d[order], v[order]) for c, (d, v) in out.items()}, k[order]


def _same_groups(what, got, exp) -> None:
    """Exact equality of {column: (data, validity)} against numpy's
    {column: (values, has)}."""
    for c, (e, has) in exp.items():
        d, v = got[c]
        if not (np.array_equal(v, has) and np.array_equal(d[v], e[has])):
            raise AssertionError(f"phase 29: {what}: column {c} differs "
                                 f"from numpy")


def check_decimal_customer(out, dcols, dvalid) -> int:
    """Group by customer: the unscaled Sum, the Average rounded half up at
    scale 6, Min and Max of quantity x cents, each against numpy's
    integers.  Returns the groups."""
    sk, qty, cents = dcols
    skv, qv, pv = dvalid
    uk, gid = np.unique(np.where(skv, sk, NULL_KEY), return_inverse=True)
    got, keys = _keyed(out, "ss_customer_sk")
    if not np.array_equal(keys, uk):
        raise AssertionError(f"phase 29: {len(keys)} customer groups, "
                             f"numpy {len(uk)}")
    g = len(uk)
    # float64 sums of integers below 2^53 are exact
    s = np.bincount(gid[pv], weights=cents[pv], minlength=g).astype(np.int64)
    cnt = np.bincount(gid[pv], minlength=g)
    half_up = (2 * np.abs(s) * 10 ** AVG_SHIFT + cnt) // np.maximum(2 * cnt,
                                                                    1)
    both = pv & qv
    amt = qty.astype(np.int64) * cents
    lo = np.full(g, np.iinfo(np.int64).max)
    hi = np.full(g, np.iinfo(np.int64).min)
    np.minimum.at(lo, gid[both], amt[both])
    np.maximum.at(hi, gid[both], amt[both])
    has_amt = np.bincount(gid[both], minlength=g) > 0
    _same_groups("group by customer", got, {
        "s": (s, cnt > 0), "m": (np.sign(s) * half_up, cnt > 0),
        "lo": (lo, has_amt), "hi": (hi, has_amt)})
    return g


def check_decimal_price(out, dcols, dvalid) -> int:
    """Group by the decimal price: Count and Sum of the quantity."""
    _, qty, cents = dcols
    _, qv, pv = dvalid
    uk, gid = np.unique(np.where(pv, cents, NULL_KEY), return_inverse=True)
    got, keys = _keyed(out, "ss_sales_price")
    if not np.array_equal(keys, uk):
        raise AssertionError(f"phase 29: {len(keys)} price groups, numpy "
                             f"{len(uk)}")
    g = len(uk)
    cnt = np.bincount(gid[qv], minlength=g)
    q = np.bincount(gid[qv], weights=qty[qv], minlength=g).astype(np.int64)
    _same_groups("group by price", got, {
        "n": (cnt, np.ones(g, bool)), "q": (q, cnt > 0)})
    return g


def _rows_sorted(cols, valid):
    """The rows as a multiset: each column's (validity, value) in one
    lexicographic order."""
    keys = []
    for c, v in zip(cols, valid):
        keys += [np.where(v, c, 0), v]
    order = np.lexsort(keys[::-1])
    return [k[order] for k in keys]


def check_decimal_sort(out, dcols, dvalid) -> int:
    """The partitions in id order hold the prices in descending order,
    nulls last, and the rows are the input's."""
    names = [n for n, _ in DECIMAL_SALES]
    d, v = out["ss_sales_price"]
    pv = dvalid[2]
    exp = -np.sort(-dcols[2][pv])
    n_valid = int(pv.sum())
    if not (len(d) == len(pv) and v[:n_valid].all() and
            not v[n_valid:].any() and np.array_equal(d[:n_valid], exp)):
        raise AssertionError("phase 29: the decimal sort's prices are not "
                             "in Spark's order")
    got = _rows_sorted([out[n][0] for n in names], [out[n][1] for n in names])
    want = _rows_sorted(dcols, dvalid)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("phase 29: the decimal sort's rows differ from "
                             "the input's")
    return len(d)


def decimal_foreign_plan(catalog):
    """Phase 29 (a)(1) as a foreign plan (the port's `frontend.foreign`
    nodes, Spark's operator names): the scan, the Projection of the key,
    the price and the CheckOverflow product, the partial
    HashAggregateExec, the hash exchange, the final one."""
    from auron_tpu_torch.frontend.foreign import (
        ForeignNode, falias, fcall, fcol,
    )
    from auron_tpu_torch.it.queries import agg
    t = _dtype
    price = fcol("ss_sales_price", t("dec(7,2)"))
    amt = fcall("CheckOverflow", fcall(
        "Multiply", fcall("Cast", fcol("ss_quantity", t("i32")),
                          dtype=t("dec(10,0)")),
        price, dtype=t("dec(18,2)")), dtype=t("dec(18,2)"))
    key = fcol("ss_customer_sk", t("i64"))
    proj = ForeignNode(
        "ProjectExec", children=(catalog.scan("store_sales"),),
        output=_schema(("ss_customer_sk", "i64"), ("price", "dec(7,2)"),
                       ("amt", "dec(18,2)")),
        attrs={"project_list": [key, falias(price, "price"),
                                falias(amt, "amt")]})
    fn_names = {"sum": "Sum", "avg": "Average", "min": "Min", "max": "Max"}
    aggs = [agg(fn_names[f], fcol(c, proj.output.field(c).dtype), t(rt))
            for _, f, c, rt in DECIMAL_AGGS["customer"]]
    names = [a[0] for a in DECIMAL_AGGS["customer"]]
    states = _schema(*DECIMAL_STATES["customer"])
    partial = ForeignNode(
        "HashAggregateExec", children=(proj,), output=states,
        attrs={"grouping": [key], "aggs": aggs, "agg_names": names,
               "mode": "partial"})
    exchange = ForeignNode(
        "ShuffleExchangeExec", children=(partial,), output=states,
        attrs={"partitioning": {"mode": "hash",
                                "num_partitions": DECIMAL_PARTS,
                                "expressions": [key]}})
    out = _schema(("ss_customer_sk", "i64"), *(
        (n, rt) for n, _, _, rt in DECIMAL_AGGS["customer"]))
    return ForeignNode(
        "HashAggregateExec", children=(exchange,), output=out,
        attrs={"grouping": [key], "aggs": aggs, "agg_names": names,
               "mode": "final"})


def run_decimal_session(dcols, dvalid, serial, dev, K, card: str) -> dict:
    """Phase 29 (c): (a)(1) from its foreign plan through the port's
    `AuronSession.execute`, `TableEngine` serving the scan of the split's
    columns (the price as its unscaled cents): on the stage path, no
    kernel launched, equal to the serial stage pair's groups.  Returns
    the launches."""
    from auron_tpu_torch.frontend import converters as C
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.it.datagen import Catalog, TableDef, TableEngine
    catalog = Catalog("card", {"store_sales": TableDef(
        "store_sales", _schema(*DECIMAL_SALES), ["store_sales/part-00000"])})
    session = AuronSession(foreign_engine=TableEngine(
        catalog, {"store_sales": (dcols, dvalid)}))
    provider = C.ScanSourceProvider()
    C.register_provider(provider)
    try:
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = session.execute(decimal_foreign_plan(catalog), dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        C.unregister_provider(provider)
    launches = dict(K.LAUNCHES)
    if not res.spmd or res.metrics.get("num_fallbacks"):
        raise AssertionError(f"phase 29: the decimal foreign plan ran off "
                             f"the stage path ({res.spmd_rejection})")
    if any(launches.values()):
        raise AssertionError(f"phase 29: the stage execute launched "
                             f"{launches}")
    got, keys = _keyed(res.columns, "ss_customer_sk")
    want, wkeys = _keyed(serial, "ss_customer_sk")
    if not np.array_equal(keys, wkeys):
        raise AssertionError("phase 29: the session's customer groups "
                             "differ from the stage pair's")
    _same_groups("the session against the stage pair", got,
                 {c: (want[c][0], want[c][1]) for c in ("s", "m", "lo",
                                                        "hi")})
    print(f"phase 29: (c) the group by customer from its foreign plan on "
          f"the stage path {secs:.3f} s (cold), tag and convert "
          f"{res.convert_s * 1e3:.3f} ms, its {len(keys)} groups equal to "
          f"(a)(1), no launch | {card}")
    return launches


def make_f32_keys(seed: int, n: int = F32_ROWS):
    """n rows of a float32 key drawn from F32_KEY_VALUES values (the
    patterns of SPECIAL_F32_BITS among them) and a float32 value drawn
    from the special patterns and 50 numbers, each column with
    NULL_FRACTION nulls."""
    rng = np.random.default_rng([seed, 32])
    special = np.array(SPECIAL_F32_BITS, np.uint32).view(np.float32)
    keys = np.concatenate([special, np.round(rng.normal(
        size=F32_KEY_VALUES - len(special)) * 1e3, 1).astype(np.float32)])
    vals = np.concatenate([special, rng.normal(size=50).astype(np.float32)])
    return ([rng.choice(keys, n), rng.choice(vals, n)],
            [rng.random(n) >= NULL_FRACTION for _ in range(2)])


F32_AGGS = (("a0", "min", "f32"), ("a1", "max", "f32"),
            ("a2", "sum", "f64"), ("a3", "avg", "f64"),
            ("a4", "count", "i64"))


def f32_plans(kind: str, bounds=()):
    """(map plan, reduce plan) over (k, v) float32: "group", partial Min,
    Max, Sum, Average and Count of v by k -> hash(4) on k -> final; "sort",
    a range exchange by k's `bounds` -> Sort by k."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    schema = _schema(("k", "f32"), ("v", "f32"))
    src = P.FFIReader(schema=schema, resource_id="floats32")
    key = (E.col("k"),)
    if kind == "sort":
        order = (E.SortExpr(child=E.col("k"), asc=True, nulls_first=True),)
        return (_writer(P.Projection(child=src, exprs=(E.col("k"),
                                                       E.col("v")),
                                     names=("k", "v")),
                        "range", DECIMAL_PARTS, sort_orders=order,
                        range_bounds=bounds),
                P.Sort(child=P.IpcReader(schema=schema,
                                         resource_id="shuffle_read"),
                       sort_exprs=order))
    aggs = tuple(E.AggExpr(fn=f, children=(E.col("v"),),
                           return_type=_dtype(t)) for _, f, t in F32_AGGS)
    names = tuple(a[0] for a in F32_AGGS)

    def agg(c, mode):
        return P.Agg(child=c, exec_mode=mode, grouping=key,
                     grouping_names=("k",), aggs=aggs, agg_names=names)
    states = _schema(("k", "f32"), ("a0#min", "f32"), ("a1#max", "f32"),
                     ("a2#sum", "f64"), ("a3#sum", "f64"),
                     ("a3#count", "i64", False), ("a4#count", "i64", False))
    return (_writer(agg(src, "partial"), "hash", N_AGG_PARTS, key),
            agg(P.IpcReader(schema=states, resource_id="shuffle_read"),
                "final"))


def _f32_group(k, kv):
    """int64 group ids of float32 keys under Spark's normalization (-0.0
    as 0.0, every NaN as one, null a group of its own)."""
    kn = np.where(k == 0, np.float32(0), k)
    kn = np.where(np.isnan(kn), np.float32(np.nan), kn)
    return np.where(kv, kn.view(np.uint32).astype(np.int64), 1 << 32)


def _f32_order(k, kv):
    """An int64 word a row that orders float32 keys as Spark does (nulls
    first, -0.0 equal to 0.0, NaN above +inf)."""
    b = _f32_group(k, kv)
    word = np.where(b < (1 << 31), b ^ (1 << 31), b ^ 0xFFFFFFFF)
    return np.where(kv, word + 1, 0)


def check_f32_group(out, fcols, fvalid) -> int:
    """One group per normalized key, the keys normalized; Count exact, Min
    and Max as Spark orders floats (normalized), Sum and Average in
    float64 to relative 1e-9 (another summation order), infinities and
    NaNs where numpy has them.  Returns the groups."""
    k, v = fcols
    kv, vv = fvalid
    uk, gid = np.unique(_f32_group(k, kv), return_inverse=True)
    g = len(uk)
    gk, gkv = out["k"]
    got_key = _f32_group(gk, gkv)
    order = np.argsort(got_key)
    bits = gk.view(np.uint32)
    if not np.array_equal(got_key[order], uk) or \
            np.any(gkv & (bits == 0x80000000)) or \
            np.any(gkv & np.isnan(gk) & (bits != CANONICAL_NAN32_BITS)):
        raise AssertionError(f"phase 29: {len(gk)} float32 groups (numpy "
                             f"{g}) or a key unnormalized")
    with np.errstate(invalid="ignore"):     # a signalling NaN widened
        v64 = v.astype(np.float64)
    emn, emx, has = _spark_extremes(gid, g, v64, vv)
    cnt = np.bincount(gid, weights=vv, minlength=g).astype(np.int64)
    s = np.bincount(gid[vv], weights=v64[vv], minlength=g)
    for name, exp in (("a0", emn), ("a1", emx)):
        d, dv = (x[order] for x in out[name])
        b = d[dv].view(np.uint32)
        if not (np.array_equal(dv, has) and
                np.array_equal(np.isnan(d[dv]), np.isnan(exp[has])) and
                np.array_equal(d[dv][~np.isnan(d[dv])],
                               exp[has][~np.isnan(exp[has])]) and
                not np.any(b == 0x80000000) and
                np.all(b[np.isnan(d[dv])] == CANONICAL_NAN32_BITS)):
            raise AssertionError(f"phase 29: float32 {name} differs from "
                                 f"Spark's order")
    for name, exp in (("a2", s), ("a3", s / np.maximum(cnt, 1))):
        d, dv = (x[order] for x in out[name])
        if not (np.array_equal(dv, cnt > 0) and np.allclose(
                d[dv], exp[cnt > 0], rtol=1e-9, atol=0, equal_nan=True)):
            raise AssertionError(f"phase 29: float32 {name} differs from "
                                 f"numpy")
    if not np.array_equal(out["a4"][0][order], cnt):
        raise AssertionError("phase 29: float32 counts differ from numpy")
    return g


def check_f32_sort(out, fcols, fvalid) -> int:
    """The partitions in id order hold the keys in Spark's order, and the
    rows are the input's (as bits)."""
    d, v = out["k"]
    word = _f32_order(d, v)
    if len(d) != len(fcols[0]) or np.any(word[1:] < word[:-1]):
        raise AssertionError("phase 29: the float32 sort is not in Spark's "
                             "order")
    got = _rows_sorted([out["k"][0].view(np.uint32),
                        out["v"][0].view(np.uint32)],
                       [out["k"][1], out["v"][1]])
    want = _rows_sorted([c.view(np.uint32) for c in fcols], fvalid)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("phase 29: the float32 sort's rows differ "
                             "from the input's")
    return len(d)


def run_phase29(cols, valid, dev, K, seed: int, card: str,
                shapes: list) -> dict:
    """Phase 29: float32 and decimal(p <= 18) columns on the card.  (a)
    the first map split's rows with the price as decimal(7,2), three
    stage pairs through `execute_task_bytes` (group by customer, group by
    the price on the hash-pid kernel, the global sort by the price)
    against numpy's integers; (b) a group-by and a global sort of 2^20
    float32 keys under Spark's rules; (c) (a)(1) from its foreign plan
    through the session's stage path.  Adds the writers' kernel shapes to
    `shapes`; returns each path's launches."""
    import decimal
    started = time.perf_counter()
    rows = len(cols[0]) // N_MAPS
    dcols, dvalid = decimal_sales(cols, valid, rows)
    launches = {}
    out, la, sh, pushed, secs = run_phase29_pair(
        "customer", decimal_plans("customer"), dcols, dvalid, "store_sales",
        1, dev, K, hash_pid=True)
    shapes += sh
    launches["decimal_customer"] = la
    serial = out
    print(f"phase 29: (a)(1) group by customer of {rows} rows (price "
          f"decimal(7,2)): {check_decimal_customer(out, dcols, dvalid)} "
          f"groups (Sum decimal(17,2), Average decimal(11,6), Min and Max "
          f"of the decimal(18,2) product) equal to numpy's integers in "
          f"{secs:.3f} s, {pushed} map-side batches = "
          f"{la['hash_partition_ids_i64']} hash-pid = "
          f"{la['radix_bucket_hist']} radix-hist launches | {card}")
    out, la, sh, pushed, secs = run_phase29_pair(
        "price", decimal_plans("price"), dcols, dvalid, "store_sales", 1,
        dev, K, hash_pid=True)
    shapes += sh
    launches["decimal_key"] = la
    print(f"phase 29: (a)(2) group by the decimal price: "
          f"{check_decimal_price(out, dcols, dvalid)} groups (Count, Sum of "
          f"the quantity) equal to numpy in {secs:.3f} s, {pushed} map-side "
          f"batches = {la['hash_partition_ids_i64']} hash-pid (the single "
          f"decimal key's unscaled int64) = {la['radix_bucket_hist']} "
          f"radix-hist launches | {card}")
    t = time.perf_counter()
    bounds = tuple(tuple(None if x is None else
                         decimal.Decimal(x).scaleb(-2) for x in b)
                   for b in range_bounds([dcols[2]], [dvalid[2]],
                                         ((False, False),), DECIMAL_PARTS,
                                         N_MAPS, seed))
    sample_s = time.perf_counter() - t
    out, la, sh, pushed, secs = run_phase29_pair(
        "sort", decimal_plans("sort", bounds), dcols, dvalid,
        "store_sales", 1, dev, K, hash_pid=False, scan_batch=SCAN_BATCH)
    shapes += sh
    launches["decimal_sort"] = la
    print(f"phase 29: (a)(3) global sort by the decimal price DESC NULLS "
          f"LAST by {len(bounds)} Decimal bounds (sampled in "
          f"{sample_s:.2f} s): {check_decimal_sort(out, dcols, dvalid)} rows "
          f"in Spark's order in {secs:.3f} s, {pushed} map-side batches = "
          f"{la['radix_bucket_hist']} radix-hist launches, "
          f"{la['hash_partition_ids_i64']} hash-pid | {card}")
    fcols, fvalid = make_f32_keys(seed, min(F32_ROWS, len(cols[0])))
    out, la, sh, pushed, secs = run_phase29_pair(
        "floats32", f32_plans("group"), fcols, fvalid, "floats32",
        N_F32_MAPS, dev, K, hash_pid=False)
    shapes += sh
    launches["float32_group_by"] = la
    print(f"phase 29: (b) group by a float32 key over {len(fcols[0])} rows "
          f"(+-0.0, NaNs of 4 patterns, +-inf, subnormals): "
          f"{check_f32_group(out, fcols, fvalid)} groups (one for +-0.0, "
          f"one for the NaNs, one null) equal to numpy under Spark's rules "
          f"in {secs:.3f} s, {pushed} map-side batches = "
          f"{la['radix_bucket_hist']} radix-hist, "
          f"{la['hash_partition_ids_i64']} hash-pid | {card}")
    with np.errstate(invalid="ignore"):     # a signalling NaN widened
        fbounds = range_bounds([fcols[0]], [fvalid[0]], ((True, True),),
                               DECIMAL_PARTS, N_F32_MAPS, seed)
    out, la, sh, pushed, secs = run_phase29_pair(
        "sort32", f32_plans("sort", fbounds), fcols, fvalid, "floats32",
        N_F32_MAPS, dev, K, hash_pid=False, scan_batch=SCAN_BATCH)
    shapes += sh
    launches["float32_sort"] = la
    print(f"phase 29: (b) global sort by the float32 key: "
          f"{check_f32_sort(out, fcols, fvalid)} rows in Spark's order in "
          f"{secs:.3f} s, {pushed} map-side batches = "
          f"{la['radix_bucket_hist']} radix-hist launches | {card}")
    launches["decimal_session_stage"] = run_decimal_session(
        dcols, dvalid, serial, dev, K, card)
    print(f"phase 29: {time.perf_counter() - started:.1f} s | {card}")
    return launches


def check_path_shapes(K, dev, rng, shapes) -> dict:
    """Phase 15, run last: each kernel at each (kernel, rows, n_parts) a
    path of phases 3-14, 16-18, 21-24, 28 and 29 gave it, held bit-exact against its
    plain version on fresh inputs: hash-pid on int64 keys with 10% nulls,
    the histogram at the writer's padded capacity and the writer's sizes
    against torch.bincount.  Returns the largest difference (0) of each
    kernel."""
    from auron_tpu_torch.columnar.batch import bucket_capacity
    from auron_tpu_torch.ops.radix_sort import ceil_log2
    from auron_tpu_torch.ops.shuffle import writer as W
    worst = {"hash_pid": 0, "hist": 0}
    done = set()
    for kernel, n, n_parts in shapes:
        if (kernel, n, n_parts) in done:
            continue
        done.add((kernel, n, n_parts))
        if kernel == "hash_pid":
            keys, valid = random_keys(rng, n, dev)
            err = int((K.hash_partition_ids_i64(keys, valid, n_parts).long()
                       - K.hash_partition_ids_i64_plain(keys, valid, n_parts)
                       .long()).abs().max())
        else:
            pids = torch.from_numpy(rng.integers(0, n_parts, n).astype(
                np.int32)).to(dev)
            sizes = W.sizes_by_hist(pids, n_parts)
            err = int(np.abs(sizes - torch.bincount(
                pids, minlength=n_parts).cpu().numpy()).max())
            # the writer's words: ids in the top ceil_log2(n_parts) bits
            words = hist_words(rng, bucket_capacity(n), dev, n_parts)
            b = ceil_log2(n_parts)
            err = max(err, int((K.radix_bucket_hist(words, b).long() -
                                K.radix_bucket_hist_plain(words, b).long())
                               .abs().max()))
        worst[kernel] = max(worst[kernel], err)
        if err:
            raise AssertionError(f"phase 15: {kernel} != plain at n={n} "
                                 f"n_parts={n_parts}")
    print(f"phase 15: every kernel shape of phases 3-14, 16-18, 21-24, 28 and "
          f"29 bit-exact "
          f"with its plain version, {len(done)} (kernel, rows, n_parts): "
          f"{sorted(done)}")
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=SF10_STORE_SALES_ROWS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from auron_tpu_torch import resolve_device
    from auron_tpu_torch.ops import kernels_cuda as K
    dev = resolve_device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build_phase(K)

    rng = np.random.default_rng(args.seed)
    max_err = check_kernel(K, dev, rng)

    t = time.perf_counter()
    cols, valid = make_store_sales(args.rows, args.seed)
    print(f"phase 3: {args.rows} store_sales rows made in "
          f"{time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    outs, map_results, map_s, reduce_s = run_stage_pair(cols, valid, dev)
    launches = dict(K.LAUNCHES)
    pushed, shapes = check_stage("group-by map stage", launches,
                                 map_results, N_REDUCE, hash_pid=True)
    written = sum(r.metrics.get("shuffle_write_rows", 0)
                  for r in map_results)
    groups = check_result(outs, cols, valid, K, dev)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 3: map stage {map_s:.3f} s ({args.rows / map_s:.0f} "
          f"rows/s), reduce stage {reduce_s:.3f} s ({written / reduce_s:.0f} "
          f"partial rows/s), {groups} groups equal to numpy, "
          f"{pushed} map-side batches = {launches['hash_partition_ids_i64']} "
          f"hash-pid launches = {launches['radix_bucket_hist']} radix-hist "
          f"launches, peak {peak / 2**30:.3f} GiB | {card}")
    del outs, map_results
    no_spills("3", card)

    main_n = written // pushed
    timings = {}
    for n in (8192, main_n, 2**24):
        keys, v = random_keys(rng, n, dev)
        kernel = lambda: K.hash_partition_ids_i64(keys, v, N_REDUCE)  # noqa: E731
        plain = lambda: K.hash_partition_ids_i64_plain(keys, v, N_REDUCE)  # noqa: E731
        # the main path's shape is held bit-exact too
        err = int((kernel().long() - plain().long()).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"hash-pid kernel != plain at n={n}")
        ev_k, ev_p = median_ms(kernel), median_ms(plain)
        pr_k, pr_p = profiled_ms(kernel, kernel="hash_pid_i64"), \
            profiled_ms(plain)
        # the profiler's kernel durations where the trace has them: the
        # event window of one small launch also holds the host's launch
        # overhead
        timings[n] = (pr_k or ev_k, pr_p or ev_p)
        print(f"phase 4: hash-pid n={n}: kernel {ev_k:.5f} ms by events, "
              f"{pr_k} ms by profiler; plain {ev_p:.5f} ms by events, "
              f"{pr_p} ms by profiler; bound {pid_bound(n)[0]:.6f} ms "
              f"| {card}")
    k_ms, p_ms = timings[main_n]
    bound_ms, bound_by = pid_bound(main_n)
    print(f"phase 4: launch floor (one-element add_) {launch_floor_ms(dev)} "
          f"ms by profiler | {card}")
    profile_map_task(cols, valid, dev, card)

    hist_err = check_hist_kernel(K, dev, rng)

    from auron_tpu_torch.columnar.batch import bucket_capacity
    from auron_tpu_torch.ops import sort_keys as SK
    from auron_tpu_torch.ops.strategy import sort_strategy
    t = time.perf_counter()
    sort_cols, sort_valid = [cols[2], cols[0]], [valid[2], valid[0]]
    bounds = range_bounds(sort_cols, sort_valid, ((False, False),
                                                  (True, True)),
                          N_REDUCE, N_MAPS, args.seed)
    print(f"phase 7: {len(bounds)} range bounds sampled in "
          f"{time.perf_counter() - t:.2f} s")
    plans = sort_stage_plans(bounds)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    svc, sort_maps, sort_outs, sort_metrics, smap_s, sred_s = \
        run_sort_stage_pair(cols, valid, plans, dev)
    sort_launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    sort_pushed, sort_shapes = check_stage(
        "global-sort map stage", sort_launches, sort_maps, N_REDUCE,
        hash_pid=False, scan_batch=SCAN_BATCH)
    shapes += sort_shapes
    t = time.perf_counter()
    sizes = check_sort_result(sort_outs, cols, valid, bounds)
    check_s = time.perf_counter() - t
    strategy = sort_strategy(bucket_capacity(max(sizes)), 4, dev.type)
    form = SK.sort_form(bucket_capacity(max(sizes)), 4, dev.type)
    for n, m in zip(sizes, sort_metrics):
        ran = {k: v for k, v in m.items() if k.startswith("sorted_by_")}
        if ran != ({f"sorted_by_{form}": 1} if n else {}):
            raise AssertionError(f"a reduce task of {n} rows sorted as "
                                 f"{ran}, want one {form} sort")
    nonempty = sum(1 for n in sizes if n)
    print(f"phase 7: map stage {smap_s:.3f} s ({args.rows / smap_s:.0f} "
          f"rows/s), reduce stage {sred_s:.3f} s ({args.rows / sred_s:.0f} "
          f"rows/s), {args.rows} rows equal to numpy's stable lexsort and "
          f"inside their partitions' bounds (checked in {check_s:.1f} s), "
          f"reduce tasks of {min(sizes)}..{max(sizes)} rows, "
          f"{sort_pushed} map-side batches = "
          f"{sort_launches['radix_bucket_hist']} radix-hist launches, "
          f"0 hash-pid launches, {nonempty} reduce sorts by "
          f"'{strategy}' as {form}, peak {peak / 2**30:.3f} GiB | {card}")
    del sort_outs, sort_maps, sort_metrics

    hist_json, err = time_hist(K, dev, rng, SCAN_BATCH, N_REDUCE, card)
    hist_err = max(hist_err, err)
    _, err = time_hist(K, dev, rng, bucket_capacity(main_n), N_REDUCE, card)
    hist_err = max(hist_err, err)
    _, err = time_hist(K, dev, rng, bucket_capacity(main_n), N_REDUCE, card,
                       zero=True)
    hist_err = max(hist_err, err)
    print(f"phase 8: launch floor (one-element add_) {launch_floor_ms(dev)} "
          f"ms by profiler | {card}")
    time_reduce_sort(svc, dev, card)
    profile_sort_tasks(cols, valid, svc, plans, dev, card)
    del svc
    no_spills("4-9", card)

    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    t = new_phases = time.perf_counter()
    date_sk, date_valid = make_sold_date_sk(args.rows, args.seed)
    q96_cols = [date_sk, cols[1], cols[2]]
    q96_valid = [date_valid, valid[1], valid[2]]
    print(f"phase 10: ss_sold_date_sk made in "
          f"{time.perf_counter() - t:.2f} s")
    out, q96_launches, path_shapes = run_global_query(
        "q96", q96_cols, q96_valid, dev, K, card)
    shapes += path_shapes
    print(f"phase 10: q96 count {check_q96(out, cols, valid)} equal to "
          f"numpy | {card}")
    q96_map = store_sales_plans("q96")[0]
    # a quarter of the task, as for q88c and the group-by map: reading
    # a whole task's trace took 20-30 s on an H100
    profile_task("phase 10: q96 map task 0, its first quarter",
                 lambda: map_task(0, q96_cols, q96_valid,
                                  InProcessShuffleService(), dev, q96_map,
                                  "q96", n_maps=4 * N_MAPS), card)
    del q96_cols, q96_valid, date_sk, date_valid
    no_spills("10", card)

    q88_cols, q88_valid = [cols[1], cols[2]], [valid[1], valid[2]]
    out, q88_launches, path_shapes = run_global_query(
        "q88c", q88_cols, q88_valid, dev, K, card)
    shapes += path_shapes
    print(f"phase 11: q88c bands {check_q88c(out, cols, valid)} equal to "
          f"numpy | {card}")
    q88_map = store_sales_plans("q88c")[0]
    # an eighth of the task: a quarter's trace took 8.8 s to read
    profile_task("phase 11: q88c map task 0, its first eighth",
                 lambda: map_task(0, q88_cols, q88_valid,
                                  InProcessShuffleService(), dev, q88_map,
                                  "q88c", n_maps=8 * N_MAPS), card)
    no_spills("11", card)

    t = time.perf_counter()
    rcols, rvalid, ridx = make_store_returns(cols, valid, args.seed)
    print(f"phase 12: {len(rcols[0])} store_returns rows made in "
          f"{time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    outs, q01_launches, path_shapes = run_q01_stages(rcols, rvalid, dev, K,
                                                     card)
    shapes += path_shapes
    t = time.perf_counter()
    stores = check_q01(outs, rcols, rvalid)
    print(f"phase 12: q01 thresholds of {stores} stores (the null store "
          f"included) equal to numpy (checked in "
          f"{time.perf_counter() - t:.1f} s), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    s1 = q01_plans()[0]
    profile_task("phase 12: q01 stage-1 map task 0",
                 lambda: map_task(0, rcols, rvalid,
                                  InProcessShuffleService(), dev, s1, "ctr",
                                  "store_returns", N_RETURN_MAPS), card)
    no_spills("12", card)
    print(f"phases 10-12: {time.perf_counter() - new_phases:.1f} s | {card}")

    t = new_phases = time.perf_counter()
    sales, returns, (jcols, jvalid) = make_q17m_tables(
        cols, valid, ridx, rcols, rvalid, args.seed)
    print(f"phase 13: q17m's store_sales ({len(sales[0][0])} rows) and "
          f"store_returns ({len(returns[0][0])} rows) made in "
          f"{time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    q = JoinQuery("q17m", {"store_sales": sales, "store_returns": returns},
                  {"store_sales": N_MAPS, "store_returns": N_RETURN_MAPS},
                  dev, K).run()
    q.report(13, card)
    shapes += q.shapes
    q17m_launches = q.total_launches()
    out = q.out()
    n_join = check_q17m_join_rows(q, len(jcols[0]))
    print(f"phase 13: q17m whole: the sort-merge join's {n_join} rows equal "
          f"numpy's count; its {len(out['ss_store_sk'][0])} rows (of "
          f"{check_q17m(out, jcols, jvalid)} stores, the null store first) "
          f"equal to numpy, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    # no profile of a sort-merge join task: its trace took 37-57 s to
    # read at a 64th of its blocks (one block a partition), the most of
    # any profile (PERF.md §5 keeps its last reading)
    del q, sales, returns, jcols, jvalid, ridx
    fcols, fvalid = make_float_keys(args.seed,
                                    min(FLOAT_KEY_ROWS, args.rows))
    out, float_launches, path_shapes = run_float_keys(fcols, fvalid, dev,
                                                      K, card)
    shapes += path_shapes
    print(f"phase 13: {check_float_keys(out, fcols, fvalid)} float-key "
          f"groups (one for +-0.0, one for every NaN, one null) equal to "
          f"numpy under Spark's normalization | {card}")
    check_first_forms(fcols, fvalid, dev, card)
    check_segments_on_card(dev, rng, card)
    del fcols, fvalid
    no_spills("13", card)

    items = max(100, INV_ITEMS * args.rows // SF10_STORE_SALES_ROWS)
    t = time.perf_counter()
    inventory, months = make_inventory(args.seed, items)
    dates = make_date_dim()
    print(f"phase 14: {len(inventory[0][0])} inventory rows (the snapshots "
          f"of January to March 2000) and {len(dates[0][0])} date_dim rows "
          f"made in {time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    q = JoinQuery("q39v", {"inventory": inventory, "date_dim": dates},
                  {"inventory": N_INVENTORY_MAPS, "date_dim": 1}, dev,
                  K).run()
    q.report(14, card)
    shapes += q.shapes
    q39v_launches = q.total_launches()
    kept = {}
    for moy, rid in ((1, "shuffle:q39v:3"), (2, "shuffle:q39v:7")):
        kept[moy] = _blocks_numpy(
            [b for part in q.blocks[rid] for b in part],
            (f"w{moy}", f"i{moy}", f"mean{moy}", f"sdev{moy}"))
        n_kept, n_nan, n_tie = check_q39v(kept[moy], *months[moy], moy)
        print(f"phase 14: q39v month {moy}: {n_kept} of "
              f"{items * SF10_WAREHOUSES} groups kept, equal to numpy over "
              f"the month's {len(months[moy][0][0])} joined rows ({n_nan} "
              f"of one valid row kept with sdev NaN, {n_tie} on the 0.4 "
              f"tie) | {card}")
    out = q.out()
    print(f"phase 14: q39v whole: its {len(out['w1'][0])} rows equal the "
          f"first 100 of the {check_q39v_top(out, kept[1], kept[2])} groups "
          f"kept in both months, joined in Python, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    del q, inventory, months, dates, kept
    no_spills("14", card)
    print(f"phases 13-14: {time.perf_counter() - new_phases:.1f} s | {card}")

    new_phases = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out, q09c_launches, path_shapes = run_q09c(q88_cols, q88_valid, dev, K,
                                               card)
    shapes += path_shapes
    print(f"phase 16: q09c's three bands equal to numpy (counts "
          f"{check_q09c(out, q88_cols, q88_valid)}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    # an eighth of the task: reading a whole task's trace took 35-41 s,
    # a quarter's 9.7 s
    q09c_map = q09c_plans()[0]
    profile_task("phase 16: q09c map task 0, its first eighth",
                 lambda: map_task(0, q88_cols, q88_valid,
                                  InProcessShuffleService(), dev, q09c_map,
                                  "q09c", n_maps=8 * N_MAPS), card)
    t = time.perf_counter()
    icols, ivalid = make_item(args.seed)
    print(f"phase 16: {len(icols[0])} item rows made in "
          f"{time.perf_counter() - t:.2f} s")
    out, q41d_launches, path_shapes = run_q41d(icols, ivalid, dev, K, card)
    shapes += path_shapes
    print(f"phase 16: q41d's {len(out['i_brand'][0])} rows (of "
          f"{check_q41d(out, icols, ivalid)} groups, the null groups first) "
          f"equal to Python's sort | {card}")
    del icols, ivalid
    no_spills("16", card)

    t = time.perf_counter()
    ccols, cvalid = make_customer()
    print(f"phase 17: {len(ccols[0])} customer rows made in "
          f"{time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    q01_tables = {"store_returns": (rcols, rvalid),
                  "customer": (ccols, cvalid)}
    q01_maps = {"store_returns": N_RETURN_MAPS, "customer": N_CUSTOMER_MAPS}
    q = JoinQuery("q01", q01_tables, q01_maps, dev, K).run()
    q.report(17, card)
    shapes += q.shapes
    q01_whole_launches = q.total_launches()
    stores = check_q01([_blocks_numpy(q.blocks["broadcast:q01:3"],
                                      ("avg_store_sk", "threshold"))],
                       rcols, rvalid)
    over = int(q01_ctr(rcols, rvalid)[4].sum())
    if q.rows_written("shuffle:q01:5") != over:
        raise AssertionError(f"q01: the broadcast join and filter kept "
                             f"{q.rows_written('shuffle:q01:5')} rows, "
                             f"numpy {over}")
    per_part = check_q01_customer(q.blocks["shuffle:q01:6"], ccols, K)
    jcols, jvalid, offsets = make_q01_join(rcols, rvalid, K)
    first, last = check_q01_top(q.out(), q.blocks["shuffle:q01:7"], jcols,
                                offsets)
    print(f"phase 17: q01 whole: thresholds of {stores} stores, the "
          f"broadcast join's {over} rows over them, customer rows per "
          f"partition {per_part}, each task's top 100 of the sort-merge "
          f"join's {len(jcols[0])} rows and the top 100 c_customer_id "
          f"({first} .. {last}) equal to numpy, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    # phase 27 runs q01 again through the session
    stage_inputs = {"q01": (q01_tables, q01_maps, q.out(),
                            lambda out: check_q01_ids(out, jcols))}
    q01_tasks = sum(len(r) for r in q.results.values())
    del q, jvalid, ccols, cvalid, rcols, rvalid
    no_spills("17", card)

    scols, svalid = make_string_keys(args.seed,
                                     min(STRING_KEY_ROWS, args.rows))
    outs, string_launches, path_shapes = run_string_keys(scols, svalid, dev,
                                                         K, card)
    shapes += path_shapes
    print(f"phase 18: {check_string_keys(outs, scols, svalid)} string-key "
          f"groups (one null) equal to Python, each in Spark's partition of "
          f"its key | {card}")
    del outs
    no_spills("18", card)
    print(f"phases 16-18: {time.perf_counter() - new_phases:.1f} s | {card}")
    check_join_types(dev, args.seed, card)

    new_phases = time.perf_counter()
    check_join_types(dev, args.seed, card, keys="string")
    no_spills("19", card)
    check_string_compare(scols, svalid, cols, valid, dev, card)
    check_windows(scols, svalid, cols, valid, dev, card)
    del scols, svalid
    no_spills("20", card)
    slice9_launches = {}
    t = time.perf_counter()
    rows = args.rows
    ones = np.ones(rows, bool)
    item_k, store_k, store_v, profit, profit_v = make_ss_keys(rows, args.seed)
    date_sk, date_v = make_sold_date_sk(rows, args.seed)
    store = make_store()
    (dsk, dmoy, dyear), dvalid = make_date_dim()
    item_cat, item_manu = make_item_dims(args.seed)
    print(f"phases 21-24: store_sales' date, item, store and net profit "
          f"({rows} rows), store, date_dim and item made in "
          f"{time.perf_counter() - t:.2f} s")
    ss = ([date_sk, store_k, cols[1], cols[2], profit],
          [date_v, store_v, valid[1], valid[2], profit_v])
    q13a_tables = {"store_sales": ss, "store": store,
                   "date_dim": ([dsk, dyear], dvalid[:2])}
    q13a_maps = {"store_sales": N_MAPS, "store": 1, "date_dim": 1}
    q = run_slice9_query("q13a", q13a_tables, q13a_maps, dev, K, card)
    shapes += q.shapes
    slice9_launches["q13a"] = q.total_launches()
    print(f"phase 21: q13a whole: its {check_q13a(q.out(), *ss)} state "
          f"groups equal to numpy, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    stage_inputs["q13a"] = (q13a_tables, q13a_maps, q.out(),
                            functools.partial(check_q13a, ss=ss[0],
                                              ssv=ss[1]))
    del q, ss
    no_spills("21", card)
    ss = ([item_k, store_k, cols[2], cols[1]],
          [ones, store_v, valid[2], valid[1]])
    q = run_slice9_query("q65w", {"store_sales": ss},
                         {"store_sales": N_MAPS}, dev, K, card)
    shapes += q.shapes
    slice9_launches["q65w"] = q.total_launches()
    groups = check_q65w(q.out(), ss[0][:3], ss[1][:3])
    stage_inputs["q65w"] = ({"store_sales": ss}, {"store_sales": N_MAPS},
                            q.out(), functools.partial(
                                check_q65w, ss=ss[0][:3], ssv=ss[1][:3]))
    window_rows = [sum(b.num_rows for b in part)
                   for part in q.blocks["shuffle:q65w:1"]]
    print(f"phase 22: q65w whole: {groups} (store, item) groups, window "
          f"tasks of {window_rows} rows, the top {Q65W_TOP} of the first "
          f"{200 // Q65W_TOP} stores and their ranks equal to numpy, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    win = q.plans["shuffle:q65w:2"]
    res = q.registry(win)
    profile_task("phase 22: q65w window task 0",
                 lambda: q.run_task("shuffle:q65w:2", 0,
                                    InProcessShuffleService(), res), card,
                 batches=len(res.get("shuffle:q65w:1").for_partition(0)))
    # phase 28 runs window task 0 again: its blocks wait in host memory,
    # so that phases 23-27's device peaks read as before
    from auron_tpu_torch.memmgr.spill import HostMemSpill
    held = HostMemSpill()
    held.write_batches(q.blocks["shuffle:q65w:1"][0])
    spill_window = (win, q.tasks(win)[0],
                    list(q.plans).index("shuffle:q65w:2") + 1, held)
    del q, ss, res
    no_spills("22", card)
    ss = ([item_k, store_k, cols[1]], [ones, store_v, valid[1]])
    q = run_slice9_query("q27r", {
        "store_sales": ss, "store": store, "item": item_cat},
        {"store_sales": N_MAPS, "store": 1, "item": 1}, dev, K, card)
    shapes += q.shapes
    slice9_launches["q27r"] = q.total_launches()
    expand_rows = q.rows_written("shuffle:q27r:4")
    print(f"phase 23: q27r whole: {check_q27r(q.out(), *ss)} groups equal "
          f"to numpy, {expand_rows} partial rows written, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    del q, ss
    no_spills("23", card)
    t = time.perf_counter()
    channels = [([date_sk, item_k, np.round(cols[1] * cols[2], 2)],
                 [date_v, ones, valid[1] & valid[2]]),
                make_channel(SF10_CATALOG_SALES_ROWS * rows //
                             SF10_STORE_SALES_ROWS, args.seed, 331),
                make_channel(SF10_WEB_SALES_ROWS * rows //
                             SF10_STORE_SALES_ROWS, args.seed, 332)]
    print(f"phase 24: catalog_sales ({len(channels[1][0][0])} rows) and "
          f"web_sales ({len(channels[2][0][0])} rows) made in "
          f"{time.perf_counter() - t:.2f} s")
    q = run_slice9_query("q33b", {
        **dict(zip((table for table, _ in CHANNELS), channels)),
        "item": item_manu, "date_dim": ([dsk, dyear, dmoy], dvalid)},
        {"store_sales": N_MAPS, "catalog_sales": N_CATALOG_MAPS,
         "web_sales": N_WEB_MAPS, "item": 1, "date_dim": 1}, dev, K, card)
    shapes += q.shapes
    slice9_launches["q33b"] = q.total_launches()
    print(f"phase 24: q33b whole: the top 100 of "
          f"{check_q33b(q.out(), channels, item_manu[0][1])} manufacturers "
          f"equal to numpy, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    del q, channels, profit, profit_v, date_sk, date_v
    no_spills("24", card)
    print(f"phases 19 (string keys) and 20-24: "
          f"{time.perf_counter() - new_phases:.1f} s | {card}")

    new_phases = time.perf_counter()
    sf10_launches, serial_launches = run_sf10_session(
        stage_inputs, (q01_tasks, q01_whole_launches), dev, K, card)
    del stage_inputs, q01_tables, jcols
    runner, corpus_launches = run_corpus(dev, K, card)
    profile_corpus_query(runner, dev, card)
    no_spills("27", card)
    print(f"phase 27: {time.perf_counter() - new_phases:.1f} s | {card}")
    run_phase30(runner, dev, K, card)
    no_spills("30", card)
    p31_launches = run_phase31(runner, cols, valid, dev, K, card)
    del runner
    no_spills("31", card)

    spill_launches = run_spill_phase(cols, valid, (item_k, store_k, store_v),
                                     spill_window, dev, K, args.seed, card,
                                     shapes)
    del spill_window, item_k, store_k, store_v

    p29_launches = run_phase29(cols, valid, dev, K, args.seed, card, shapes)
    no_spills("29", card)

    errs = check_path_shapes(K, dev, rng, shapes)
    max_err, hist_err = max(max_err, errs["hash_pid"]), \
        max(hist_err, errs["hist"])

    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all "
          f"| {card}")
    print(json.dumps({"kernels": [{
        "name": "hash_partition_ids_i64", "route": "cuda",
        "source": "auron_tpu_torch/csrc/hash_pid.cu",
        "replaces": "auron_tpu/ops/kernels_pallas.py:89",
        "launches": launches["hash_partition_ids_i64"],
        "launches_by_path": {
            "hash_group_by": launches["hash_partition_ids_i64"],
            "global_sort": sort_launches["hash_partition_ids_i64"],
            "q96": q96_launches["hash_partition_ids_i64"],
            "q88c": q88_launches["hash_partition_ids_i64"],
            "q01_stages": q01_launches["hash_partition_ids_i64"],
            "q17m": q17m_launches["hash_partition_ids_i64"],
            "float_keys": float_launches["hash_partition_ids_i64"],
            "q39v": q39v_launches["hash_partition_ids_i64"],
            "q09c": q09c_launches["hash_partition_ids_i64"],
            "q41d": q41d_launches["hash_partition_ids_i64"],
            "q01": q01_whole_launches["hash_partition_ids_i64"],
            "string_keys": string_launches["hash_partition_ids_i64"],
            **{q: la["hash_partition_ids_i64"] for q, la in slice9_launches.items()},
            "sf10_session_stage": sf10_launches["hash_partition_ids_i64"],
            "q01_session_serial": serial_launches["hash_partition_ids_i64"],
            "corpus": corpus_launches["hash_partition_ids_i64"],
            **{f"spill_{t}": la["hash_partition_ids_i64"]
               for t, la in spill_launches.items()},
            **{p: la["hash_partition_ids_i64"] for p, la in p29_launches.items()},
            **{f"phase31_{p}": la["hash_partition_ids_i64"]
               for p, la in p31_launches.items()}},
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}, {
        "name": "radix_bucket_hist", "route": "cuda",
        "source": "auron_tpu_torch/csrc/radix_hist.cu",
        "replaces": "auron_tpu/ops/kernels_pallas.py:158",
        "launches": sort_launches["radix_bucket_hist"],
        "launches_by_path": {
            "hash_group_by": launches["radix_bucket_hist"],
            "global_sort": sort_launches["radix_bucket_hist"],
            "q96": q96_launches["radix_bucket_hist"],
            "q88c": q88_launches["radix_bucket_hist"],
            "q01_stages": q01_launches["radix_bucket_hist"],
            "q17m": q17m_launches["radix_bucket_hist"],
            "float_keys": float_launches["radix_bucket_hist"],
            "q39v": q39v_launches["radix_bucket_hist"],
            "q09c": q09c_launches["radix_bucket_hist"],
            "q41d": q41d_launches["radix_bucket_hist"],
            "q01": q01_whole_launches["radix_bucket_hist"],
            "string_keys": string_launches["radix_bucket_hist"],
            **{q: la["radix_bucket_hist"] for q, la in slice9_launches.items()},
            "sf10_session_stage": sf10_launches["radix_bucket_hist"],
            "q01_session_serial": serial_launches["radix_bucket_hist"],
            "corpus": corpus_launches["radix_bucket_hist"],
            **{f"spill_{t}": la["radix_bucket_hist"]
               for t, la in spill_launches.items()},
            **{p: la["radix_bucket_hist"] for p, la in p29_launches.items()},
            **{f"phase31_{p}": la["radix_bucket_hist"]
               for p, la in p31_launches.items()}},
        "max_abs_err": hist_err, **hist_json}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

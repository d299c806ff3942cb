#!/usr/bin/env python3
"""On-card smoke run of auron_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--rows N] [--seed S]

Needs one CUDA card and the CUDA toolkit; builds the port's kernels from
the sources in this checkout.  Phases, each fatal on failure:

1. print the card (`nvidia-smi` name and power limit) and CUDA version,
   build both kernels (hash-pid and radix histogram, one nvcc each,
   started together) and print the build time;
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
9. profile one sort map task and one sort reduce task;
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
    profile the first quarter of one map task;
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
    on every batch of the one-key exchange; profile one sort-merge join
    task; then a group-by of 2^20 rows by a float64 key holding -0.0,
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
    every (rows, n_parts) the writers of phases 3-14, 16-18 and 21-24
    gave it, as their metrics report them;
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
    Python's sort; profile one q09c map task;
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
    and SortMergeJoin streaming and whole-side, over two sides of 2^16
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
25. run q01, q13a and q65w whole through the port's session
    (`AuronSession.execute_converted`) on the data and plans of phases
    17, 21 and 22 (`from_stage_plans` over `join_query_plans`): each on
    the stage executor (`spmd` true), a cold execute and a warm one
    (which uploads nothing), each equal to its phase's serial result
    (the warm one to numpy too), neither kernel launched; print wall
    time, host syncs,
    bytes uploaded and peak memory of each; profile q01's warm stage
    execute; run q01 once more with `auron.spmd.singleDevice.enable`
    off, through the session's serial path: equal to phase 17, with
    phase 17's tasks and kernel launches;
26. run q01, q13a and q65w from their foreign plans, built by the port's
    `it/queries.py` over a catalog of the same tables (the IT schema's
    names and types, one chunk a split): the port's convert provider
    `ScanSourceProvider` claims every scan, and the script's foreign
    engine (`CardEngine`) serves each as a SourceTable, one split a file
    group; `AuronSession.execute` tags, converts and runs each on the
    stage path, native but for the scans (the only foreign sections, as
    the JAX package counts them, are the plan's scans, each served once,
    and the engine refuses any other node), cold and warm (the warm
    execute uploads nothing),
    each equal to phase 25's result (the warm one to numpy too), neither
    kernel launched; print the host time of tagging and conversion, the execute
    times, host syncs and bytes uploaded; run q01 once more with
    `auron.spmd.singleDevice.enable` off: equal to phase 17, both kernels
    launched, and phase 25's serial launches where the task counts are
    equal.
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


def _schema(*fields):
    """A Schema of (name, "i32" | "i64" | "f64" | "str"[, nullable])
    fields."""
    from auron_tpu_torch.ir.schema import DataType, Field, Schema
    types = {"i32": DataType.int32(), "i64": DataType.int64(),
             "f64": DataType.float64(), "str": DataType.string()}
    return Schema.of(*(Field(n, types[t], nullable=nullable)
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
    """Phase 9: an eighth of sort map task 0 (the first of 64 splits:
    reading a whole task's trace took 112-168 s on an H100, a quarter's
    41-48 s) and one sort reduce task."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    scratch = InProcessShuffleService()
    profile_task("phase 9: sort map task 0, its first eighth",
                 lambda: map_task(0, cols, valid, scratch, dev, plans[0],
                                  "sort", n_maps=8 * N_MAPS), card)
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
# the session and the stage executor: q01, q13a and q65w whole-table
# (phase 25)
# ---------------------------------------------------------------------------

STAGE_QUERIES = ("q01", "q13a", "q65w")


def session_query(name, tables, n_maps):
    """(root, ConvertContext, sources) of a query as its phase runs it:
    `from_stage_plans` over `join_query_plans`, each table a SourceTable
    split `n_maps[table]` ways into batch-size items, as
    `join_stage_task` feeds a task."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.frontend.converters import from_stage_plans
    from auron_tpu_torch.ops.scan.ipc import SourceTable
    root, ctx = from_stage_plans(join_query_plans(name, n_maps), n_maps)
    bs = int(conf.get("auron.batch.size"))
    sources = {t: SourceTable.from_columns(cols, valid, n_maps.get(t, 1),
                                           bs)
               for t, (cols, valid) in tables.items()}
    return root, ctx, sources


def same_result(what, got, exp, phase: int = 25) -> None:
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


def count_syncs(fn) -> int:
    """The synchronizing CUDA operations torch's sync debug mode flags
    while `fn` runs (one warning each)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def run_stage_queries(queries, dev, K, card: str, results=None) -> dict:
    """Each of `queries`, {name: (tables, n_maps, serial out, numpy
    check)}, through the session twice, cold (the source cache emptied)
    and warm: the stage path, the serial result, numpy's check (on the
    warm run), no kernel launch, nothing uploaded when warm.  Returns the launches of
    each query's two executes; `results` gets each warm result's
    columns."""
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.parallel.stage import clear_source_caches
    session = AuronSession()
    launches = {}
    for name, (tables, n_maps, serial, check) in queries.items():
        root, ctx, sources = session_query(name, tables, n_maps)
        clear_source_caches()
        K.reset_launches()
        warm_bytes = None
        for run in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = session.execute_converted(root, ctx, sources, dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if not res.spmd:
                raise AssertionError(f"phase 25: {name} fell back to the "
                                     f"serial path: {res.spmd_rejection}")
            same_result(f"{name} {run} against its serial result",
                        res.columns, serial)
            # numpy's check once, on the warm run: both equal the serial
            # result, which its phase held to numpy
            checked = f"{check(res.columns)} equal to numpy" \
                if run == "warm" else "numpy's check on the warm run"
            m = res.metrics
            warm_bytes = m["bytes_uploaded"]
            print(f"phase 25: {name} {run} stage execute {secs:.4f} s, "
                  f"{m['host_syncs']} host syncs, {m['bytes_uploaded']} "
                  f"bytes uploaded ({m['source_cache_hits']} source cache "
                  f"hits), {m['gathered_rows']} rows gathered, "
                  f"{res.num_rows} out ({checked}), peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                  f"| {card}")
        launches[name] = dict(K.LAUNCHES)
        if results is not None:
            results[name] = res.columns
        if warm_bytes != 0 or any(launches[name].values()):
            raise AssertionError(f"phase 25: {name}: the warm execute "
                                 f"uploaded {warm_bytes} bytes; launches "
                                 f"{launches[name]}")
    return launches


def run_session_serial(name, tables, n_maps, serial, dev, K, card: str):
    """One execute with the stage executor off: the session's serial
    path.  Returns (launches, serial tasks)."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.frontend.session import AuronSession
    root, ctx, sources = session_query(name, tables, n_maps)
    K.reset_launches()
    with conf.scoped({"auron.spmd.singleDevice.enable": False}):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = AuronSession().execute_converted(root, ctx, sources, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    if res.spmd:
        raise AssertionError(f"phase 25: {name} took the stage path with "
                             f"it off")
    same_result(f"{name} serial session against its phase", res.columns,
                serial)
    launches = dict(K.LAUNCHES)
    tasks = res.metrics["serial_tasks"]
    print(f"phase 25: {name} through the session's serial path "
          f"{secs:.3f} s, {tasks} tasks, {launches['hash_partition_ids_i64']} "
          f"hash-pid, {launches['radix_bucket_hist']} radix-hist launches "
          f"| {card}")
    return launches, tasks


def profile_stage_query(name, tables, n_maps, dev, card: str) -> None:
    """Where q01's warm stage execute goes (profile_task), and the host
    syncs torch's sync debug mode sees in one more warm execute."""
    from auron_tpu_torch.frontend.session import AuronSession
    root, ctx, sources = session_query(name, tables, n_maps)
    session = AuronSession()

    def execute():
        return session.execute_converted(root, ctx, sources, dev)
    execute()
    profile_task(f"phase 25: {name} warm stage execute", execute, card)
    counted = execute().metrics["host_syncs"]
    print(f"phase 25: {name} warm stage execute: {count_syncs(execute)} "
          f"synchronizing operations seen by torch's sync debug mode, "
          f"{counted} host syncs counted by the executor | {card}")


# ---------------------------------------------------------------------------
# Phase 26: q01, q13a and q65w from their foreign plans
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


def foreign_catalog(name, tables, n_maps):
    """The port's IT catalog over a phase's tables: each table's schema
    its columns, its chunks `<table>/part-<k>`, one a split (a table of
    one split, one chunk)."""
    from auron_tpu_torch.it.datagen import Catalog, TableDef
    return Catalog("card", {
        t: TableDef(t, _schema(*FOREIGN_TABLES[name][t]),
                    [f"{t}/part-{k:05d}" for k in range(n_maps.get(t, 1))])
        for t in tables})


def only_scans_went_foreign(what, res, plan, engine, scans_before):
    """Phase 26's check that a query ran natively but for its scans: the
    root converted, the only foreign sections (the JAX package's count,
    `SessionResult.foreign_sections`) the plan's FileSourceScanExec
    nodes, each a child-less source the engine served once in this
    execute (`CardEngine` refuses any other node)."""
    n_scans = []
    plan.foreach(lambda n: n_scans.append(1)
                 if n.op == "FileSourceScanExec" else None)
    sources = list(res.ctx.sources.values())
    served = engine.scans - scans_before
    if type(res.converted).__name__ == "ForeignWrap" or \
            any(s.node.children or s.node.node.op != "FileSourceScanExec"
                for s in sources) or \
            not res.foreign_sections == len(sources) == len(n_scans) == \
            served:
        raise AssertionError(
            f"phase 26: {what}: root {type(res.converted).__name__}, "
            f"{res.foreign_sections} foreign sections "
            f"({[s.node.node.op for s in sources]}), {len(n_scans)} scans "
            f"in the plan, {served} served")


class CardEngine:
    """The foreign engine of phase 26: it answers a scan from the
    phase's host tables, one split a file group (each chunk a contiguous
    split, as `SourceTable.from_columns` cuts it), and keeps each table
    it made, so a repeat execute gets the same object (the stage
    executor's source cache keys by identity).  Pushed filters only
    prune: a `FilterExec` above the scan applies them.  Any other node
    fails the run: these plans convert whole."""

    def __init__(self, tables, catalog):
        self.tables, self.catalog = tables, catalog
        self.made = {}
        self.scans = 0

    def execute(self, node, child_tables):
        from auron_tpu_torch.config import conf
        from auron_tpu_torch.ops.scan.ipc import SourceTable
        if node.op != "FileSourceScanExec":
            raise AssertionError(f"phase 26: {node.op} went to the foreign "
                                 f"engine")
        self.scans += 1
        groups = tuple(tuple(g) for g in node.attrs["file_groups"])
        table = groups[0][0].split("/")[0]
        names = tuple(node.output.names())
        key = (table, names, groups)
        if key not in self.made:
            chunks = self.catalog.tables[table].chunks
            if [c for g in groups for c in g] != chunks or \
                    any(len(g) != 1 for g in groups):
                raise AssertionError(f"phase 26: {table}'s groups {groups}")
            cols, valid = self.tables[table]
            idx = [self.catalog.tables[table].schema.index_of(n)
                   for n in names]
            self.made[key] = SourceTable.from_columns(
                [cols[i] for i in idx], [valid[i] for i in idx],
                len(groups), int(conf.get("auron.batch.size")))
        return self.made[key]


def run_foreign_queries(queries, stage_results, dev, K, card: str) -> dict:
    """Phase 26: each of `queries` ({name: (tables, n_maps, serial out,
    numpy check)}) built as its foreign plan by the port's
    `it/queries.py` and run through `AuronSession.execute` twice, cold
    (the source cache emptied) and warm: the stage path, native but for
    the scans (`only_scans_went_foreign`), phase 25's result, numpy's check, no kernel launch, nothing uploaded
    when warm (numpy's check on the warm run).  Returns the launches of
    each query's two executes."""
    from auron_tpu_torch.frontend import converters as C
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.it import queries as Q
    from auron_tpu_torch.parallel.stage import clear_source_caches
    provider = C.ScanSourceProvider()
    C.register_provider(provider)
    launches = {}
    try:
        for name, (tables, n_maps, _, check) in queries.items():
            catalog = foreign_catalog(name, tables, n_maps)
            session = AuronSession(foreign_engine=CardEngine(tables,
                                                             catalog))
            clear_source_caches()
            K.reset_launches()
            warm_bytes = None
            for run in ("cold", "warm"):
                plan = Q.build(name, catalog)
                scans_before = session.foreign_engine.scans
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.execute(plan, dev)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                if not res.spmd:
                    raise AssertionError(
                        f"phase 26: {name} {run}: off the stage path "
                        f"({res.spmd_rejection})")
                only_scans_went_foreign(f"{name} {run}", res, plan,
                                        session.foreign_engine,
                                        scans_before)
                same_result(f"{name} {run} against phase 25", res.columns,
                            stage_results[name], phase=26)
                checked = f"{check(res.columns)} equal to numpy" \
                    if run == "warm" else "numpy's check on the warm run"
                m = res.metrics
                warm_bytes = m["bytes_uploaded"]
                print(f"phase 26: {name} {run} execute {secs:.4f} s, tag "
                      f"and convert {res.convert_s * 1e3:.3f} ms, "
                      f"{m['host_syncs']} host syncs, {m['bytes_uploaded']} "
                      f"bytes uploaded ({m['source_cache_hits']} source "
                      f"cache hits), {session.foreign_engine.scans} scans "
                      f"served, {res.num_rows} rows out ({checked}) | {card}")
            launches[name] = dict(K.LAUNCHES)
            if warm_bytes != 0 or any(launches[name].values()):
                raise AssertionError(f"phase 26: {name}: the warm execute "
                                     f"uploaded {warm_bytes} bytes; "
                                     f"launches {launches[name]}")
    finally:
        C.unregister_provider(provider)
    return launches


def run_foreign_serial(name, tables, n_maps, serial, dev, K, card: str):
    """Phase 26: the foreign plan once more with the stage executor off,
    on the session's serial path.  Returns (launches, serial tasks)."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.frontend import converters as C
    from auron_tpu_torch.frontend.session import AuronSession
    from auron_tpu_torch.it import queries as Q
    catalog = foreign_catalog(name, tables, n_maps)
    provider = C.ScanSourceProvider()
    C.register_provider(provider)
    K.reset_launches()
    engine = CardEngine(tables, catalog)
    plan = Q.build(name, catalog)
    try:
        with conf.scoped({"auron.spmd.singleDevice.enable": False}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = AuronSession(foreign_engine=engine).execute(plan, dev)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        C.unregister_provider(provider)
    if res.spmd:
        raise AssertionError(f"phase 26: serial {name} took the stage path")
    only_scans_went_foreign(f"serial {name}", res, plan, engine, 0)
    same_result(f"{name} serial execute against its phase", res.columns,
                serial, phase=26)
    launches = dict(K.LAUNCHES)
    tasks = res.metrics["serial_tasks"]
    print(f"phase 26: {name} from its foreign plan on the serial path "
          f"{secs:.3f} s, {tasks} tasks, "
          f"{launches['hash_partition_ids_i64']} hash-pid, "
          f"{launches['radix_bucket_hist']} radix-hist launches | {card}")
    return launches, tasks


def check_path_shapes(K, dev, rng, shapes) -> dict:
    """Phase 15, run last: each kernel at each (kernel, rows, n_parts) a
    path of phases 3-14, 16-18 and 21-24 gave it, held bit-exact against its
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
    print(f"phase 15: every kernel shape of phases 3-14, 16-18 and 21-24 "
          f"bit-exact "
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
    t = time.perf_counter()
    K.build()
    print(f"phase 1: built {sorted(K.SOURCES)} in "
          f"{time.perf_counter() - t:.2f} s")

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

    q88_cols, q88_valid = [cols[1], cols[2]], [valid[1], valid[2]]
    out, q88_launches, path_shapes = run_global_query(
        "q88c", q88_cols, q88_valid, dev, K, card)
    shapes += path_shapes
    print(f"phase 11: q88c bands {check_q88c(out, cols, valid)} equal to "
          f"numpy | {card}")
    q88_map = store_sales_plans("q88c")[0]
    profile_task("phase 11: q88c map task 0, its first quarter",
                 lambda: map_task(0, q88_cols, q88_valid,
                                  InProcessShuffleService(), dev, q88_map,
                                  "q88c", n_maps=4 * N_MAPS), card)

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
    # a 64th of the task: reading a whole task's trace (1.3 million
    # launches) took 471 s on an H100, a sixteenth's 45-50 s
    smj = q.plans["shuffle:q17m:2"]
    profile_task("phase 13: q17m sort-merge join task 0 over the first "
                 "64th of its blocks",
                 lambda: q.run_task("shuffle:q17m:2", 0,
                                    InProcessShuffleService(),
                                    q.registry(smj, cut=64)), card)
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
    print(f"phases 13-14: {time.perf_counter() - new_phases:.1f} s | {card}")

    new_phases = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out, q09c_launches, path_shapes = run_q09c(q88_cols, q88_valid, dev, K,
                                               card)
    shapes += path_shapes
    print(f"phase 16: q09c's three bands equal to numpy (counts "
          f"{check_q09c(out, q88_cols, q88_valid)}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    # a quarter of the task: reading a whole task's trace took 35-41 s
    q09c_map = q09c_plans()[0]
    profile_task("phase 16: q09c map task 0, its first quarter",
                 lambda: map_task(0, q88_cols, q88_valid,
                                  InProcessShuffleService(), dev, q09c_map,
                                  "q09c", n_maps=4 * N_MAPS), card)
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
    # phase 25 runs q01 again through the session
    stage_inputs = {"q01": (q01_tables, q01_maps, q.out(),
                            lambda out: check_q01_ids(out, jcols))}
    q01_tasks = sum(len(r) for r in q.results.values())
    del q, jvalid, ccols, cvalid, rcols, rvalid

    scols, svalid = make_string_keys(args.seed,
                                     min(STRING_KEY_ROWS, args.rows))
    outs, string_launches, path_shapes = run_string_keys(scols, svalid, dev,
                                                         K, card)
    shapes += path_shapes
    print(f"phase 18: {check_string_keys(outs, scols, svalid)} string-key "
          f"groups (one null) equal to Python, each in Spark's partition of "
          f"its key | {card}")
    del outs
    print(f"phases 16-18: {time.perf_counter() - new_phases:.1f} s | {card}")
    check_join_types(dev, args.seed, card)

    new_phases = time.perf_counter()
    check_join_types(dev, args.seed, card, keys="string")
    check_string_compare(scols, svalid, cols, valid, dev, card)
    check_windows(scols, svalid, cols, valid, dev, card)
    del scols, svalid
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
    del q, ss, res
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
    del q, channels, item_k, store_k, store_v, profit, profit_v, date_sk, \
        date_v
    print(f"phases 19 (string keys) and 20-24: "
          f"{time.perf_counter() - new_phases:.1f} s | {card}")

    new_phases = time.perf_counter()
    stage_results = {}
    stage_launches = run_stage_queries(stage_inputs, dev, K, card,
                                       stage_results)
    profile_stage_query("q01", q01_tables, q01_maps, dev, card)
    serial_launches, serial_tasks = run_session_serial(
        "q01", q01_tables, q01_maps, stage_inputs["q01"][2], dev, K, card)
    if serial_tasks != q01_tasks or serial_launches != q01_whole_launches:
        raise AssertionError(
            f"phase 25: q01's serial session ran {serial_tasks} tasks with "
            f"{serial_launches}; phase 17 {q01_tasks} with "
            f"{q01_whole_launches}")
    print(f"phase 25: q01, q13a and q65w on the stage path equal their "
          f"serial results and numpy with no kernel launch, the serial "
          f"session's q01 phase 17's with its {serial_tasks} tasks' "
          f"launches: {time.perf_counter() - new_phases:.1f} s | {card}")

    new_phases = time.perf_counter()
    foreign_launches = run_foreign_queries(stage_inputs, stage_results, dev,
                                           K, card)
    fserial_launches, fserial_tasks = run_foreign_serial(
        "q01", q01_tables, q01_maps, stage_inputs["q01"][2], dev, K, card)
    if fserial_tasks == serial_tasks and fserial_launches != serial_launches:
        raise AssertionError(
            f"phase 26: q01's serial execute ran phase 25's {serial_tasks} "
            f"tasks with {fserial_launches}, phase 25 {serial_launches}")
    if not all(fserial_launches.values()):
        raise AssertionError(f"phase 26: q01's serial execute launched "
                             f"{fserial_launches}")
    print(f"phase 26: q01, q13a and q65w from their foreign plans through "
          f"AuronSession.execute equal phase 25 and numpy, native but "
          f"for their scans on the stage path with no kernel launch; the serial q01 phase "
          f"17's in {fserial_tasks} tasks (phase 25: {serial_tasks}): "
          f"{time.perf_counter() - new_phases:.1f} s | {card}")
    del stage_inputs, q01_tables, jcols, stage_results

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
            **{f"{q}_stage": la["hash_partition_ids_i64"]
               for q, la in stage_launches.items()},
            "q01_session_serial": serial_launches["hash_partition_ids_i64"],
            **{f"{q}_foreign": la["hash_partition_ids_i64"]
               for q, la in foreign_launches.items()},
            "q01_foreign_serial": fserial_launches["hash_partition_ids_i64"]},
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
            **{f"{q}_stage": la["radix_bucket_hist"]
               for q, la in stage_launches.items()},
            "q01_session_serial": serial_launches["radix_bucket_hist"],
            **{f"{q}_foreign": la["radix_bucket_hist"]
               for q, la in foreign_launches.items()},
            "q01_foreign_serial": fserial_launches["radix_bucket_hist"]},
        "max_abs_err": hist_err, **hist_json}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

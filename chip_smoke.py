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
   1025, 8192, 499499, 2^24+3: its vector path and its tail; n_parts in
   1, 2, 4, 7, 200, which covers every exchange of phases 3-12), on views
   that start off a 16-byte boundary (its scalar path) and on all-null
   keys;
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
5. profile one map task: wall time, device busy time and idle share,
   the top kernels and host ops;
6. hold the radix-histogram kernel bit-exact against its plain version
   on the card: n in {128, 256, 512, 1024, 128 x 131, 8192, 144000,
   524288, 2^20, 2^24} x b_bits in {0, 1, 2, 6, 8} (clusters of 1, 2, 4
   and 8 blocks), all-zero and all-same-digit words, a view off a 16-byte
   boundary (must raise ValueError), and the writer's partition sizes at
   n_parts 1, 2, 4, 7 and 200 on row counts that are not multiples of
   128 (713000 is q01 stage 1's partial groups per task);
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
    every map-side batch went through the radix-histogram kernel (b = 0)
    and none through hash-pid; profile one map task;
11. run q88c whole the same way: 8 map tasks (FFIReader -> Projection of
    three CASE band flags -> partial sums -> single-partition writer) and
    1 reduce task (final sums); check the three band counts exactly;
    profile one map task;
12. run the three aggregate stages of q01's threshold subtree over the
    SF-10 store_returns rows (sampled from the store_sales rows as
    `it/datagen.py` samples them): 4 map tasks (scan -> partial Sum by
    (customer, store) -> hash(4) on both keys), 4 tasks (final Sum ->
    partial Average by store -> hash(2) on the store), 2 tasks (final
    Average -> threshold = avg * 1.2); check one row per store, the null
    store included, against numpy to relative 1e-9, the histogram kernel
    on every writer's batch (b = 2, then b = 1) and hash-pid on every
    batch of the single-key hash(2) writer; profile one stage-1 map task;
    print the seconds phases 10-12 took.
It prints the card's line and one JSON line describing each kernel, then,
as the last line, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
    for n in (1, 3, 127, 1025, 8192, 499_499, 2**24 + 3):
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
          f"(n in 1, 3, 127, 1025, 8192, 499499, 2^24+3 x n_parts 1, 2, 4, "
          f"7, 200; keys[1:] and valid[1:] views; all-null)")
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


def stage_plans():
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType, Field, Schema
    f64, i64 = DataType.float64(), DataType.int64()
    src_schema = Schema.of(Field("ss_customer_sk", i64),
                           Field("ss_quantity", DataType.int32()),
                           Field("ss_sales_price", f64))
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
    map_plan = P.RssShuffleWriter(
        child=P.Agg(child=proj, exec_mode="partial", grouping=key,
                    grouping_names=("ss_customer_sk",), aggs=aggs,
                    agg_names=names),
        partitioning=P.Partitioning(mode="hash", num_partitions=N_REDUCE,
                                    expressions=key),
        rss_resource_id="shuffle_writer")
    state_schema = Schema.of(Field("ss_customer_sk", i64),
                             Field("sum_sales#sum", f64),
                             Field("cnt_sales#count", i64, nullable=False))
    reduce_plan = P.Agg(
        child=P.IpcReader(schema=state_schema, resource_id="shuffle_read"),
        exec_mode="final", grouping=key, grouping_names=("ss_customer_sk",),
        aggs=aggs, agg_names=names)
    return map_plan, reduce_plan


def map_task(m: int, cols, valid, svc, dev, plan=None, shuffle_id="ss",
             source="store_sales", n_maps=N_MAPS):
    """Map task m of n_maps of `plan` (default: the group-by map plan)
    through execute_task_bytes, its scan leaf `source` fed split m of the
    rows, writing into `svc` under `shuffle_id`."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    rows = len(cols[0])
    bs = int(conf.get("auron.batch.size"))
    lo, hi = m * rows // n_maps, (m + 1) * rows // n_maps
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


def profile_task(label: str, fn, card: str) -> None:
    """Where one task's time goes: wall time, summed device time and the
    device's idle share, the top kernels and host ops."""
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
    print(f"{label} under the profiler: wall {wall:.4f} s, "
          f"device busy {busy:.4f} s, idle share {1 - busy / wall:.3f} "
          f"(trace read in {parse_s:.1f} s) | {card}")
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
    """Phase 5: where one group-by map task's time goes."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    profile_task("phase 5: map task 0",
                 lambda: map_task(0, cols, valid, InProcessShuffleService(),
                                  dev), card)


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
    sizes = (128, 256, 512, 1024, 128 * 131, 8192, 144_000, 524_288,
             1 << 20, 1 << 24)
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
    for n in (8192, 1000, 8191, 499_499, 713_000):
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
          "(n in 128, 256, 512, 1024, 16768, 8192, 144000, 524288, 2^20, "
          "2^24 x "
          "b_bits 0, 1, 2, 6, 8: clusters of 1, 2, 4, 8; all-zero and "
          "one-digit words at 8192, 524288); words[1:] raised ValueError; "
          "writer sizes exact at n in 8192, 1000, 8191, 499499, 713000 x "
          "n_parts 1, 2, 4, 7, 200")
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
    from auron_tpu_torch.ir.schema import DataType, Field, Schema
    schema = Schema.of(Field("ss_customer_sk", DataType.int64()),
                       Field("ss_quantity", DataType.int32()),
                       Field("ss_sales_price", DataType.float64()))
    orders = (E.SortExpr(child=E.col("ss_sales_price"), asc=False,
                         nulls_first=False),
              E.SortExpr(child=E.col("ss_customer_sk"), asc=True,
                         nulls_first=True))
    names = tuple(f.name for f in schema)
    map_plan = P.RssShuffleWriter(
        child=P.Projection(
            child=P.FFIReader(schema=schema, resource_id="store_sales"),
            exprs=tuple(E.col(n) for n in names), names=names),
        partitioning=P.Partitioning(mode="range", num_partitions=N_REDUCE,
                                    sort_orders=orders,
                                    range_bounds=bounds),
        rss_resource_id="shuffle_writer")
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
    """Phase 9: one sort map task and one sort reduce task."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    scratch = InProcessShuffleService()
    profile_task("phase 9: sort map task 0",
                 lambda: map_task(0, cols, valid, scratch, dev, plans[0],
                                  "sort"), card)
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
    price x U(0.1, 1.0), 2), each column with NULL_FRACTION nulls."""
    rows = len(cols[0])
    n = max(1, rows * SF10_STORE_RETURNS_ROWS // SF10_STORE_SALES_ROWS)
    rng = np.random.default_rng([seed, 1])
    ridx = rng.choice(rows, n, replace=False)
    cust = cols[0][ridx]
    store = rng.integers(1, SF10_STORES + 1, n, dtype=np.int64)
    amt = np.round(cols[1][ridx].astype(np.float64) * cols[2][ridx] *
                   rng.uniform(0.1, 1.0, n), 2)
    return [cust, store, amt], [rng.random(n) >= NULL_FRACTION
                                for _ in range(3)]


def store_sales_plans(name: str):
    """(map plan, reduce plan) of q96 or q88c in the port's IR, as the JAX
    package's converter lowers them (tests/test_torch_corpus_stages.py
    holds them to its JSON), the parquet scan an FFIReader."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType, Field, Schema
    i32, i64, f64 = DataType.int32(), DataType.int64(), DataType.float64()
    qty, price = E.col("ss_quantity"), E.col("ss_sales_price")

    def lit(v, t):
        return E.Literal(value=v, dtype=t)

    def writer(child):
        return P.RssShuffleWriter(
            child=child, partitioning=P.Partitioning(mode="single",
                                                     num_partitions=1),
            rss_resource_id="shuffle_writer")

    def agg(child, mode, aggs, names):
        return P.Agg(child=child, exec_mode=mode, aggs=aggs, agg_names=names)
    if name == "q96":
        scan = P.FFIReader(schema=Schema.of(
            Field("ss_sold_date_sk", i64), Field("ss_quantity", i32),
            Field("ss_sales_price", f64)), resource_id="store_sales")
        aggs = (E.AggExpr(fn="count", children=(qty,), return_type=i64),)
        filt = P.Filter(child=scan, predicates=(
            E.BinaryExpr(left=qty, op=">=", right=lit(20, i32)),
            E.BinaryExpr(left=price, op="<", right=lit(120.0, f64))))
        states = Schema.of(Field("cnt#count", i64, nullable=False))
        return (writer(agg(filt, "partial", aggs, ("cnt",))),
                P.Limit(child=agg(P.IpcReader(schema=states,
                                              resource_id="shuffle_read"),
                                  "final", aggs, ("cnt",)), limit=100))
    scan = P.FFIReader(schema=Schema.of(Field("ss_quantity", i32),
                                        Field("ss_sales_price", f64)),
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
    states = Schema.of(*(Field(f"{n}#sum", i64) for n in names))
    return (writer(agg(proj, "partial", aggs, names)),
            agg(P.IpcReader(schema=states, resource_id="shuffle_read"),
                "final", aggs, names))


def q01_plans():
    """The three aggregate stages of q01's threshold subtree in the port's
    IR, as the converter lowers them: (stage-1 map plan, stage-2 map plan,
    stage-3 plan)."""
    from auron_tpu_torch.ir import expr as E
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir.schema import DataType, Field, Schema
    i64, f64 = DataType.int64(), DataType.float64()
    cust, store = E.col("sr_customer_sk"), E.col("sr_store_sk")
    keys, key_names = (cust, store), ("sr_customer_sk", "sr_store_sk")
    ctr = (E.AggExpr(fn="sum", children=(E.col("sr_return_amt"),),
                     return_type=f64),)
    avg = (E.AggExpr(fn="avg", children=(E.col("ctr_total_return"),),
                     return_type=f64),)
    scan = P.FFIReader(schema=Schema.of(
        Field("sr_customer_sk", i64), Field("sr_store_sk", i64),
        Field("sr_return_amt", f64)), resource_id="store_returns")
    stage1 = P.RssShuffleWriter(
        child=P.Agg(child=scan, exec_mode="partial", grouping=keys,
                    grouping_names=key_names, aggs=ctr,
                    agg_names=("ctr_total_return",)),
        partitioning=P.Partitioning(mode="hash", num_partitions=4,
                                    expressions=keys),
        rss_resource_id="shuffle_writer")
    ctr_states = Schema.of(Field("sr_customer_sk", i64),
                           Field("sr_store_sk", i64),
                           Field("ctr_total_return#sum", f64))
    final_ctr = P.Agg(child=P.IpcReader(schema=ctr_states,
                                        resource_id="shuffle_read"),
                      exec_mode="final", grouping=keys,
                      grouping_names=key_names, aggs=ctr,
                      agg_names=("ctr_total_return",))
    stage2 = P.RssShuffleWriter(
        child=P.Agg(child=final_ctr, exec_mode="partial", grouping=(store,),
                    grouping_names=("sr_store_sk",), aggs=avg,
                    agg_names=("avg_return",)),
        partitioning=P.Partitioning(mode="hash", num_partitions=2,
                                    expressions=(store,)),
        rss_resource_id="shuffle_writer")
    avg_states = Schema.of(Field("sr_store_sk", i64),
                           Field("avg_return#sum", f64),
                           Field("avg_return#count", i64, nullable=False))
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


def writer_launches(results):
    """(map-side batches, batches whose sizes came from the histogram)."""
    return (sum(r.metrics.get("shuffle_write_batches", 0) for r in results),
            sum(r.metrics.get("sizes_by_hist", 0) for r in results))


def run_global_query(name: str, cols, valid, dev, K, card: str):
    """Phases 10 and 11: q96 or q88c, 8 map tasks into one partition and
    one reduce task.  Returns {column: (data, validity)} and the path's
    launches."""
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
    pushed, by_hist = writer_launches(maps)
    if not pushed or launches["radix_bucket_hist"] != pushed or \
            by_hist != pushed:
        raise AssertionError(f"{name}: radix-hist kernel launched "
                             f"{launches['radix_bucket_hist']} times for "
                             f"{pushed} map-side batches")
    if launches["hash_partition_ids_i64"]:
        raise AssertionError(f"{name}: the single exchange launched the "
                             f"hash kernel")
    phase = {"q96": 10, "q88c": 11}[name]
    print(f"phase {phase}: {name} map stage {map_s:.3f} s "
          f"({len(cols[0]) / map_s:.0f} rows/s), reduce stage "
          f"{reduce_s:.4f} s, {pushed} map-side batches = "
          f"{launches['radix_bucket_hist']} radix-hist launches (b = 0), "
          f"0 hash-pid launches | {card}")
    return out, launches


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
    Returns the stage-3 outputs and the path's launches."""
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
    pushed1, hist1 = writer_launches(maps1)
    pushed2, hist2 = writer_launches(maps2)
    if not pushed1 or after1["radix_bucket_hist"] != pushed1 or \
            hist1 != pushed1 or after1["hash_partition_ids_i64"]:
        raise AssertionError(f"q01 stage 1: {after1} for {pushed1} "
                             f"map-side batches (want the histogram on "
                             f"each, no hash-pid: two keys)")
    stage2 = {k: after2[k] - after1[k] for k in after2}
    if not pushed2 or stage2["radix_bucket_hist"] != pushed2 or \
            hist2 != pushed2 or stage2["hash_partition_ids_i64"] != pushed2:
        raise AssertionError(f"q01 stage 2: {stage2} for {pushed2} "
                             f"map-side batches (want both kernels on each)")
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
    return outs, launches


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
    pushed = sum(r.metrics.get("shuffle_write_batches", 0)
                 for r in map_results)
    written = sum(r.metrics.get("shuffle_write_rows", 0)
                  for r in map_results)
    if launches["hash_partition_ids_i64"] != pushed or pushed == 0:
        raise AssertionError(f"hash-pid kernel launched "
                             f"{launches['hash_partition_ids_i64']} times "
                             f"for {pushed} map-side batches")
    if launches["radix_bucket_hist"] != pushed:
        raise AssertionError(f"radix-hist kernel launched "
                             f"{launches['radix_bucket_hist']} times for "
                             f"{pushed} map-side batches")
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
    sort_pushed = sum(r.metrics.get("shuffle_write_batches", 0)
                      for r in sort_maps)
    if sort_launches["radix_bucket_hist"] != sort_pushed or not sort_pushed:
        raise AssertionError(f"radix-hist kernel launched "
                             f"{sort_launches['radix_bucket_hist']} times "
                             f"for {sort_pushed} map-side batches")
    if sort_launches["hash_partition_ids_i64"]:
        raise AssertionError("the range exchange launched the hash kernel")
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
    out, q96_launches = run_global_query("q96", q96_cols, q96_valid, dev, K,
                                         card)
    print(f"phase 10: q96 count {check_q96(out, cols, valid)} equal to "
          f"numpy | {card}")
    q96_map = store_sales_plans("q96")[0]
    profile_task("phase 10: q96 map task 0",
                 lambda: map_task(0, q96_cols, q96_valid,
                                  InProcessShuffleService(), dev, q96_map,
                                  "q96"), card)
    del q96_cols, q96_valid, date_sk, date_valid

    q88_cols, q88_valid = [cols[1], cols[2]], [valid[1], valid[2]]
    out, q88_launches = run_global_query("q88c", q88_cols, q88_valid, dev,
                                         K, card)
    print(f"phase 11: q88c bands {check_q88c(out, cols, valid)} equal to "
          f"numpy | {card}")
    q88_map = store_sales_plans("q88c")[0]
    profile_task("phase 11: q88c map task 0",
                 lambda: map_task(0, q88_cols, q88_valid,
                                  InProcessShuffleService(), dev, q88_map,
                                  "q88c"), card)

    t = time.perf_counter()
    rcols, rvalid = make_store_returns(cols, valid, args.seed)
    print(f"phase 12: {len(rcols[0])} store_returns rows made in "
          f"{time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    outs, q01_launches = run_q01_stages(rcols, rvalid, dev, K, card)
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
            "q01_stages": q01_launches["hash_partition_ids_i64"]},
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
            "q01_stages": q01_launches["radix_bucket_hist"]},
        "max_abs_err": hist_err, **hist_json}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of auron_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--rows N] [--seed S]

Needs one CUDA card and the CUDA toolkit; builds the port's kernels from
the sources in this checkout.  Phases, each fatal on failure:

1. print the card (`nvidia-smi` name and power limit) and CUDA version,
   build the hash-pid kernel and print the build time;
2. hold the kernel bit-exact against its plain PyTorch version on the
   card, on full-range int64 keys with 10% nulls and on all-null keys;
3. run the TPC-DS shuffled group-by stage pair at SF 10 size through the
   task entry point `execute_task_bytes` on the card: 8 map tasks
   (FFIReader -> Projection -> partial Agg -> RssShuffleWriter, hash on
   ss_customer_sk into 200 partitions) and 200 reduce tasks (IpcReader ->
   final Agg), check the result against a numpy group-by and check that
   every map-side batch went through the kernel;
4. time the kernel and its plain version (CUDA events and the
   profiler's kernel durations);
5. profile one map task: wall time, device busy time and idle share,
   the top kernels and host ops.
It prints one JSON line describing each kernel, then, as the last line,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SF10_STORE_SALES_ROWS = 28_800_991   # TPC-DS store_sales at scale factor 10
SF10_CUSTOMERS = 500_000             # TPC-DS customer at scale factor 10
NULL_FRACTION = 0.04                 # per column, a few percent as in dsdgen
N_MAPS = 8
N_REDUCE = 200                       # spark.sql.shuffle.partitions default
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
NONTENSOR_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores
PID_BYTES_PER_ROW = 13               # 8 key + 1 validity + 4 pid
PID_OPS_PER_ROW = 36                 # murmur3 mixes, fmix, null select, pmod


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
    for n in (1, 127, 8192, 2**24 + 3):
        keys, valid = random_keys(rng, n, dev)
        for n_parts in (1, 7, 200):
            got = K.hash_partition_ids_i64(keys, valid, n_parts)
            exp = K.hash_partition_ids_i64_plain(keys, valid, n_parts)
            torch.cuda.synchronize()
            err = int((got.long() - exp.long()).abs().max())
            worst = max(worst, err)
            if err:
                raise AssertionError(f"hash-pid kernel != plain at n={n} "
                                     f"n_parts={n_parts}: max err {err}")
    keys, _ = random_keys(rng, 8192, dev)
    none = torch.zeros(8192, dtype=torch.bool, device=dev)
    for n_parts in (1, 7, 200):
        got = K.hash_partition_ids_i64(keys, none, n_parts)
        if not bool((got == 42 % n_parts).all()):
            raise AssertionError(f"all-null batch: pids != 42 % {n_parts}")
    print(f"phase 2: hash-pid kernel bit-exact with its plain version "
          f"(n in 1, 127, 8192, 2^24+3 x n_parts 1, 7, 200; all-null)")
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


def map_task(m: int, cols, valid, svc, dev):
    """Map task m through execute_task_bytes, writing into `svc`."""
    from auron_tpu_torch.config import conf
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    rows = len(cols[0])
    bs = int(conf.get("auron.batch.size"))
    lo, hi = m * rows // N_MAPS, (m + 1) * rows // N_MAPS
    res = ResourceRegistry()
    # the front end's scan batches: batch-size slices of the split
    res.put("store_sales", [
        ([c[s:min(s + bs, hi)] for c in cols],
         [v[s:min(s + bs, hi)] for v in valid])
        for s in range(lo, hi, bs)])
    res.put("shuffle_writer", svc.rss_writer("ss", m))
    task = P.TaskDefinition(plan=stage_plans()[0], stage_id=1,
                            partition_id=m, num_partitions=N_MAPS)
    return execute_task_bytes(serde.serialize(task), res, device=dev)


def run_stage_pair(cols, valid, dev):
    """Phase 3: the stage pair through execute_task_bytes.  Returns the
    reduce outputs, the map results and the two stages' seconds."""
    from auron_tpu_torch.ir import plan as P
    from auron_tpu_torch.ir import serde
    from auron_tpu_torch.ops.shuffle.writer import (
        InProcessShuffleService, PartitionedBlocks,
    )
    from auron_tpu_torch.runtime.executor import execute_task_bytes
    from auron_tpu_torch.runtime.resources import ResourceRegistry
    svc = InProcessShuffleService()
    t0 = time.perf_counter()
    map_results = [map_task(m, cols, valid, svc, dev) for m in range(N_MAPS)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = ResourceRegistry()
    res.put("shuffle_read", PartitionedBlocks(
        [svc.reduce_blocks("ss", p) for p in range(N_REDUCE)]))
    reduce_plan = stage_plans()[1]
    outs = []
    for p in range(N_REDUCE):
        task = P.TaskDefinition(plan=reduce_plan, stage_id=2,
                                partition_id=p, num_partitions=N_REDUCE)
        outs.append(execute_task_bytes(serde.serialize(task), res,
                                       device=dev).to_numpy())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return outs, map_results, t1 - t0, t2 - t1


def _device_us(prof) -> float:
    """Summed device time of the kernels and copies in a profile."""
    from torch.autograd import DeviceType
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)
    return total


def profiled_ms(fn, iters: int = 25):
    """Device time of one call from torch.profiler's CUDA trace (kernel
    durations summed, gaps excluded), or None when the trace has none."""
    fn()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = _device_us(prof)
    return us / iters / 1e3 if us > 0 else None


def profile_map_task(cols, valid, dev, card: str) -> None:
    """Phase 5: where one map task's time goes: wall time, summed device
    time and the device's idle share, the top kernels and host ops."""
    from auron_tpu_torch.ops.shuffle.writer import InProcessShuffleService
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        map_task(0, cols, valid, InProcessShuffleService(), dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _device_us(prof) / 1e6
    print(f"phase 5: map task 0 under the profiler: wall {wall:.3f} s, "
          f"device busy {busy:.3f} s, idle share {1 - busy / wall:.3f} "
          f"| {card}")
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    dev_rows = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                      key=lambda e: -(getattr(e, "self_device_time_total",
                                              0.0) or 0.0))[:8]
    for e in dev_rows:
        print(f"phase 5:   device {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:70]}")
    cpu_rows = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:12]
    for e in cpu_rows:
        print(f"phase 5:   host   {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:70]}")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=SF10_STORE_SALES_ROWS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
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
    groups = check_result(outs, cols, valid, K, dev)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 3: map stage {map_s:.3f} s ({args.rows / map_s:.0f} "
          f"rows/s), reduce stage {reduce_s:.3f} s ({written / reduce_s:.0f} "
          f"partial rows/s), {groups} groups equal to numpy, "
          f"{pushed} map-side batches = {launches['hash_partition_ids_i64']} "
          f"kernel launches, peak {peak / 2**30:.3f} GiB | {card}")

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
        pr_k, pr_p = profiled_ms(kernel), profiled_ms(plain)
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
    profile_map_task(cols, valid, dev, card)
    print(json.dumps({"kernels": [{
        "name": "hash_partition_ids_i64", "route": "cuda",
        "source": "auron_tpu_torch/csrc/hash_pid.cu",
        "replaces": "auron_tpu/ops/kernels_pallas.py:89",
        "launches": launches["hash_partition_ids_i64"],
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The shuffled group-by stage pair, auron_tpu_torch against auron_tpu:
the same serialized map and reduce TaskDefinitions over the same rows.
Map: FFIReader -> Projection -> partial Agg -> RssShuffleWriter (hash on
ss_customer_sk); reduce: IpcReader -> final Agg, one task per partition.
"""

import numpy as np
import pytest

from auron_tpu.frontend.session import PartitionedBlocks as JaxBlocks
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.ops.shuffle.writer import InProcessShuffleService as JaxShuffle
from auron_tpu.runtime.executor import execute_task_bytes as jax_execute
from auron_tpu.runtime.resources import ResourceRegistry as JaxResources
from auron_tpu_torch.ops import kernels_cuda as K
from auron_tpu_torch.ops.shuffle.writer import (
    InProcessShuffleService, PartitionedBlocks,
)
from auron_tpu_torch.runtime.executor import execute_task_bytes
from auron_tpu_torch.runtime.resources import ResourceRegistry

import torch_parity as TP

N_PARTS = 8
N_MAPS = 2
NAMES = ("ss_customer_sk",) + TP.AGG_NAMES


def _map_tasks():
    return [jserde.serialize(JP.TaskDefinition(
        plan=TP.map_plan(N_PARTS), stage_id=1, partition_id=m,
        num_partitions=N_MAPS), codec="zlib") for m in range(N_MAPS)]


def _reduce_task(p):
    return jserde.serialize(JP.TaskDefinition(
        plan=TP.reduce_plan(), stage_id=2, partition_id=p,
        num_partitions=N_PARTS), codec="zlib")


def _splits(cols, valid):
    n = len(cols[0])
    return [TP.chunks([c[m * n // N_MAPS:(m + 1) * n // N_MAPS] for c in cols],
                      [v[m * n // N_MAPS:(m + 1) * n // N_MAPS]
                       for v in valid], 2048) for m in range(N_MAPS)]


def _run_port(splits):
    svc = InProcessShuffleService()
    stats = []
    for m, (task, parts) in enumerate(zip(_map_tasks(), splits)):
        res = ResourceRegistry()
        # map 0 hands the port numpy pairs, map 1 arrow batches
        res.put("store_sales",
                parts if m == 0 else [TP.to_arrow(*p) for p in parts])
        res.put("shuffle_writer", svc.rss_writer("ss", m))
        stats.append(execute_task_bytes(task, res, device="cpu"))
    res = ResourceRegistry()
    res.put("shuffle_read", PartitionedBlocks(
        [svc.reduce_blocks("ss", p) for p in range(N_PARTS)]))
    return stats, [execute_task_bytes(_reduce_task(p), res,
                                      device="cpu").to_numpy()
                   for p in range(N_PARTS)]


def _run_jax(splits):
    svc = JaxShuffle()
    for m, (task, parts) in enumerate(zip(_map_tasks(), splits)):
        res = JaxResources()
        res.put("store_sales", [TP.to_arrow(*p) for p in parts])
        res.put("shuffle_writer", svc.rss_writer("ss", m))
        jax_execute(task, res)
    res = JaxResources()
    res.put("shuffle_read", JaxBlocks(
        [svc.reduce_blocks("ss", p) for p in range(N_PARTS)]))
    return [TP.jax_columns(jax_execute(_reduce_task(p), res).batches, NAMES)
            for p in range(N_PARTS)]


def _keys(cols):
    k, v = cols["ss_customer_sk"]
    return {int(x) if ok else None for x, ok in zip(k, v)}


@pytest.mark.parametrize("rows,n_keys", [(20000, 3000), (6000, 40)])
def test_stage_pair_matches_jax(rows, n_keys):
    cols, valid = TP.make_sales(rows, seed=rows, n_keys=n_keys)
    valid[0][::97] = False
    splits = _splits(cols, valid)
    K.reset_launches()
    stats, port = _run_port(splits)
    # on the CPU the wrapper runs the plain version, never the kernel
    assert K.LAUNCHES["hash_partition_ids_i64"] == 0
    assert all(s.metrics["shuffle_write_batches"] == 1 for s in stats)
    pushed = [s.to_numpy()["rows"][0] for s in stats]
    assert sum(int(p.sum()) for p in pushed) == sum(
        s.metrics["shuffle_write_rows"] for s in stats)
    jax = _run_jax(splits)
    for p in range(N_PARTS):
        assert _keys(port[p]) == _keys(jax[p]), f"partition {p}"
    merged = {n: tuple(np.concatenate([o[n][i] for o in port])
                       for i in (0, 1)) for n in NAMES}
    merged_jax = {n: tuple(np.concatenate([o[n][i] for o in jax])
                           for i in (0, 1)) for n in NAMES}
    TP.assert_same_groups(merged, merged_jax)
    got = TP.keyed_rows(merged, "ss_customer_sk", TP.AGG_NAMES)
    assert None in got and got[7] == (None, 0)

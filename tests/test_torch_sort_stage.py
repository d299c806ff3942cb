"""The global-sort stage pair, auron_tpu_torch against auron_tpu: the same
serialized map and reduce TaskDefinitions over the same rows.  Map:
FFIReader -> Projection -> RssShuffleWriter (range partitioning by bounds
sampled as Spark samples them); reduce: IpcReader -> Sort, one task per
partition.  Each reduce partition's rows, and their order, must be the
same in both engines.  The data holds no -0.0 and no NaN, where the
engines differ on purpose (ROADMAP Queue 3), so floats compare exactly:
no arithmetic is done on them."""

import numpy as np
import pytest

from auron_tpu.config import conf as jconf
from auron_tpu.frontend.session import PartitionedBlocks as JaxBlocks
from auron_tpu.ir import plan as JP
from auron_tpu.ir import serde as jserde
from auron_tpu.ops.shuffle.writer import InProcessShuffleService as JaxShuffle
from auron_tpu.runtime.executor import execute_task_bytes as jax_execute
from auron_tpu.runtime.resources import ResourceRegistry as JaxResources
from auron_tpu_torch.config import conf
from auron_tpu_torch.ops import kernels_cuda as K
from auron_tpu_torch.ops.shuffle.writer import (
    InProcessShuffleService, PartitionedBlocks,
)
from auron_tpu_torch.runtime.executor import execute_task_bytes
from auron_tpu_torch.runtime.resources import ResourceRegistry

import chip_smoke
import torch_parity as TP

N_PARTS = 8
N_MAPS = 2
ROWS = 6000
ORDERS = ((False, False), (True, True))       # price desc nl, sk asc nf


def _data(seed):
    """store_sales-shaped rows with many ties: 201 prices, 300 customers."""
    cols, valid = TP.make_sales(ROWS, seed=seed, n_keys=300)
    cols[2] = np.round(cols[2] / 10.0, 0)     # 0..20, ties
    return cols, valid


def _bounds(cols, valid):
    return chip_smoke.range_bounds([cols[2], cols[0]], [valid[2], valid[0]],
                                   ORDERS, N_PARTS, N_MAPS, seed=3)


def _splits(cols, valid):
    return [TP.chunks([c[m * ROWS // N_MAPS:(m + 1) * ROWS // N_MAPS]
                       for c in cols],
                      [v[m * ROWS // N_MAPS:(m + 1) * ROWS // N_MAPS]
                       for v in valid], 1024) for m in range(N_MAPS)]


def _tasks(bounds, limit, offset):
    maps = [jserde.serialize(JP.TaskDefinition(
        plan=TP.sort_map_plan(N_PARTS, bounds), stage_id=3, partition_id=m,
        num_partitions=N_MAPS), codec="zlib") for m in range(N_MAPS)]
    reduces = [jserde.serialize(JP.TaskDefinition(
        plan=TP.sort_reduce_plan(limit, offset), stage_id=4, partition_id=p,
        num_partitions=N_PARTS), codec="zlib") for p in range(N_PARTS)]
    return maps, reduces


def _run_port(splits, maps, reduces):
    svc = InProcessShuffleService()
    stats = []
    for m, (task, parts) in enumerate(zip(maps, splits)):
        res = ResourceRegistry()
        res.put("store_sales", parts)
        res.put("shuffle_writer", svc.rss_writer("sort", m))
        stats.append(execute_task_bytes(task, res, device="cpu"))
    res = ResourceRegistry()
    res.put("shuffle_read", PartitionedBlocks(
        [svc.reduce_blocks("sort", p) for p in range(N_PARTS)]))
    return stats, [execute_task_bytes(t, res, device="cpu")
                   for t in reduces]


def _run_jax(splits, maps, reduces):
    svc = JaxShuffle()
    for m, (task, parts) in enumerate(zip(maps, splits)):
        res = JaxResources()
        res.put("store_sales", [TP.to_arrow(*p) for p in parts])
        res.put("shuffle_writer", svc.rss_writer("sort", m))
        jax_execute(task, res)
    res = JaxResources()
    res.put("shuffle_read", JaxBlocks(
        [svc.reduce_blocks("sort", p) for p in range(N_PARTS)]))
    return [TP.jax_columns(jax_execute(t, res).batches, TP.SORT_NAMES)
            for t in reduces]


def _assert_same_rows(got, exp, p):
    for name in TP.SORT_NAMES:
        gd, gv = got[name]
        ed, ev = exp[name]
        np.testing.assert_array_equal(gv, ev, err_msg=f"{name} p={p}")
        np.testing.assert_array_equal(np.where(gv, gd, 0),
                                      np.where(ev, ed, 0).astype(gd.dtype),
                                      err_msg=f"{name} p={p}")


@pytest.mark.parametrize("strategy", ["auto", "radix"])
@pytest.mark.parametrize("limit,offset", [(None, 0), (40, 0), (25, 30),
                                          (None, 500)])
def test_sort_stage_pair_matches_jax(limit, offset, strategy):
    cols, valid = _data(seed=11)
    bounds = _bounds(cols, valid)
    assert len(bounds) == N_PARTS - 1
    maps, reduces = _tasks(bounds, limit, offset)
    splits = _splits(cols, valid)
    kv = {"auron.kernel.sort.strategy": strategy}
    K.reset_launches()
    with conf.scoped(kv), jconf.scoped(kv):
        stats, results = _run_port(splits, maps, reduces)
        jax = _run_jax(splits, maps, reduces)
    port = [r.to_numpy() for r in results]
    # on the CPU the wrappers run their plain versions, never a kernel
    assert K.LAUNCHES == {k: 0 for k in K.LAUNCHES}
    assert [s.metrics["sizes_by_hist"] for s in stats] == \
        [len(sp) for sp in splits]
    for p in range(N_PARTS):
        _assert_same_rows(port[p], jax[p], p)
    n_out = [len(o["ss_customer_sk"][0]) for o in port]
    if limit is None and offset == 0:
        # the partitions in id order are numpy's stable lexsort
        order = np.lexsort(chip_smoke.spark_lexsort_keys(
            [cols[2], cols[0]], [valid[2], valid[0]], ORDERS))
        assert sum(n_out) == ROWS
        for i, name in enumerate(TP.SORT_NAMES):
            got = np.concatenate([o[name][0] for o in port])
            got_v = np.concatenate([o[name][1] for o in port])
            np.testing.assert_array_equal(got_v, valid[i][order])
            np.testing.assert_array_equal(
                got, np.where(valid[i][order], cols[i][order], 0))
    else:
        full = [r.metrics["sorted_rows"] for r in
                _run_port(splits, *_tasks(bounds, None, 0))[1]]
        assert n_out == [max(0, min(n - offset, limit or n))
                         for n in full]


def test_reduce_sort_runs_in_the_resolved_form():
    """On the CPU 'auto' resolves like the JAX CPU backend: pack-sort from
    auron.kernel.sort.radix.min.rows rows, below it composed argsorts;
    each reduce task's metrics name the form it sorted in."""
    cols, valid = _data(seed=12)
    maps, reduces = _tasks(_bounds(cols, valid), None, 0)
    with conf.scoped({"auron.kernel.sort.radix.min.rows": 1024}):
        _, radix = _run_port(_splits(cols, valid), maps, reduces)
    _, multipass = _run_port(_splits(cols, valid), maps, reduces)
    assert [r.metrics.get("sorted_by_radix") for r in radix] == \
        [1] * N_PARTS
    assert [r.metrics.get("sorted_by_multipass") for r in multipass] == \
        [1] * N_PARTS

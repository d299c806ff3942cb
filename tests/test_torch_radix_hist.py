"""The radix bucket histogram, auron_tpu_torch against auron_tpu: the plain
version (what the wrapper runs on CPU tensors) against the Pallas kernel
in interpret mode and against its jnp twin, bit for bit; the CUDA
kernel's launch shape (a cluster of blocks per tile) and its cluster sum,
emulated in torch, against both; and the shuffle writer's partition
sizes, which come from it, against the JAX writer's counting sort
(`partition_sort`)."""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auron_tpu.native.bindings import partition_sort
from auron_tpu.ops import kernels_pallas as KP
from auron_tpu_torch.columnar.batch import from_numpy
from auron_tpu_torch.ir import expr as E
from auron_tpu_torch.ir import plan as P
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.ops import kernels_cuda as K
from auron_tpu_torch.ops.base import Operator, TaskContext
from auron_tpu_torch.ops.shuffle import writer as W
from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer
from auron_tpu_torch.runtime.resources import ResourceRegistry

SIZES = (128, 4096, 128 * 1031)     # the last has a prime tile count
CASES = [(n, b) for n in SIZES for b in range(9)]
# the main paths' caps (a range map batch; a hash map batch, padded) and
# tile heights 1, 2, 3, 4, 131, 256 and 1031 rows of 128 words
MAIN_CAPS = (8192, 524_288)
CLUSTER_CAPS = MAIN_CAPS + tuple(128 * r for r in (1, 2, 3, 4, 131, 256,
                                                   1031))
CLUSTER_CASES = [(n, b) for n in CLUSTER_CAPS for b in (0, 1, 3, 8)]
SWEEP_CASES = sorted(set(CASES) | set(CLUSTER_CASES))


def _words(n, seed):
    """n random u32 words: (numpy uint32, the port's int32 bit view)."""
    u = np.random.default_rng(seed).integers(0, 1 << 32, n,
                                             dtype=np.uint64) \
        .astype(np.uint32)
    return u, torch.from_numpy(u.view(np.int32).copy())


_SWEEP = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from auron_tpu.ops import kernels_pallas as KP
from test_torch_radix_hist import SWEEP_CASES, _words
out = {}
for n, b in SWEEP_CASES:
    u, _ = _words(n, seed=n + b)
    out[f"{n}_{b}"] = np.asarray(KP.radix_bucket_hist(jnp.asarray(u), b,
                                                      interpret=True))
for b in (9, 12):
    try:
        KP.radix_bucket_hist(jnp.zeros(256, jnp.uint32), b, interpret=True)
    except ValueError:
        out[f"raises_{b}"] = np.array(True)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def pallas_sweep(tmp_path_factory):
    """The Pallas kernel, in interpret mode, over every case, run in a
    process of its own: the sweep compiles one program per (n, b_bits)
    on purpose, and the JAX package's retrace-storm guard, which counts
    the programs of a site per process, is given room for exactly these
    there, so the guard stays as it is for every other test."""
    path = tmp_path_factory.mktemp("pallas") / "sweep.npz"
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               AURON_TPU_AURON_JITCHECK_RETRACE_MAX=str(len(SWEEP_CASES) +
                                                        2),
               PYTHONPATH=os.pathsep.join([str(here), str(here.parent)]))
    proc = subprocess.run([sys.executable, "-c", _SWEEP, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("n,b_bits", CASES)
def test_plain_matches_pallas_and_jnp_twin(n, b_bits, pallas_sweep):
    u, words = _words(n, seed=n + b_bits)
    got = K.radix_bucket_hist(words, b_bits)       # CPU: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  K.radix_bucket_hist_plain(words, b_bits))
    np.testing.assert_array_equal(got.numpy(),
                                  pallas_sweep[f"{n}_{b_bits}"])
    twin = KP.radix_bucket_hist_xla(jnp.asarray(u), b_bits,
                                    tile_rows=K.hist_tile_rows(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(twin))
    assert int(got.sum()) == n


@pytest.mark.parametrize("b_bits", [9, 12, -1])
def test_b_bits_outside_the_range_raise(b_bits, pallas_sweep):
    _, words = _words(256, seed=1)
    with pytest.raises(ValueError):
        K.radix_bucket_hist(words, b_bits)
    if b_bits > 0:      # the Pallas kernel raises there too
        assert pallas_sweep[f"raises_{b_bits}"]


def test_tile_rows_follow_the_pallas_rule():
    assert [K.hist_tile_rows(n) for n in (128, 8192, 144000, 1 << 24,
                                          128 * 1031)] == \
        [1, 64, 225, 256, 1]


LAUNCH_CAPS = sorted(set(CLUSTER_CAPS) |
                     set(range(128, (1 << 16) + 1, 128)))


@pytest.mark.parametrize("cap", LAUNCH_CAPS)
def test_launch_shape_is_whole_clusters_of_whole_vectors(cap):
    tile_rows, cluster = K.hist_launch_shape(cap)
    slice_words = tile_rows * K.LANES // cluster
    assert tile_rows == K.hist_tile_rows(cap)
    assert cluster in (1, 2, 4, 8)
    assert tile_rows % cluster == 0
    # the largest such power of two
    assert cluster == 8 or tile_rows % (2 * cluster)
    assert slice_words * cluster == tile_rows * K.LANES
    assert slice_words * 4 % K.VECTOR_BYTES == 0


def test_launch_shape_at_the_main_paths_caps():
    # a range map batch: one tile, 8 blocks of 1,024 words (one uint4 a
    # thread); a hash map batch: 16 tiles x 8 blocks of 4,096 words
    assert K.hist_launch_shape(8192) == (64, 8)
    assert K.hist_launch_shape(524_288) == (256, 8)
    assert K.hist_launch_shape(128 * 131) == (131, 1)


def _cluster_sum(words, b_bits):
    """The kernel's arithmetic in torch: each tile cut into its cluster's
    slices, each slice counted alone, the slices' counts summed."""
    tile_rows, cluster = K.hist_launch_shape(words.shape[0])
    slices = words.view(-1, cluster, tile_rows * K.LANES // cluster)
    return torch.stack([
        sum(K.radix_bucket_hist_plain(s.contiguous(), b_bits).sum(0)
            for s in tile) for tile in slices]).to(torch.int32)


@pytest.mark.parametrize("n,b_bits", CLUSTER_CASES)
def test_cluster_sum_matches_plain_and_pallas(n, b_bits, pallas_sweep):
    _, words = _words(n, seed=n + b_bits)
    got = _cluster_sum(words, b_bits).numpy()
    np.testing.assert_array_equal(got,
                                  K.radix_bucket_hist_plain(words, b_bits))
    np.testing.assert_array_equal(got, pallas_sweep[f"{n}_{b_bits}"])


def _hash_ids(n, n_parts, seed):
    keys = np.random.default_rng(seed).integers(-2**62, 2**62, n)
    valid = np.random.default_rng(seed + 1).random(n) >= 0.1
    return K.hash_partition_ids_i64(torch.from_numpy(keys),
                                    torch.from_numpy(valid), n_parts)


def _range_ids(n, n_parts, seed):
    rng = np.random.default_rng(seed)
    price = np.round(rng.random(n) * 100, 1)
    valid = rng.random(n) >= 0.05
    schema = Schema.of(Field("p", DataType.float64()))
    bounds = tuple((float(b),) for b in
                   np.linspace(0, 100, n_parts + 1)[1:-1].round(1))
    part = P.Partitioning(
        mode="range", num_partitions=n_parts,
        sort_orders=(E.SortExpr(child=E.col("p"), asc=False,
                                nulls_first=False),),
        range_bounds=bounds)
    b = from_numpy(schema, [price], [valid], device="cpu")
    return PartitionIdComputer(part, schema)(b)


@pytest.mark.parametrize("n_parts", [1, 7, 200, 256, 300])
@pytest.mark.parametrize("ids", ["hash", "range"])
@pytest.mark.parametrize("n", [1000, 8192, 3001])
def test_writer_sizes_match_partition_sort(n, ids, n_parts):
    pids = (_hash_ids if ids == "hash" else _range_ids)(n, n_parts, n)
    _, offsets = partition_sort(pids.numpy(), n_parts)
    exp = np.diff(offsets)
    if n_parts <= 256:
        np.testing.assert_array_equal(W.sizes_by_hist(pids, n_parts), exp)
    np.testing.assert_array_equal(W.sizes_by_bincount(pids, n_parts), exp)


class _Source(Operator):
    def __init__(self, batches):
        super().__init__(batches[0].schema, [])
        self.batches = batches

    def execute(self, ctx):
        yield from self.batches


class _Sink(W.RssPartitionWriter):
    def __init__(self):
        self.blocks = []

    def write(self, partition_id, block):
        self.blocks.append((partition_id, block))


@pytest.mark.parametrize("n_parts,route", [(200, "sizes_by_hist"),
                                           (300, "sizes_by_bincount")])
def test_writer_route_is_fixed_by_n_parts(n_parts, route):
    """Rows keep their input order inside a partition and every row lands
    once; the route taken shows in the writer's metrics."""
    schema = Schema.of(Field("k", DataType.int64()))
    keys = np.arange(3001, dtype=np.int64)
    b = from_numpy(schema, [keys], device="cpu")
    part = P.Partitioning(mode="hash", num_partitions=n_parts,
                          expressions=(E.col("k"),))
    w = W.RssShuffleWriterExec(_Source([b, b]), part, "sink")
    sink = _Sink()
    res = ResourceRegistry()
    res.put("sink", sink)
    list(w.execute(TaskContext(resources=res)))
    assert w.metrics[route] == 2
    assert set(w.metrics) & {"sizes_by_hist", "sizes_by_bincount"} == \
        {route}
    pids = K.hash_partition_ids_i64(b.columns[0].data[:3001],
                                    b.columns[0].validity[:3001], n_parts)
    for pid, block in sink.blocks[:len(sink.blocks) // 2]:
        got = block.columns[0].data[:block.num_rows].numpy()
        np.testing.assert_array_equal(got, keys[pids.numpy() == pid])
    assert sum(blk.num_rows for _, blk in sink.blocks) == 2 * 3001

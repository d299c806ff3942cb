"""RSS shuffle writer and the in-process shuffle service (counterpart of
auron_tpu/ops/shuffle/writer.py).

Rows are grouped by partition on the device, the analogue of the JAX
writer's host counting sort (`native/bindings.py::partition_sort`):
- the partition sizes come from the hand-written radix-histogram kernel
  (`kernels_cuda.radix_bucket_hist`): each partition id goes into the top
  b = ceil_log2(n_parts) bits of a u32 word, and the kernel's per-tile
  counts, summed over the tiles, are the sizes.  That is the kernel's
  contract for n_parts <= 256 (Spark's default 200 gives b = 8); above
  it the writer counts with `torch.bincount`, a route fixed by n_parts
  when the writer is built.  The metrics `sizes_by_hist` and
  `sizes_by_bincount` count the batches of each route;
- the permutation is one stable sort of the ids, so rows keep their
  input order inside a partition, as `partition_sort` keeps it;
- the sizes are the one host read per batch.
Each non-empty partition's rows become one block: a view of the batch's
partition-sorted columns (a string column's bytes, lengths and validity
alike), unpadded (its capacity is its row count), that stays on the
device.

The JAX package frames blocks as Arrow-IPC/v2 bytes (columnar/serde.py),
which needs pyarrow; here a block is pushed as the `Batch` itself, and
the `bytes` column of the writer's output counts the block tensors'
bytes instead of frame bytes (a string column W + 4 + 1 a row).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceColumn, DeviceStringColumn, bucket_capacity,
    concat_batches, from_numpy,
)
from auron_tpu_torch.ir.plan import Partitioning
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.ops.base import Operator, TaskContext
from auron_tpu_torch.ops.kernels_cuda import HIST_MAX_BITS, radix_bucket_hist
from auron_tpu_torch.ops.radix_sort import ceil_log2
from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer


class RssPartitionWriter:
    """What the writer pushes partition blocks into."""

    def write(self, partition_id: int, block: Batch) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass


def sizes_by_hist(pids: torch.Tensor, n_parts: int) -> np.ndarray:
    """Rows per partition (int64[n_parts], on the host) of int32 ids in
    [0, n_parts), n_parts <= 256, from the radix-histogram kernel.

    The words are padded with zeros up to bucket_capacity(n), a multiple
    of 128 whose tiles are whole; the padding lands in bucket 0 and is
    subtracted there."""
    n = int(pids.shape[0])
    b = ceil_log2(n_parts)
    cap = bucket_capacity(n)
    words = torch.zeros(cap, dtype=torch.int32, device=pids.device)
    # the shift in int64, masked to 32 bits, then the int32 bit view
    words[:n] = ((pids.to(torch.int64) << (32 - b)) & 0xFFFFFFFF) \
        .to(torch.int32)
    sizes = radix_bucket_hist(words, b).sum(0)[:n_parts].cpu().numpy()
    sizes[0] -= cap - n
    return sizes


def sizes_by_bincount(pids: torch.Tensor, n_parts: int) -> np.ndarray:
    """Rows per partition for any n_parts, by torch.bincount."""
    return torch.bincount(pids, minlength=n_parts).cpu().numpy()


def split_column(c: Column, order: torch.Tensor, split: List[int]
                 ) -> List[Column]:
    """The column's rows in `order`, cut into consecutive parts of
    `split` rows (views of one gathered copy)."""
    if isinstance(c, DeviceStringColumn):
        return [DeviceStringColumn(c.dtype, d, ln, v) for d, ln, v in zip(
            c.data[order].split(split), c.lengths[order].split(split),
            c.validity[order].split(split))]
    return [DeviceColumn(c.dtype, d, v) for d, v in zip(
        c.data[order].split(split), c.validity[order].split(split))]


class RssShuffleWriterExec(Operator):
    def __init__(self, child: Operator, partitioning: Partitioning,
                 rss_resource_id: str):
        super().__init__(Schema((Field("partition", DataType.int32()),
                                 Field("bytes", DataType.int64()),
                                 Field("rows", DataType.int64()))),
                         [child])
        self.partitioning = partitioning
        self.rss_resource_id = rss_resource_id
        self._computer = PartitionIdComputer(partitioning, child.schema)
        self._sizes = sizes_by_hist if ceil_log2(
            partitioning.num_partitions) <= HIST_MAX_BITS \
            else sizes_by_bincount

    def _partition(self, b: Batch) -> Tuple[np.ndarray, List[List[Column]]]:
        """Rows per partition, and each column's rows cut into one part
        per partition."""
        pids = self._computer(b)
        order = torch.sort(pids, stable=True).indices
        sizes = self._sizes(pids, self.partitioning.num_partitions)
        self.count(self._sizes.__name__)
        self.count("shuffle_write_batches")
        self.count("shuffle_write_rows", b.num_rows)
        split = sizes.tolist()
        return sizes, [split_column(c, order, split) for c in b.columns]

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        writer: RssPartitionWriter = ctx.resources.get(self.rss_resource_id)
        n_parts = self.partitioning.num_partitions
        rows = np.zeros(n_parts, np.int64)
        nbytes = np.zeros(n_parts, np.int64)
        for b in self.child_stream(ctx):
            if b.num_rows == 0:
                continue
            sizes, parts = self._partition(b)
            for pid in np.flatnonzero(sizes):
                n = int(sizes[pid])
                writer.write(int(pid), Batch(b.schema, [p[pid] for p in parts],
                                             n, n))
            rows += sizes
            # blocks hold their rows unpadded
            nbytes += sizes * (b.mem_bytes() // b.capacity)
        writer.flush()
        yield from_numpy(self.schema, [np.arange(n_parts, dtype=np.int32),
                                       nbytes, rows], device=ctx.device)


class InProcessShuffleService:
    """Single-host exchange: map tasks push partition blocks here, reduce
    tasks read them through an IpcReader resource (`PartitionedBlocks`).
    Blocks stay on the device they were written on."""

    def __init__(self) -> None:
        # (shuffle_id, reduce_pid) -> [(map_id, block)]
        self._blocks: Dict[tuple, List[tuple]] = {}
        self._lock = threading.Lock()

    def rss_writer(self, shuffle_id: str, map_id: int) -> RssPartitionWriter:
        return _InProcessWriter(self, shuffle_id, map_id)

    def reduce_blocks(self, shuffle_id: str, reduce_pid: int) -> List[Batch]:
        """One reduce partition's blocks, ordered by map id."""
        with self._lock:
            entries = list(self._blocks.get((shuffle_id, reduce_pid), []))
        return [blk for _mid, blk in sorted(entries, key=lambda e: e[0])]

    def clear(self, shuffle_id: str) -> None:
        """Drop every block of one exchange."""
        with self._lock:
            for key in [k for k in self._blocks if k[0] == shuffle_id]:
                del self._blocks[key]


class _InProcessWriter(RssPartitionWriter):
    """Stages locally and commits in flush(): a map task run again
    replaces the blocks an earlier attempt of the same map left.  The
    commit joins each partition's staged blocks into one, in write
    order, as a remote shuffle client buffers a partition's pushes: a
    range exchange writes one small block per (scan batch, partition),
    and keeping them apart would leave ~88k Python objects per map task
    for the reduce tasks to walk and the garbage collector to scan."""

    def __init__(self, svc: InProcessShuffleService, shuffle_id: str,
                 map_id: int) -> None:
        self._svc, self._sid, self._map_id = svc, shuffle_id, map_id
        self._staged: Dict[int, List[Batch]] = {}

    def write(self, partition_id: int, block: Batch) -> None:
        self._staged.setdefault(partition_id, []).append(block)

    def flush(self) -> None:
        merged = {pid: blocks[0] if len(blocks) == 1 else
                  concat_batches(blocks[0].schema, blocks)
                  for pid, blocks in self._staged.items()}
        with self._svc._lock:
            for pid, block in merged.items():
                entries = self._svc._blocks.setdefault((self._sid, pid), [])
                entries[:] = [e for e in entries if e[0] != self._map_id]
                entries.append((self._map_id, block))
        self._staged = {}


class PartitionedBlocks:
    """Per-reduce-partition block lists behind one resource id."""

    def __init__(self, per_partition: List[List[Batch]]):
        self.per_partition = per_partition

    def for_partition(self, pid: int) -> List[Batch]:
        if pid >= len(self.per_partition):
            return []
        return self.per_partition[pid]

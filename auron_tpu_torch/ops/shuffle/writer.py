"""RSS shuffle writer and the in-process shuffle service (counterpart of
auron_tpu/ops/shuffle/writer.py).

Rows are grouped by partition on the device: the partition ids go
through one stable sort (rows keep their input order inside a partition,
as the JAX package's host counting sort keeps it), `bincount` gives the
partition sizes, and those are the one host read per batch.  Each
non-empty partition's rows become one block, a port `Batch` that stays
on the device.

The JAX package frames blocks as Arrow-IPC/v2 bytes (columnar/serde.py),
which needs pyarrow; here a block is pushed as the `Batch` itself, and
the `bytes` column of the writer's output counts the block tensors'
bytes instead of frame bytes.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import (
    Batch, DeviceColumn, bucket_capacity, from_numpy,
)
from auron_tpu_torch.ir.plan import Partitioning
from auron_tpu_torch.ir.schema import DataType, Field, Schema
from auron_tpu_torch.ops.base import Operator, TaskContext
from auron_tpu_torch.ops.shuffle.partitioner import PartitionIdComputer


class RssPartitionWriter:
    """What the writer pushes partition blocks into."""

    def write(self, partition_id: int, block: Batch) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass


def _pad(t: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, cap - t.shape[0]))


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

    def _partitioned_stream(self, ctx: TaskContext
                            ) -> Iterator[Tuple[int, Batch]]:
        """(pid, block) for every non-empty partition of every batch."""
        n_parts = self.partitioning.num_partitions
        for b in self.child_stream(ctx):
            n = b.num_rows
            if n == 0:
                continue
            pids = self._computer(b)
            order = torch.sort(pids, stable=True).indices
            counts = torch.bincount(pids, minlength=n_parts).cpu().numpy()
            offsets = np.concatenate([[0], np.cumsum(counts)])
            self.count("shuffle_write_batches")
            self.count("shuffle_write_rows", n)
            cols = [DeviceColumn(c.dtype, c.data[order], c.validity[order])
                    for c in b.columns]
            for pid in np.flatnonzero(counts):
                lo, hi = int(offsets[pid]), int(offsets[pid + 1])
                cap = bucket_capacity(hi - lo)
                yield int(pid), Batch(b.schema, [
                    DeviceColumn(c.dtype, _pad(c.data[lo:hi], cap),
                                 _pad(c.validity[lo:hi], cap))
                    for c in cols], hi - lo, cap)

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        writer: RssPartitionWriter = ctx.resources.get(self.rss_resource_id)
        n_parts = self.partitioning.num_partitions
        rows = np.zeros(n_parts, np.int64)
        nbytes = np.zeros(n_parts, np.int64)
        for pid, block in self._partitioned_stream(ctx):
            writer.write(pid, block)
            rows[pid] += block.num_rows
            nbytes[pid] += block.mem_bytes()
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


class _InProcessWriter(RssPartitionWriter):
    """Stages locally and commits in flush(): a map task run again
    replaces the blocks an earlier attempt of the same map left."""

    def __init__(self, svc: InProcessShuffleService, shuffle_id: str,
                 map_id: int) -> None:
        self._svc, self._sid, self._map_id = svc, shuffle_id, map_id
        self._staged: Dict[int, List[Batch]] = {}

    def write(self, partition_id: int, block: Batch) -> None:
        self._staged.setdefault(partition_id, []).append(block)

    def flush(self) -> None:
        with self._svc._lock:
            for pid, blocks in self._staged.items():
                entries = self._svc._blocks.setdefault((self._sid, pid), [])
                entries[:] = [e for e in entries if e[0] != self._map_id]
                entries.extend((self._map_id, b) for b in blocks)
        self._staged = {}


class PartitionedBlocks:
    """Per-reduce-partition block lists behind one resource id."""

    def __init__(self, per_partition: List[List[Batch]]):
        self.per_partition = per_partition

    def for_partition(self, pid: int) -> List[Batch]:
        if pid >= len(self.per_partition):
            return []
        return self.per_partition[pid]

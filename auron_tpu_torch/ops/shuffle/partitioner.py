"""Partition ids for a shuffle (counterpart of
auron_tpu/ops/shuffle/partitioner.py), hash and single modes.

hash: pmod(murmur3(keys, seed=42), N), bit-identical to Spark and the JAX
package.  A single int64/timestamp key goes through the hand-written
hash-pid kernel (ops/kernels_cuda.py) when the batch is on the card, and
through its plain version on the CPU; several keys chain `hash_columns`.
"""

from __future__ import annotations

import torch

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exprs import hashing as H
from auron_tpu_torch.exprs.compiler import build_evaluator
from auron_tpu_torch.ir.plan import Partitioning
from auron_tpu_torch.ir.schema import Schema, TypeId
from auron_tpu_torch.ops import kernels_cuda


class PartitionIdComputer:
    def __init__(self, part: Partitioning, schema: Schema):
        self.mode = part.mode
        self.n = part.num_partitions
        if self.mode == "hash":
            self._key_eval = build_evaluator(part.expressions, schema)
        elif self.mode != "single":
            raise NotImplementedError(
                f"{self.mode!r} partitioning is not in auron_tpu_torch yet")

    def __call__(self, batch: Batch) -> torch.Tensor:
        """-> int32[num_rows] partition ids of the live rows."""
        n = batch.num_rows
        if self.mode == "single" or self.n <= 1:
            return torch.zeros(n, dtype=torch.int32, device=batch.device)
        keys = self._key_eval(batch)
        if len(keys) == 1 and keys[0].dtype.id in (TypeId.INT64,
                                                   TypeId.TIMESTAMP_US):
            return kernels_cuda.hash_partition_ids_i64(
                keys[0].data[:n], keys[0].validity[:n], self.n)
        h = H.hash_columns(keys, seed=42)[:n]
        return H.pmod(h, self.n)

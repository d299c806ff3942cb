"""Partition ids for a shuffle (counterpart of
auron_tpu/ops/shuffle/partitioner.py): hash, range and single modes.

hash: pmod(murmur3(keys, seed=42), N), bit-identical to Spark and the JAX
package.  A single int64/timestamp key goes through the hand-written
hash-pid kernel (ops/kernels_cuda.py) when the batch is on the card, and
through its plain version on the CPU, whatever other columns (strings
among them) the batch carries; several keys, or a key of another type
(a string hashes as Spark's `hashUnsafeBytes`), chain `hash_columns`.

range: the id is the count of bounds lexicographically below the row's
sort key (ties go to the lower partition), over the sort-key words of
ops/sort_keys.py.  The bounds are the rows the front end sampled, in
`Partitioning.range_bounds`, encoded on the host in the key space of
their column's type (Spark's answer; the JAX package types Python ints
as int64 and so compares int32/date32 keys in another key space, ROADMAP
Queue 3).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import Batch
from auron_tpu_torch.exprs import hashing as H
from auron_tpu_torch.exprs.compiler import build_evaluator
from auron_tpu_torch.ir.plan import Partitioning
from auron_tpu_torch.ir.schema import DataType, Schema, TypeId
from auron_tpu_torch.ops import kernels_cuda
from auron_tpu_torch.ops.sort import _np_encode_key
from auron_tpu_torch.ops.sort_keys import encode_sort_keys

# rows x bounds compared at once by range_ids_from_words
_RANGE_BLOCK = 1 << 24


class PartitionIdComputer:
    def __init__(self, part: Partitioning, schema: Schema):
        self.mode = part.mode
        self.n = part.num_partitions
        if self.mode == "hash":
            self._key_eval = build_evaluator(part.expressions, schema)
        elif self.mode == "range":
            self._key_eval = build_evaluator(
                tuple(s.child for s in part.sort_orders), schema)
            self._orders = tuple((s.asc, s.nulls_first)
                                 for s in part.sort_orders)
            self._bounds = torch.from_numpy(encoded_range_bounds(
                part.range_bounds, self._key_eval.out_types, self._orders))
        elif self.mode != "single":
            raise NotImplementedError(
                f"{self.mode!r} partitioning is not in auron_tpu_torch yet")

    def __call__(self, batch: Batch) -> torch.Tensor:
        """-> int32[num_rows] partition ids of the live rows."""
        n = batch.num_rows
        if self.mode == "single" or self.n <= 1:
            return torch.zeros(n, dtype=torch.int32, device=batch.device)
        keys = self._key_eval(batch)
        if self.mode == "range":
            words = encode_sort_keys(keys, self._orders)
            if self._bounds.device != batch.device:
                self._bounds = self._bounds.to(batch.device)
            return range_ids_from_words([w[:n] for w in words],
                                        self._bounds)
        if len(keys) == 1 and keys[0].dtype.id in (TypeId.INT64,
                                                   TypeId.TIMESTAMP_US):
            return kernels_cuda.hash_partition_ids_i64(
                keys[0].data[:n], keys[0].validity[:n], self.n)
        h = H.hash_columns(keys, seed=42)[:n]
        return H.pmod(h, self.n)


def range_ids_from_words(words: Sequence[torch.Tensor],
                         bounds: torch.Tensor) -> torch.Tensor:
    """Range partition ids from sort-key words: id = count of bounds
    lexicographically below the row key (ties go to the lower partition).
    `bounds` is the [n_bounds, n_words] int64 matrix of
    encoded_range_bounds.  Where the JAX package loops over the bounds,
    this compares a block of rows with all bounds at once."""
    n = int(words[0].shape[0])
    nb = int(bounds.shape[0])
    ids = torch.zeros(n, dtype=torch.int32, device=bounds.device)
    if nb == 0 or n == 0:
        return ids
    step = max(1, _RANGE_BLOCK // nb)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        below = torch.zeros(hi - lo, nb, dtype=torch.bool,
                            device=bounds.device)
        decided = torch.zeros_like(below)
        for wi, w in enumerate(words):
            row, bw = w[lo:hi, None], bounds[None, :, wi]
            gt, lt = row > bw, row < bw
            below |= gt & ~decided
            decided |= gt | lt
        ids[lo:hi] = below.sum(1, dtype=torch.int32)
    return ids


def encoded_range_bounds(range_bounds, dtypes: Sequence[DataType],
                         orders: Sequence[Tuple[bool, bool]]) -> np.ndarray:
    """Encode the sampled bound rows (tuples of Python values, None for
    null) into the [n_bounds, n_words] int64 word matrix, each key in the
    key space of its column's type."""
    rows = list(range_bounds)
    words: List[np.ndarray] = []
    for ki, (dt, (asc, nf)) in enumerate(zip(dtypes, orders)):
        if dt.is_stringlike:
            raise NotImplementedError(
                f"range partitioning by a {dt!r} key is not in "
                f"auron_tpu_torch yet")
        vals = [r[ki] for r in rows]
        mask = np.array([v is not None for v in vals], dtype=bool)
        np_dt = torch.empty(0, dtype=dt.torch_dtype()).numpy().dtype
        arr = np.array([0 if v is None else v for v in vals], dtype=np_dt)
        for v, a in zip(vals, arr.tolist()):
            if v is not None and a != v and not (a != a and v != v):
                raise ValueError(f"range bound {v!r} is not a value of "
                                 f"its key's type {dt!r}")
        words.extend(_np_encode_key(arr, mask, dt, asc, nf))
    if not words:
        return np.zeros((len(rows), 0), np.int64)
    return np.stack(words, axis=1)

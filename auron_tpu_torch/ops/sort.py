"""Sort operator, in memory (counterpart of auron_tpu/ops/sort.py).

`SortExec` stages its input, concatenates it into one batch (string
columns padded to the widest part, so every row's key has the same
words), encodes the sort keys into words (ops/sort_keys.py), sorts them
with the JAX package's strategy switch (`lexsort_indices`), gathers the
rows, and cuts the result into batch-size chunks; fetch limit and offset
apply as in the JAX operator.  Its metric `sorted_by_<form>` counts the sorts of each
form (`sort_keys.sort_form`).  The JAX operator's spill runs, its host
k-way merge (`HostKeyMerger`) and its host sort of host-resident key
columns wait for the port's memory manager: this operator keeps every
staged row on the device, and when the card cannot hold them torch
raises its out-of-memory error; no row is dropped.

`_np_encode_key` is the host mirror of the device encoder, used to encode
range bounds in the same key space (ops/shuffle/partitioner.py); it has
no string arm, since no range exchange of the port sorts by a string.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import Batch, concat_batches
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs.compiler import build_evaluator
from auron_tpu_torch.ir.expr import SortExpr
from auron_tpu_torch.ir.schema import DataType, TypeId
from auron_tpu_torch.ops.base import Operator, TaskContext
from auron_tpu_torch.ops.sort_keys import (
    F64_NEG_FLIP, MASK32, NARROW_INTS, encode_sort_keys,
    encode_sort_keys_bits, lexsort_indices, sort_form, value_bits,
)


class SortExec(Operator):
    def __init__(self, child: Operator, sort_exprs: Tuple[SortExpr, ...],
                 fetch_limit: Optional[int] = None, fetch_offset: int = 0):
        super().__init__(child.schema, [child])
        self.sort_exprs = tuple(sort_exprs)
        self.fetch_limit = fetch_limit
        self.fetch_offset = fetch_offset
        self._key_eval = build_evaluator(
            tuple(s.child for s in self.sort_exprs), child.schema)
        self._orders = tuple((s.asc, s.nulls_first) for s in self.sort_exprs)
        self._staged: List[Batch] = []

    def _sort_batch(self, b: Batch) -> Batch:
        key_cols = self._key_eval(b)
        words = encode_sort_keys(key_cols, self._orders)
        self.count("sorted_by_" + sort_form(b.capacity, len(words),
                                            b.device.type))
        perm = lexsort_indices(words, b.num_rows, b.capacity,
                               encode_sort_keys_bits(key_cols))
        out = b.gather(perm, b.num_rows)
        if self.fetch_limit is not None:
            out = out.head(self.fetch_offset + self.fetch_limit)
        return out

    def _sort_staged(self) -> List[Batch]:
        """Sort all staged batches into one run (list of output batches)."""
        if not self._staged:
            return []
        merged = concat_batches(self.schema, self._staged)
        return _rechunk(self._sort_batch(merged),
                        int(conf.get("auron.batch.size")))

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        for b in self.child_stream(ctx):
            if b.num_rows:
                self._staged.append(b)
        out = self._sort_staged()
        self._staged = []
        self.count("sorted_rows", sum(b.num_rows for b in out))
        yield from _apply_offset(iter(out), self.fetch_offset,
                                 self.fetch_limit)


def _rechunk(b: Batch, target: int) -> List[Batch]:
    if b.num_rows <= target:
        return [b]
    return [b.slice(off, min(target, b.num_rows - off))
            for off in range(0, b.num_rows, target)]


def _apply_offset(batches: Iterator[Batch], offset: int,
                  limit: Optional[int]) -> Iterator[Batch]:
    if not offset and limit is None:
        yield from batches
        return
    to_skip = offset
    remaining = limit if limit is not None else 1 << 62
    for b in batches:
        if remaining <= 0:
            return
        if to_skip >= b.num_rows:
            to_skip -= b.num_rows
            continue
        if to_skip > 0:
            idx = torch.arange(b.capacity, device=b.device) + to_skip
            b = b.gather(idx, b.num_rows - to_skip)
            to_skip = 0
        if b.num_rows > remaining:
            b = b.head(remaining)
        remaining -= b.num_rows
        yield b


def _np_encode_key(vals: np.ndarray, mask: np.ndarray, dtype: DataType,
                   asc: bool, nulls_first: bool) -> List[np.ndarray]:
    """numpy mirror of ops.sort_keys.encode_key_column: the same int64
    words for the same values of a column of `dtype` (null slots hold
    zeros)."""
    nbits = value_bits(dtype)
    if dtype.id == TypeId.FLOAT64:
        x = np.asarray(vals, np.float64)
        x = np.where(x == 0.0, 0.0, x)
        x = np.where(np.isnan(x), np.nan, x)
        b = x.view(np.int64)
        w = np.where(b >= 0, b, b ^ np.int64(F64_NEG_FLIP))
    elif dtype.id in NARROW_INTS:
        w = np.asarray(vals).astype(np.int64) + (1 << 31)
    else:
        w = np.asarray(vals).astype(np.int64)
    if not asc:
        w = ~w if nbits == 64 else w ^ np.int64(MASK32)
    null_rank = np.where(mask, int(nulls_first),
                         int(not nulls_first)).astype(np.int64)
    return [null_rank, w]

"""External sort operator (counterpart of auron_tpu/ops/sort.py).

`SortExec` stages its input and registers with the task's memory
manager.  In memory it concatenates the staged batches into one (string
columns padded to the widest part, so every row's key has the same
words), encodes the sort keys into words (ops/sort_keys.py), sorts them
with the JAX package's strategy switch (`lexsort_indices`), gathers the
rows, and cuts the result into batch-size chunks; fetch limit and
offset apply as in the JAX operator.  Its metric `sorted_by_<form>`
counts the sorts of each form (`sort_keys.sort_form`).

Under memory pressure the staged batches are sorted into a run and
spilled (memmgr/spill.py), and at the end the runs merge through
`HostKeyMerger`, the k-way merge with safe-prefix emission, before the
fetch limit and offset apply.  The merge takes equal keys from earlier
runs first, so a spilled sort equals the in-memory stable sort row for
row.  The JAX package's host sort of host-resident key columns
(`_sort_batch_host`) waits for host columns (ROADMAP Queue 1 item 11).

`_np_encode_key` is the host mirror of the device encoder, used to encode
range bounds in the same key space (ops/shuffle/partitioner.py); it has
no string arm, since no range exchange of the port sorts by a string.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import (
    Batch, Column, bucket_capacity, concat_batches,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.exprs.compiler import build_evaluator
from auron_tpu_torch.ir.expr import SortExpr
from auron_tpu_torch.ir.schema import DataType, TypeId
from auron_tpu_torch.ops.base import Operator, StagingOperator, TaskContext
from auron_tpu_torch.ops.sort_keys import (
    F64_NEG_FLIP, MASK32, NARROW_INTS, encode_sort_keys,
    encode_sort_keys_bits, lexsort_indices, lexsort_indices_live,
    sort_form, value_bits,
)


class SortExec(StagingOperator):
    def __init__(self, child: Operator, sort_exprs: Tuple[SortExpr, ...],
                 fetch_limit: Optional[int] = None, fetch_offset: int = 0):
        StagingOperator.__init__(self, child.schema, [child], "SortExec",
                                 "sort")
        self.sort_exprs = tuple(sort_exprs)
        self.fetch_limit = fetch_limit
        self.fetch_offset = fetch_offset
        self._key_eval = build_evaluator(
            tuple(s.child for s in self.sort_exprs), child.schema)
        self._orders = tuple((s.asc, s.nulls_first) for s in self.sort_exprs)

    # -- sorting ------------------------------------------------------------

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

    def sorted_run(self, batches: List[Batch]) -> List[Batch]:
        if not batches:
            return []
        merged = concat_batches(self.schema, batches)
        return _rechunk(self._sort_batch(merged),
                        int(conf.get("auron.batch.size")))

    # -- execution ----------------------------------------------------------

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        yield from self.run_staged(ctx, self._in_memory, self._merge)

    def _in_memory(self, batches: List[Batch]) -> Iterator[Batch]:
        out = self.sorted_run(batches)
        self.count("sorted_rows", sum(b.num_rows for b in out))
        return _apply_offset(iter(out), self.fetch_offset, self.fetch_limit)

    def _merge(self, runs: List[Iterator[Batch]]) -> Iterator[Batch]:
        merger = HostKeyMerger(self._key_eval, self._orders)
        return _apply_offset(self._counted(merger.merge(runs)),
                             self.fetch_offset, self.fetch_limit)

    def _counted(self, batches: Iterator[Batch]) -> Iterator[Batch]:
        for b in batches:
            self.count("sorted_rows", b.num_rows)
            yield b


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


# ---------------------------------------------------------------------------
# k-way merge of sorted runs (the loser-tree analogue): safe-prefix
# emission over the runs' key words
# ---------------------------------------------------------------------------

KeyEval = Callable[[Batch], Sequence[Column]]


def _take(b: Batch, idx: torch.Tensor) -> Batch:
    """Rows `idx` of a batch, at capacity bucket_capacity(len(idx))."""
    n = int(idx.shape[0])
    cap = bucket_capacity(n)
    return b.gather(torch.nn.functional.pad(idx, (0, cap - n)), n)


def rows_at_or_below(words: Sequence[torch.Tensor], bound: Sequence[int]
                     ) -> torch.Tensor:
    """bool[rows]: the row's word tuple is at or below `bound`
    (lexicographic; the words are int64, ordered as signed)."""
    lt = torch.zeros(words[0].shape[0], dtype=torch.bool,
                     device=words[0].device)
    eq = torch.ones_like(lt)
    for w, f in zip(words, bound):
        lt |= eq & (w < f)
        eq &= w == f
    return lt | eq


class HostKeyMerger:
    """K-way merge of sorted runs, each an iterator of sorted batches, by
    the keys `key_eval` computes under `orders`.

    Each round moves every run's current batch into a pool (after the
    rows held back from the last round), concatenates the pool on the
    task's device, encodes its keys at the pool's one string width, and
    stably sorts the pool by (key words, run index).  A run's later rows
    sort at or after (its current last key, its index); the bound is the
    least of these over the runs not yet exhausted, picked on the host,
    and every pool row at or below it is final and goes out in
    batch-size chunks, the rest waits for the next round.  The JAX merger re-encodes Arrow
    keys on the host for the same comparison; here the words are the
    device sort's own (ops/sort_keys.py), strings included.  Equal keys
    come out in run order, and within a run in its order.  Two host
    reads a round: the runs' last keys and the safe prefix's length."""

    def __init__(self, key_eval: KeyEval,
                 orders: Sequence[Tuple[bool, bool]]):
        self.key_eval = key_eval
        self.orders = list(orders)

    def merge(self, runs: List[Iterator[Batch]]) -> Iterator[Batch]:
        def pull(i: int) -> Optional[Batch]:
            return next((b for b in runs[i] if b.num_rows), None)

        heads = [pull(i) for i in range(len(runs))]
        # rows held back: (batch, run index of each row)
        pool: List[Tuple[Batch, torch.Tensor]] = []
        bs = int(conf.get("auron.batch.size"))
        while True:
            active = [i for i, h in enumerate(heads) if h is not None]
            if not active:
                break
            entries = list(pool)
            last_rows = []     # pool row of each run's last row, if it
            off = sum(b.num_rows for b, _ in entries)   # has more rows
            for i in active:
                h = heads[i]
                entries.append((h, torch.full((h.num_rows,), i,
                                              dtype=torch.int64,
                                              device=h.device)))
                off += h.num_rows
                heads[i] = pull(i)
                if heads[i] is not None:
                    last_rows.append(off - 1)
            merged = concat_batches(entries[0][0].schema,
                                    [b for b, _ in entries])
            run_of = torch.cat([r for _, r in entries])
            n = merged.num_rows
            key_cols = [c.prefix(n) for c in self.key_eval(merged)]
            words = encode_sort_keys(key_cols, self.orders) + [run_of]
            perm = lexsort_indices_live(
                words, None, encode_sort_keys_bits(key_cols) + [32])
            if not last_rows:
                safe = n
            else:
                # a run's later rows sort at or after (its last key, its
                # index): rows up to the least of these are final
                at = torch.tensor(last_rows, device=run_of.device)
                bound = min(map(tuple, torch.stack(
                    [w[at] for w in words], 1).tolist()))
                safe = int(rows_at_or_below(words, bound).sum())
            for lo in range(0, safe, bs):
                yield _take(merged, perm[lo:min(lo + bs, safe)])
            rest = perm[safe:]
            pool = [(_take(merged, rest), run_of[rest])] if len(rest) \
                else []


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
    elif dtype.id == TypeId.FLOAT32:
        x = np.asarray(vals, np.float32)
        x = np.where(x == 0.0, np.float32(0.0), x)
        x = np.where(np.isnan(x), np.float32(np.nan), x)
        b = x.view(np.uint32).astype(np.int64)
        w = np.where(b < (1 << 31), b ^ (1 << 31), b ^ np.int64(MASK32))
    elif dtype.id in NARROW_INTS:
        w = np.asarray(vals).astype(np.int64) + (1 << 31)
    else:       # bool, int64, timestamp, decimal (its unscaled value)
        w = np.asarray(vals).astype(np.int64)
    if not asc:
        w = ~w if nbits == 64 else w ^ np.int64(MASK32)
    null_rank = np.where(mask, int(nulls_first),
                         int(not nulls_first)).astype(np.int64)
    return [null_rank, w]

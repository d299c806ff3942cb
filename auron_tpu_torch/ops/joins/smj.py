"""Streaming sort-merge join: the merge of two key-sorted streams
(counterpart of auron_tpu/ops/joins/smj.py).

Both children arrive sorted on the join keys, and the join advances a
*frontier*, the smaller of the two sides' last buffered keys.  The rows
strictly below it form complete key groups: they are joined as one
window (a build table over the build side's rows, the other side's rows
probing it) and released.  Rows at or above it stay buffered until the
lagging side catches up.

Key order.  A key is compared as the tuple of its sort-key words
(ops/sort_keys.py, under the join's (asc, nulls_first) options): the
words `SortExec` sorts the inputs by, so the frontier orders keys
exactly as the inputs are ordered, Spark's order with -0.0 equal to 0.0
and every NaN equal and last.  The JAX package compares host values
with an order of its own (`_f64_orderable`: -0.0 before 0.0, NaNs split
by sign, ROADMAP Queue 3 item 3), which against the port's sort would
cut a key group across two windows.  A string key's word count follows
its width bucket, and the two sides may come in different buckets, so
each string key's byte words are padded to the widest bucket
(`auron.string.device.max.width`) with the word of 8 zero bytes before
its length word, which keeps the order (`key_words`); the padding words
are host constants, never tensors.  On the device a batch's rows are
compared with the frontier word by word; since a batch is sorted, the
rows below the frontier are a prefix of it, so a split reads one count.

Each buffered batch costs one host read, its first and last keys'
words, as the JAX package reads them.  The buffers stay on the device:
the JAX package's spill of a side's buffer to storage waits for the
port's memory manager (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceColumn, DeviceStringColumn,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.ops.sort_keys import encode_key_column

HostKey = Tuple[int, ...]
Orders = Sequence[Tuple[bool, bool]]
Word = Union[torch.Tensor, int]


def key_words(key_cols: List[Column], orders: Orders) -> List[Word]:
    """The keys' sort-key words, each string key's byte words padded to
    the widest width bucket with the (host constant) word of 8 zero
    bytes, ascending or descending, before its length word."""
    max_words = (int(conf.get("auron.string.device.max.width")) + 7) // 8
    words: List[Word] = []
    for col, (asc, nf) in zip(key_cols, orders):
        ws: List[Word] = list(encode_key_column(col, asc, nf))
        if isinstance(col, DeviceStringColumn):
            zero = -(1 << 63) if asc else (1 << 63) - 1
            ws = ws[:-1] + [zero] * (max_words - (len(ws) - 2)) + ws[-1:]
        words.extend(ws)
    return words


def cmp_keys(a: HostKey, b: HostKey) -> int:
    """-1 / 0 / 1: the order of two keys' word tuples, which is the SQL
    order under the options they were encoded with."""
    return (a > b) - (a < b)


def host_keys_of_rows(key_cols: List[Column], rows: List[int],
                      orders: Orders) -> List[HostKey]:
    """The word tuples of a few rows' keys, in one device read."""
    words = key_words(key_cols, orders)
    tensors = [w for w in words if isinstance(w, torch.Tensor)]
    idx = torch.tensor(rows, dtype=torch.int64, device=tensors[0].device)
    vals = torch.stack([w[idx] for w in tensors], 1).tolist()
    out = []
    for v in vals:
        it = iter(v)
        out.append(tuple(next(it) if isinstance(w, torch.Tensor) else w
                         for w in words))
    return out


def rows_below_frontier(key_cols: List[Column], frontier: HostKey,
                        orders: Orders) -> torch.Tensor:
    """bool[capacity]: the row's key is strictly below the frontier
    (word-lexicographic against the frontier's words)."""
    rows = key_cols[0].validity.shape[0]
    dev = key_cols[0].validity.device
    lt = torch.zeros(rows, dtype=torch.bool, device=dev)
    eq: Union[torch.Tensor, bool] = True
    for w, f in zip(key_words(key_cols, orders), frontier):
        if isinstance(w, torch.Tensor):
            lt = lt | (eq & (w < f))
            eq = eq & (w == f)
        elif w != f:        # a padding word: the same for every row
            if w < f:
                lt = lt | eq
            return lt
    return lt


def _rows(b: Batch, lo: int, hi: int) -> Batch:
    """Rows [lo, hi) of a batch as views, unpadded (as a shuffle block
    is: capacity = rows)."""
    cols: List[Column] = []
    for c in b.columns:
        if isinstance(c, DeviceStringColumn):
            cols.append(DeviceStringColumn(c.dtype, c.data[lo:hi],
                                           c.lengths[lo:hi],
                                           c.validity[lo:hi]))
        else:
            cols.append(DeviceColumn(c.dtype, c.data[lo:hi],
                                     c.validity[lo:hi]))
    return Batch(b.schema, cols, hi - lo, hi - lo)


def split_batch(b: Batch, key_cols: List[Column], frontier: HostKey,
                orders: Orders) -> Tuple[Optional[Batch], Optional[Batch]]:
    """-> (ready, keep): the rows below / at or above the frontier.  The
    batch is sorted, so `ready` is a prefix: one read of its length."""
    below = rows_below_frontier(key_cols, frontier, orders)
    k = int(below[:b.num_rows].sum())
    ready = _rows(b, 0, k) if k else None
    keep = _rows(b, k, b.num_rows) if k < b.num_rows else None
    return ready, keep


class SideCursor:
    """One sorted input: pulls batches on demand, keeps its boundary
    (the last buffered row's key) and yields the rows below a frontier.
    Buffered entries are (batch, lower bound of its keys, its last
    key); the bounds serve the whole-batch fast paths."""

    def __init__(self, stream: Iterator[Batch], key_eval, orders: Orders):
        self._stream = stream
        self._key_eval = key_eval
        self.orders = orders
        self.mem: Deque[Tuple[Batch, HostKey, HostKey]] = deque()
        self.exhausted = False
        self.boundary: Optional[HostKey] = None

    def keys_of(self, b: Batch) -> List[Column]:
        return self._key_eval(b)

    @property
    def empty(self) -> bool:
        return not self.mem

    def advance(self) -> bool:
        """Buffer one more non-empty batch from upstream."""
        for b in self._stream:
            n = b.num_rows
            if n == 0:
                continue
            first, last = host_keys_of_rows(self.keys_of(b), [0, n - 1],
                                            self.orders)
            self.mem.append((b, first, last))
            self.boundary = last
            return True
        self.exhausted = True
        return False

    def iter_ready(self, frontier: Optional[HostKey]) -> Iterator[Batch]:
        """Yield, and drop from the buffer, every row strictly below the
        frontier (everything buffered when it is None)."""
        while self.mem:
            b, first, last = self.mem[0]
            if frontier is None or cmp_keys(last, frontier) < 0:
                self.mem.popleft()
                yield b
                continue
            if cmp_keys(first, frontier) >= 0:
                return      # this batch and every later one wait
            self.mem.popleft()
            ready, keep = split_batch(b, self.keys_of(b), frontier,
                                      self.orders)
            if keep is not None:
                # its rows are >= the frontier: a valid lower bound
                self.mem.appendleft((keep, frontier, last))
            if ready is not None:
                yield ready
            return

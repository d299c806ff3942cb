"""Shuffle-read IPC reader and the FFI reader (counterpart of
auron_tpu/ops/scan/ipc.py).

`FFIReaderExec` imports the front end's batches.  The resource is an
iterable whose items are `(arrays, validities)` pairs of numpy columns
(the Arrow C-Data import's counterpart; a None validity means no nulls;
a string column an object array of `str` or `bytes`) or
`pyarrow.RecordBatch`es; each is uploaded to the task's device.  A
partition-indexed resource (`SourceTable`, one item list a partition)
gives a task the items of its own partition.
pyarrow is imported only when such a batch arrives.  A string longer
than `auron.string.device.max.width` raises (`columnar/batch.py`).

`IpcReaderExec` reads a partition-indexed source (`for_partition`), whose
blocks are the port's device `Batch`es: the JAX reader's branch for
already-decoded v2 frames.  The byte frames of auron_tpu/columnar/serde.py
are not in this slice.
"""

from __future__ import annotations

import datetime
from typing import Iterator, List, Optional, Sequence

import numpy as np

from auron_tpu_torch.columnar.batch import (
    Batch, empty_numpy, from_numpy, unscaled_of,
)
from auron_tpu_torch.ir.schema import Schema, TypeId
from auron_tpu_torch.ops.base import Operator, TaskContext


class IpcReaderExec(Operator):
    def __init__(self, schema: Schema, resource_id: str):
        super().__init__(schema, [])
        self.resource_id = resource_id

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        src = ctx.resources.get(self.resource_id)
        if hasattr(src, "for_partition"):
            src = src.for_partition(ctx.partition_id)
        for b in src:
            if not isinstance(b, Batch):
                raise TypeError(f"IPC block of type {type(b).__name__}: "
                                f"byte frames are not in auron_tpu_torch yet")
            if b.device != ctx.device:
                raise ValueError(f"shuffle block on {b.device}, task on "
                                 f"{ctx.device}")
            self.count("shuffle_read_rows", b.num_rows)
            yield b if b.schema == self.schema else \
                Batch(self.schema, b.columns, b.num_rows, b.capacity)


class FFIReaderExec(Operator):
    def __init__(self, schema: Schema, resource_id: str):
        super().__init__(schema, [])
        self.resource_id = resource_id

    def execute(self, ctx: TaskContext) -> Iterator[Batch]:
        src = ctx.resources.get(self.resource_id)
        if hasattr(src, "for_partition"):
            src = src.for_partition(ctx.partition_id)
        for item in src:
            arrays, validities = item_columns(item)
            yield from_numpy(self.schema, arrays, validities,
                             device=ctx.device)


_EPOCH_DAY = datetime.date(1970, 1, 1)
_EPOCH = datetime.datetime(1970, 1, 1)


def _row_value(v, dtype):
    if dtype.is_decimal:
        return unscaled_of(v, dtype.scale)
    if dtype.id == TypeId.DATE32 and isinstance(v, datetime.date):
        return (v - _EPOCH_DAY).days
    if dtype.id == TypeId.TIMESTAMP_US and isinstance(v, datetime.datetime):
        if v.tzinfo is not None:
            v = v.astimezone(datetime.timezone.utc).replace(tzinfo=None)
        d = v - _EPOCH
        return (d.days * 86_400 + d.seconds) * 1_000_000 + d.microseconds
    return v


def item_columns(item):
    """(arrays, validities) of an FFI item: a pair as it is, a
    RecordBatch through `arrow_to_numpy`."""
    return item if isinstance(item, tuple) else arrow_to_numpy(item)


class SourceTable:
    """A front end's table as FFI items, one list a partition: the
    serial path's task p reads `for_partition(p)`, the stage executor
    the whole table (`columns`).  Tables are immutable: the stage
    executor's source cache keys them by identity."""

    def __init__(self, parts: List[list],
                 whole: Optional[tuple] = None):
        self.parts = [list(p) for p in parts]
        self._whole = whole

    @classmethod
    def from_columns(cls, arrays: Sequence, validities: Sequence,
                     n_parts: int = 1,
                     batch_rows: int = 8192) -> "SourceTable":
        """Rows cut into `n_parts` contiguous splits (split k holds rows
        [k n / parts, (k + 1) n / parts)), each into items of at most
        `batch_rows` rows (views)."""
        n = len(arrays[0])
        parts = []
        for k in range(n_parts):
            lo, hi = k * n // n_parts, (k + 1) * n // n_parts
            parts.append([([a[s:min(s + batch_rows, hi)] for a in arrays],
                           [v[s:min(s + batch_rows, hi)]
                            for v in validities])
                          for s in range(lo, hi, batch_rows)])
        return cls(parts, (list(arrays), list(validities)))

    @classmethod
    def from_rows(cls, rows: Sequence[dict], schema: Schema
                  ) -> "SourceTable":
        """One partition of a `LocalTableScanExec`'s rows (dicts by
        column name, a missing or None value null), each column in its
        device layout: a date as int32 days (`datetime.date` or an int),
        a decimal as its unscaled int64 (`unscaled_of` of a `Decimal`, an
        int or a float value),
        a timestamp as int64 microseconds (`datetime.datetime`, naive as
        UTC, or an int), a string or binary column as an object array."""
        arrays, validities = [], []
        for f in schema.fields:
            vals = [r.get(f.name) for r in rows]
            valid = np.array([v is not None for v in vals], dtype=bool)
            if f.dtype.is_stringlike:
                a = np.empty(len(vals), dtype=object)
                a[:] = vals
            else:
                fill = False if f.dtype.id == TypeId.BOOL else 0
                a = np.array([fill if v is None else _row_value(v, f.dtype)
                              for v in vals],
                             dtype=empty_numpy(f.dtype).dtype)
            arrays.append(a)
            validities.append(valid)
        return cls([[(arrays, validities)]] if rows else [[]],
                   (arrays, validities))

    def for_partition(self, pid: int) -> list:
        return self.parts[pid] if pid < len(self.parts) else []

    def __iter__(self):
        return (item for p in self.parts for item in p)

    def columns(self, n_cols: int):
        """(arrays, validities) of every row, partitions in order."""
        if self._whole is not None:
            return self._whole
        items = [item_columns(it) for it in self]
        if not items:
            return [np.zeros(0)] * n_cols, [np.zeros(0, bool)] * n_cols
        arrays = [np.concatenate([it[0][i] for it in items])
                  for i in range(n_cols)]
        validities = [np.concatenate([
            np.ones(len(it[0][i]), bool) if it[1] is None or
            it[1][i] is None else np.asarray(it[1][i], bool)
            for it in items]) for i in range(n_cols)]
        return arrays, validities


def arrow_to_numpy(rb):
    """(arrays, validities) of a pyarrow RecordBatch, nulls as zeros,
    each column as the integers or floats of its device layout (as the
    JAX package's `Batch.from_arrow` imports them): date32 as int32
    days, a timestamp as int64 microseconds, a decimal(p <= 18) as its
    int64 unscaled value (a wider one as an object array of `Decimal`s,
    which no device column takes), bool as bool; a string or
    binary column as an object array of `str` or `bytes`, None where
    null."""
    import pyarrow as pa
    if not isinstance(rb, pa.RecordBatch):
        raise TypeError(f"FFI item of type {type(rb).__name__}: want a "
                        f"(arrays, validities) pair or a pyarrow.RecordBatch")
    arrays, validities = [], []
    for col in rb.columns:
        validities.append(np.array(col.is_valid()))
        t = col.type
        if pa.types.is_string(t) or pa.types.is_large_string(t) or \
                pa.types.is_binary(t) or pa.types.is_large_binary(t):
            vals = np.empty(len(col), dtype=object)
            vals[:] = col.to_pylist()
            arrays.append(vals)
            continue
        if pa.types.is_decimal(t) and t.precision > 18:
            # host values (a `Decimal` each): no device layout here
            vals = np.empty(len(col), dtype=object)
            vals[:] = col.to_pylist()
            arrays.append(vals)
            continue
        if pa.types.is_decimal(t):
            # decimal128's 16-byte little-endian words: a value of at most
            # 18 digits is its low int64, sign-extended
            words = np.frombuffer(col.buffers()[1], dtype=np.int64)
            lo = words[2 * col.offset:2 * (col.offset + len(col)):2]
            arrays.append(np.where(validities[-1], lo, 0))
            continue
        if pa.types.is_date32(t):
            col = col.cast(pa.int32())
        elif pa.types.is_timestamp(t):
            col = col.cast(pa.timestamp("us")).cast(pa.int64())
        fill = False if pa.types.is_boolean(t) else 0
        arrays.append(np.asarray(col.fill_null(fill)
                                 .to_numpy(zero_copy_only=False)))
    return arrays, validities

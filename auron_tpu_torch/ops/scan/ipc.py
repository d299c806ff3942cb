"""Shuffle-read IPC reader and the FFI reader (counterpart of
auron_tpu/ops/scan/ipc.py).

`FFIReaderExec` imports the front end's batches.  The resource is an
iterable whose items are `(arrays, validities)` pairs of numpy columns
(the Arrow C-Data import's counterpart; a None validity means no nulls;
a string column an object array of `str` or `bytes`) or
`pyarrow.RecordBatch`es; each is uploaded to the task's device.
pyarrow is imported only when such a batch arrives.  A string longer
than `auron.string.device.max.width` raises (`columnar/batch.py`).

`IpcReaderExec` reads a partition-indexed source (`for_partition`), whose
blocks are the port's device `Batch`es: the JAX reader's branch for
already-decoded v2 frames.  The byte frames of auron_tpu/columnar/serde.py
are not in this slice.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from auron_tpu_torch.columnar.batch import Batch, from_numpy
from auron_tpu_torch.ir.schema import Schema
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
        for item in ctx.resources.get(self.resource_id):
            if isinstance(item, tuple):
                arrays, validities = item
            else:
                arrays, validities = arrow_to_numpy(item)
            yield from_numpy(self.schema, arrays, validities,
                             device=ctx.device)


def arrow_to_numpy(rb):
    """(arrays, validities) of a pyarrow RecordBatch, nulls as zeros,
    each column as the integers or floats of its device layout (as the
    JAX package's `Batch.from_arrow` imports them): date32 as int32
    days, a timestamp as int64 microseconds, bool as bool; a string or
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
        if pa.types.is_date32(t):
            col = col.cast(pa.int32())
        elif pa.types.is_timestamp(t):
            col = col.cast(pa.timestamp("us")).cast(pa.int64())
        fill = False if pa.types.is_boolean(t) else 0
        arrays.append(np.asarray(col.fill_null(fill)
                                 .to_numpy(zero_copy_only=False)))
    return arrays, validities

"""Device batch: padded columns + validity + row count (counterpart of
auron_tpu/columnar/batch.py).

Invariants every operator relies on:
- every column tensor's length is the batch `capacity`, a power of two
  bucket (`bucket_capacity`);
- rows at index >= num_rows are padding: validity False, data zero;
- null slots hold canonical zeros.
Unlike the JAX package, `num_rows` is always a host int: torch runs
eagerly, and the operators that change a row count read it back once.
Shuffle blocks are the one exception to the padding: a block is a view
of one partition's rows in the writer's partition-sorted columns, so its
capacity is its row count (ops/shuffle/writer.py).  Their readers take
the live rows `[:num_rows]`, as every consumer here does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from auron_tpu_torch import resolve_device
from auron_tpu_torch.config import conf
from auron_tpu_torch.ir.schema import DataType, Schema


def bucket_capacity(n: int) -> int:
    """Smallest power-of-two capacity >= n (bounded below by config)."""
    cap = int(conf.get("auron.batch.capacity.min"))
    n = max(int(n), 1)
    while cap < n:
        cap <<= 1
    return cap


@dataclass
class DeviceColumn:
    """Flat column: data[capacity] and validity[capacity] (bool)."""
    dtype: DataType
    data: torch.Tensor
    validity: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def gather(self, indices: torch.Tensor, valid: torch.Tensor
               ) -> "DeviceColumn":
        """Row gather; rows whose `valid` is False become null and zero."""
        d = torch.where(valid, self.data[indices],
                        torch.zeros((), dtype=self.data.dtype,
                                    device=self.data.device))
        return DeviceColumn(self.dtype, d, valid & self.validity[indices])

    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size() + \
            self.validity.numel()


def flat(dtype: DataType, data: torch.Tensor, validity: torch.Tensor
         ) -> DeviceColumn:
    """A column with canonical zeros at null slots."""
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    return DeviceColumn(dtype, torch.where(validity, data, zero), validity)


class Batch:
    __slots__ = ("schema", "columns", "num_rows", "capacity")

    def __init__(self, schema: Schema, columns: List[DeviceColumn],
                 num_rows: int, capacity: int):
        if len(columns) != len(schema):
            raise ValueError(f"{len(columns)} columns vs schema {schema!r}")
        self.schema = schema
        self.columns = columns
        self.num_rows = int(num_rows)
        self.capacity = int(capacity)

    @property
    def device(self) -> torch.device:
        return self.columns[0].data.device

    def with_columns(self, schema: Schema, columns: List[DeviceColumn]
                     ) -> "Batch":
        return Batch(schema, columns, self.num_rows, self.capacity)

    def mem_bytes(self) -> int:
        return sum(c.nbytes() for c in self.columns)

    def gather(self, indices: torch.Tensor, num_rows: int) -> "Batch":
        """Rows by index, at capacity len(indices): output row i <
        num_rows is row indices[i]; rows beyond num_rows are padding
        (null, zero) whatever their index."""
        cap = int(indices.shape[0])
        valid = torch.arange(cap, device=indices.device) < num_rows
        idx = torch.where(valid, indices, 0)
        return Batch(self.schema, [c.gather(idx, valid) for c in self.columns],
                     num_rows, cap)

    def head(self, n: int) -> "Batch":
        """The first n rows, in place of the batch: rows from n on become
        padding."""
        n = min(n, self.num_rows)
        keep = torch.arange(self.capacity, device=self.device) < n
        return Batch(self.schema, [flat(c.dtype, c.data, c.validity & keep)
                                   for c in self.columns], n, self.capacity)

    def slice(self, offset: int, n: int) -> "Batch":
        """Rows [offset, offset + n) as a new padded batch."""
        cap = bucket_capacity(n)
        return Batch(self.schema, [
            DeviceColumn(c.dtype, _pad(c.data[offset:offset + n], cap),
                         _pad(c.validity[offset:offset + n], cap))
            for c in self.columns], n, cap)

    def to_numpy(self):
        """(arrays, validities) of the live rows, on the host."""
        n = self.num_rows
        return ([c.data[:n].cpu().numpy() for c in self.columns],
                [c.validity[:n].cpu().numpy() for c in self.columns])


def _pad(t: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, cap - t.shape[0]))


def from_numpy(schema: Schema, arrays: Sequence[np.ndarray],
               validity: Optional[Sequence[Optional[np.ndarray]]] = None,
               device=None, capacity: Optional[int] = None) -> Batch:
    """A device batch from host numpy columns: the function that carries
    state into the port (the tests feed both engines the same arrays).
    A None validity means all rows are valid."""
    dev = resolve_device(device)
    n = len(arrays[0]) if len(arrays) else 0
    cap = capacity or bucket_capacity(n)
    cols: List[DeviceColumn] = []
    for i, f in enumerate(schema):
        tdt = f.dtype.torch_dtype()
        v = None if validity is None else validity[i]
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        data = torch.zeros(cap, dtype=tdt, device=dev)
        a = torch.from_numpy(np.ascontiguousarray(arrays[i])).to(
            device=dev, dtype=tdt)
        if v is None:
            valid[:n] = True
            data[:n] = a
        else:
            vt = torch.from_numpy(np.ascontiguousarray(v, dtype=bool)).to(dev)
            valid[:n] = vt
            data[:n] = torch.where(vt, a, torch.zeros((), dtype=tdt,
                                                      device=dev))
        cols.append(DeviceColumn(f.dtype, data, valid))
    return Batch(schema, cols, n, cap)


def concat_batches(schema: Schema, batches: List[Batch],
                   capacity: Optional[int] = None) -> Batch:
    """Live rows of `batches`, in order, in one padded batch."""
    total = sum(b.num_rows for b in batches)
    cap = capacity or bucket_capacity(total)
    if cap < total:
        raise ValueError(f"concat capacity {cap} < total rows {total}")
    cols: List[DeviceColumn] = []
    for ci, f in enumerate(schema):
        parts = [b.columns[ci] for b in batches]
        data = torch.cat([p.data[:b.num_rows] for b, p in zip(batches, parts)])
        valid = torch.cat([p.validity[:b.num_rows]
                           for b, p in zip(batches, parts)])
        pad = cap - total
        cols.append(DeviceColumn(
            f.dtype, torch.nn.functional.pad(data, (0, pad)),
            torch.nn.functional.pad(valid, (0, pad))))
    return Batch(schema, cols, total, cap)

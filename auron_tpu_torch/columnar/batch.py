"""Device batch: padded columns + validity + row count (counterpart of
auron_tpu/columnar/batch.py).

Two column layouts: `DeviceColumn`, a flat tensor of a type's torch
dtype (a float32 as float32, a decimal(p <= 18) as its int64 unscaled
value: `from_numpy` takes the unscaled values, `to_numpy` gives them
back), and `DeviceStringColumn`, a string or binary column as a
zero-padded byte matrix `uint8[capacity, width]` with `int32` lengths.
A string column's width is the smallest `auron.string.width.buckets`
bucket that holds its longest value, so it differs between batches:
`concat_batches` pads every part to the widest.  A value longer than
`auron.string.device.max.width` has no device layout (the JAX package
keeps such a column on the host, which the port has not yet) and
raises.

Invariants every operator relies on:
- every column's length is the batch `capacity`, a power of two bucket
  (`bucket_capacity`);
- rows at index >= num_rows are padding: validity False, data zero;
- null slots hold canonical zeros (a string's bytes and length too).
Unlike the JAX package, `num_rows` is always a host int: torch runs
eagerly, and the operators that change a row count read it back once.
Shuffle blocks are the one exception to the padding: a block is a view
of one partition's rows in the writer's partition-sorted columns, so its
capacity is its row count (ops/shuffle/writer.py).  Their readers take
the live rows `[:num_rows]`, as every consumer here does.
"""

from __future__ import annotations

import decimal
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from auron_tpu_torch import resolve_device
from auron_tpu_torch.config import conf
from auron_tpu_torch.ir.schema import DataType, Schema, TypeId


def bucket_capacity(n: int) -> int:
    """Smallest power-of-two capacity >= n (bounded below by config)."""
    cap = int(conf.get("auron.batch.capacity.min"))
    n = max(int(n), 1)
    while cap < n:
        cap <<= 1
    return cap


def bucket_width(w: int) -> int:
    """Smallest configured string width bucket >= w."""
    buckets = [int(x) for x in
               str(conf.get("auron.string.width.buckets")).split(",")]
    for b in buckets:
        if w <= b:
            return b
    return buckets[-1]


def string_width(longest: int, dtype: DataType) -> int:
    """The width of a string column whose longest value has `longest`
    bytes: its bucket.  Raises past `auron.string.device.max.width` or
    the widest bucket: a value is never cut."""
    max_w = int(conf.get("auron.string.device.max.width"))
    w = bucket_width(max(longest, 1))
    if longest > min(max_w, w):
        raise NotImplementedError(
            f"a {dtype!r} value of {longest} bytes is longer than "
            f"auron.string.device.max.width ({max_w}) or the widest "
            f"string width bucket; such columns stay on the host as a "
            f"HostColumn in the JAX package, and host columns are not in "
            f"auron_tpu_torch yet")
    return w


def _pad(t: torch.Tensor, cap: int) -> torch.Tensor:
    """t padded with zeros along its rows (dim 0) to `cap` rows."""
    return torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 1) + (0, cap - t.shape[0]))


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

    def masked(self, keep: torch.Tensor) -> "DeviceColumn":
        """Rows where `keep` is False become null and zero."""
        return flat(self.dtype, self.data, self.validity & keep)

    def prefix(self, n: int) -> "DeviceColumn":
        """The first n rows (views)."""
        return DeviceColumn(self.dtype, self.data[:n], self.validity[:n])

    def take(self, idx: torch.Tensor) -> "DeviceColumn":
        """Rows by index, every index a row of the column."""
        return DeviceColumn(self.dtype, self.data[idx], self.validity[idx])

    def rows(self, lo: int, hi: int, cap: int) -> "DeviceColumn":
        """Rows [lo, hi) padded to `cap` rows."""
        return DeviceColumn(self.dtype, _pad(self.data[lo:hi], cap),
                            _pad(self.validity[lo:hi], cap))

    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size() + \
            self.validity.numel()


@dataclass
class DeviceStringColumn:
    """String or binary column: data uint8[capacity, width], zero-padded
    after each value, lengths int32[capacity], validity bool[capacity]."""
    dtype: DataType
    data: torch.Tensor
    lengths: torch.Tensor
    validity: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    def gather(self, indices: torch.Tensor, valid: torch.Tensor
               ) -> "DeviceStringColumn":
        """Row gather; rows whose `valid` is False become null and zero."""
        return string_col(self.dtype, self.data[indices],
                          self.lengths[indices], valid & self.validity[indices])

    def masked(self, keep: torch.Tensor) -> "DeviceStringColumn":
        """Rows where `keep` is False become null and zero."""
        return string_col(self.dtype, self.data, self.lengths,
                          self.validity & keep)

    def prefix(self, n: int) -> "DeviceStringColumn":
        """The first n rows (views)."""
        return DeviceStringColumn(self.dtype, self.data[:n],
                                  self.lengths[:n], self.validity[:n])

    def take(self, idx: torch.Tensor) -> "DeviceStringColumn":
        """Rows by index, every index a row of the column."""
        return DeviceStringColumn(self.dtype, self.data[idx],
                                  self.lengths[idx], self.validity[idx])

    def rows(self, lo: int, hi: int, cap: int) -> "DeviceStringColumn":
        """Rows [lo, hi) padded to `cap` rows."""
        return DeviceStringColumn(self.dtype, _pad(self.data[lo:hi], cap),
                                  _pad(self.lengths[lo:hi], cap),
                                  _pad(self.validity[lo:hi], cap))

    def widened(self, w: int) -> torch.Tensor:
        """The byte matrix padded with zero bytes to width w >= width."""
        if w == self.width:
            return self.data
        return torch.nn.functional.pad(self.data, (0, w - self.width))

    def nbytes(self) -> int:
        return self.data.numel() + 4 * self.lengths.numel() + \
            self.validity.numel()


Column = Union[DeviceColumn, DeviceStringColumn]


def flat(dtype: DataType, data: torch.Tensor, validity: torch.Tensor
         ) -> DeviceColumn:
    """A column with canonical zeros at null slots."""
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    return DeviceColumn(dtype, torch.where(validity, data, zero), validity)


def string_col(dtype: DataType, data: torch.Tensor, lengths: torch.Tensor,
               validity: torch.Tensor) -> DeviceStringColumn:
    """A string column with zero bytes and length at null slots."""
    return DeviceStringColumn(
        dtype, torch.where(validity[:, None], data, 0),
        torch.where(validity, lengths, 0), validity)


class Batch:
    __slots__ = ("schema", "columns", "num_rows", "capacity")

    def __init__(self, schema: Schema, columns: List[Column],
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

    def with_columns(self, schema: Schema, columns: List[Column]
                     ) -> "Batch":
        return Batch(schema, columns, self.num_rows, self.capacity)

    def rename(self, names) -> "Batch":
        return Batch(self.schema.rename(names), self.columns, self.num_rows,
                     self.capacity)

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
        return Batch(self.schema, [c.masked(keep) for c in self.columns], n,
                     self.capacity)

    def slice(self, offset: int, n: int) -> "Batch":
        """Rows [offset, offset + n) as a new padded batch."""
        cap = bucket_capacity(n)
        return Batch(self.schema, [c.rows(offset, offset + n, cap)
                                   for c in self.columns], n, cap)

    def to_numpy(self):
        """(arrays, validities) of the live rows, on the host.  A string
        column comes as an object array of `str` (STRING) or `bytes`
        (BINARY), a null row as the empty value."""
        n = self.num_rows
        return ([column_to_numpy(c, n) for c in self.columns],
                [c.validity[:n].cpu().numpy() for c in self.columns])


def column_to_numpy(c: Column, n: int) -> np.ndarray:
    """The first n values of a column as a host array."""
    if isinstance(c, DeviceColumn):
        return c.data[:n].cpu().numpy()
    w = c.width
    buf = c.data[:n].cpu().numpy().tobytes()
    vals = [buf[i * w:i * w + k]
            for i, k in enumerate(c.lengths[:n].cpu().tolist())]
    if c.dtype.id == TypeId.STRING:
        vals = [v.decode("utf-8") for v in vals]
    out = np.empty(n, dtype=object)
    out[:] = vals
    return out


def unscaled_of(value, scale: int) -> int:
    """A number's unscaled decimal value at `scale`, rounded half up: an
    int or a `Decimal` exactly, a float through its shortest text (as
    Spark's `Decimal(double)` reads a double)."""
    d = decimal.Decimal(repr(value)) if isinstance(value, float) else \
        decimal.Decimal(value)
    return int(d.scaleb(scale).to_integral_value(
        rounding=decimal.ROUND_HALF_UP))


def empty_numpy(dtype: DataType) -> np.ndarray:
    """A host array of no values of `dtype`, as `column_to_numpy` gives."""
    if dtype.is_stringlike:
        return np.empty(0, dtype=object)
    return torch.empty(0, dtype=dtype.torch_dtype()).numpy()


def _string_bytes(v) -> bytes:
    return v.encode("utf-8") if isinstance(v, str) else bytes(v)


def strings_from_numpy(dtype: DataType, a: Sequence, valid: np.ndarray,
                       cap: int, dev: torch.device) -> DeviceStringColumn:
    """A string column from host values (`str`, encoded as UTF-8, or
    `bytes`; None is null), without pyarrow: the UTF-8 bytes
    concatenated, then scattered into the zero-padded [cap, width]
    matrix in row order, as the JAX package's arrow import does from the
    offsets (`arrow_interop.py::_scatter_indices`).  Lengths count the
    bytes themselves, so trailing NUL bytes stay.  Raises for a value
    longer than `auron.string.device.max.width`."""
    n = len(a)
    ok = np.asarray(valid, dtype=bool) & np.array(
        [x is not None for x in a], dtype=bool)
    raw = [_string_bytes(x) if k else b"" for x, k in zip(a, ok.tolist())]
    lengths = np.fromiter(map(len, raw), dtype=np.int64, count=n)
    w = string_width(int(lengths.max()) if n else 0, dtype)
    mat = np.zeros((cap, w), dtype=np.uint8)
    # a row-major boolean assignment fills row 0's bytes, then row 1's:
    # the order of the concatenated values
    mat[:n][np.arange(w) < lengths[:, None]] = \
        np.frombuffer(b"".join(raw), dtype=np.uint8)
    ln = np.zeros(cap, dtype=np.int32)
    ln[:n] = lengths
    vm = np.zeros(cap, dtype=bool)
    vm[:n] = ok
    return DeviceStringColumn(dtype, torch.from_numpy(mat).to(dev),
                              torch.from_numpy(ln).to(dev),
                              torch.from_numpy(vm).to(dev))


def from_numpy(schema: Schema, arrays: Sequence[np.ndarray],
               validity: Optional[Sequence[Optional[np.ndarray]]] = None,
               device=None, capacity: Optional[int] = None) -> Batch:
    """A device batch from host numpy columns: the function that carries
    state into the port (the tests feed both engines the same arrays).
    A None validity means all rows are valid.  A string column comes as
    a sequence of `str` or `bytes` (`strings_from_numpy`)."""
    dev = resolve_device(device)
    n = len(arrays[0]) if len(arrays) else 0
    cap = capacity or bucket_capacity(n)
    cols: List[Column] = []
    for i, f in enumerate(schema):
        v = None if validity is None else validity[i]
        if f.dtype.is_stringlike:
            cols.append(strings_from_numpy(
                f.dtype, arrays[i], np.ones(n, bool) if v is None else v,
                cap, dev))
            continue
        tdt = f.dtype.torch_dtype()
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


def null_column(dtype: DataType, cap: int, dev: torch.device) -> Column:
    """An all-null column of `dtype` (a string column at the narrowest
    width bucket): an outer join's padding."""
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    if dtype.is_stringlike:
        return DeviceStringColumn(
            dtype, torch.zeros((cap, bucket_width(1)), dtype=torch.uint8,
                               device=dev),
            torch.zeros(cap, dtype=torch.int32, device=dev), valid)
    return DeviceColumn(dtype, torch.zeros(cap, dtype=dtype.torch_dtype(),
                                           device=dev), valid)


def empty_batch(schema: Schema, cap: int, dev: torch.device) -> Batch:
    """A batch of no rows at capacity `cap`."""
    return Batch(schema, [null_column(f.dtype, cap, dev) for f in schema],
                 0, cap)


def concat_device_columns(parts: List[Column]) -> Column:
    """One logical column's parts, every row of each (padding included),
    concatenated: the device concat of an uncompacted stream, whose rows
    a separate live mask marks.  String parts are padded to the widest."""
    if isinstance(parts[0], DeviceStringColumn):
        w = max(p.width for p in parts)
        return DeviceStringColumn(
            parts[0].dtype, torch.cat([p.widened(w) for p in parts]),
            torch.cat([p.lengths for p in parts]),
            torch.cat([p.validity for p in parts]))
    return DeviceColumn(parts[0].dtype, torch.cat([p.data for p in parts]),
                        torch.cat([p.validity for p in parts]))


def concat_batches(schema: Schema, batches: List[Batch],
                   capacity: Optional[int] = None) -> Batch:
    """Live rows of `batches`, in order, in one padded batch."""
    total = sum(b.num_rows for b in batches)
    cap = capacity or bucket_capacity(total)
    if cap < total:
        raise ValueError(f"concat capacity {cap} < total rows {total}")
    cols: List[Column] = []
    for ci, f in enumerate(schema):
        parts = [(b.columns[ci], b.num_rows) for b in batches]
        valid = _pad(torch.cat([p.validity[:n] for p, n in parts]), cap)
        if f.dtype.is_stringlike:
            # every part padded to the widest, so that one key has one
            # word list however wide the batch it came in
            w = max(p.width for p, _ in parts)
            cols.append(DeviceStringColumn(
                f.dtype, _pad(torch.cat([p.widened(w)[:n]
                                         for p, n in parts]), cap),
                _pad(torch.cat([p.lengths[:n] for p, n in parts]), cap),
                valid))
        else:
            cols.append(DeviceColumn(
                f.dtype, _pad(torch.cat([p.data[:n] for p, n in parts]), cap),
                valid))
    return Batch(schema, cols, total, cap)

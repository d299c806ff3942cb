"""Spill storage: host memory first, files second (counterpart of
auron_tpu/memmgr/spill.py).

A `Spill` holds a sequence of the port's own `Batch`es, written once and
read back (once, or more for a cross product).  The JAX tiers hold Arrow
frames; these hold each column's tensors (data, validity, and a string
column's byte matrix and lengths), the live rows only:
- `HostMemSpill` copies them to host memory, pinned where they come
  from the card, and copies them back to the device they came from;
- `FileSpill` writes the same tensors' bytes with numpy to a temporary
  file, compressed by `auron.spill.compression.codec` (`none` or
  `zlib`; `zstd` needs the zstandard module and raises, naming it, where
  that is missing).  The file's lifetime is bound to the spill object
  (`weakref.finalize`): garbage collection or the interpreter's exit
  unlinks it when `release()` was never called.
A read rebuilds each batch at the capacity it was written at, its
padding rows null and zero.  `SpillManager.new_spill` picks the tier
from `auron.spill.host.memory.first`; no tier falls back to the other.
The shuffle's wire frames (ROADMAP Queue 1 item 14), fault points and
spans (item 16) are not in the port yet.
"""

from __future__ import annotations

import os
import tempfile
import threading
import weakref
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceColumn, DeviceStringColumn,
)
from auron_tpu_torch.config import conf
from auron_tpu_torch.ir.schema import Schema


@dataclass
class _Frame:
    """One spilled batch: its schema, row count and capacity, the device
    it came from, and per column its kind (flat / string)."""
    schema: Schema
    num_rows: int
    capacity: int
    device: torch.device
    string: Tuple[bool, ...]


def _tensors(b: Batch) -> List[torch.Tensor]:
    """The live rows of every tensor of a batch, column by column."""
    n = b.num_rows
    out: List[torch.Tensor] = []
    for c in b.columns:
        if isinstance(c, DeviceStringColumn):
            out += [c.data[:n], c.lengths[:n], c.validity[:n]]
        else:
            out += [c.data[:n], c.validity[:n]]
    return out


def _frame(b: Batch) -> _Frame:
    dev = b.device if b.columns else torch.device("cpu")
    return _Frame(b.schema, b.num_rows, b.capacity, dev,
                  tuple(isinstance(c, DeviceStringColumn)
                        for c in b.columns))


def _padded(t: torch.Tensor, cap: int, dev: torch.device) -> torch.Tensor:
    """t on `dev`, zero-padded along its rows to `cap` rows."""
    out = torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=dev)
    out[:t.shape[0]].copy_(t, non_blocking=True)
    return out


def _rebuild(f: _Frame, tensors: List[torch.Tensor],
             device: Optional[torch.device]) -> Batch:
    dev = f.device if device is None else device
    it = iter(tensors)
    cols: List[Column] = []
    for field, is_string in zip(f.schema, f.string):
        if is_string:
            data, lengths, valid = next(it), next(it), next(it)
            cols.append(DeviceStringColumn(
                field.dtype, _padded(data, f.capacity, dev),
                _padded(lengths, f.capacity, dev),
                _padded(valid, f.capacity, dev)))
        else:
            data, valid = next(it), next(it)
            cols.append(DeviceColumn(field.dtype,
                                     _padded(data, f.capacity, dev),
                                     _padded(valid, f.capacity, dev)))
    return Batch(f.schema, cols, f.num_rows, f.capacity)


class Spill:
    """One spill unit: a sequence of batches, written once, read back
    once or more."""
    tier = ""

    def write_batches(self, batches: Iterable[Batch]) -> int:
        raise NotImplementedError

    def read_batches(self, device: Optional[torch.device] = None
                     ) -> Iterator[Batch]:
        raise NotImplementedError

    def release(self) -> None:
        pass

    @property
    def size_bytes(self) -> int:
        raise NotImplementedError


class HostMemSpill(Spill):
    """Host-memory tier: the tensors copied to host memory (pinned when
    they come from the card); one stream synchronization a write."""
    tier = "host"

    def __init__(self) -> None:
        self._frames: List[Tuple[_Frame, List[torch.Tensor]]] = []
        self._size = 0

    def write_batches(self, batches: Iterable[Batch]) -> int:
        on_card = False
        for b in batches:
            f = _frame(b)
            host = []
            for t in _tensors(b):
                pin = t.is_cuda
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                h.copy_(t, non_blocking=pin)
                on_card |= pin
                host.append(h)
                self._size += h.numel() * h.element_size()
            self._frames.append((f, host))
        if on_card:
            torch.cuda.current_stream().synchronize()
        return self._size

    def read_batches(self, device=None):
        for f, host in self._frames:
            yield _rebuild(f, host, device)

    def release(self) -> None:
        self._frames = []
        self._size = 0

    @property
    def size_bytes(self) -> int:
        return self._size


def codec_functions(name: Optional[str] = None
                    ) -> Tuple[Callable[[bytes], bytes],
                               Callable[[bytes], bytes]]:
    """(compress, decompress) of a spill codec: none, zlib, or zstd when
    the zstandard module is installed.  Any other name raises."""
    name = name or str(conf.get("auron.spill.compression.codec"))
    if name == "none":
        return bytes, bytes
    if name == "zlib":
        import zlib
        return (lambda b: zlib.compress(b, 1)), zlib.decompress
    if name == "zstd":
        try:
            import zstandard
        except ImportError as e:
            raise RuntimeError(
                "auron.spill.compression.codec=zstd needs the zstandard "
                "module, which is not installed; set the codec to 'none' "
                "or 'zlib'") from e
        return (zstandard.ZstdCompressor().compress,
                zstandard.ZstdDecompressor().decompress)
    raise ValueError(f"unknown spill compression codec {name!r}")


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


class FileSpill(Spill):
    """File tier.  The temporary file's lifetime is bound to the spill
    object: a `weakref.finalize` unlinks it when the spill is collected
    (a task that failed never calls release()) and at the interpreter's
    exit; `release()` is the eager path."""
    tier = "file"

    def __init__(self, directory: Optional[str] = None,
                 codec: Optional[str] = None):
        self._compress, self._decompress = codec_functions(codec)
        d = directory or str(conf.get("auron.spill.dir")) or None
        fd, self.path = tempfile.mkstemp(prefix="auron_spill_", dir=d)
        os.close(fd)
        self._size = 0
        # per batch: its frame, and per tensor (dtype, shape, bytes)
        self._index: List[Tuple[_Frame, List[Tuple[torch.dtype, tuple,
                                                   int]]]] = []
        self._cleanup = weakref.finalize(self, _unlink_quiet, self.path)

    def write_batches(self, batches: Iterable[Batch]) -> int:
        with open(self.path, "ab") as fh:
            for b in batches:
                entries = []
                for t in _tensors(b):
                    raw = self._compress(
                        t.cpu().contiguous().numpy().tobytes())
                    fh.write(raw)
                    entries.append((t.dtype, tuple(t.shape), len(raw)))
                    self._size += len(raw)
                self._index.append((_frame(b), entries))
        return self._size

    def read_batches(self, device=None):
        with open(self.path, "rb") as fh:
            for f, entries in self._index:
                tensors = []
                for dt, shape, nbytes in entries:
                    raw = self._decompress(fh.read(nbytes))
                    arr = np.frombuffer(raw, dtype=_np_dtype(dt)) \
                        .reshape(shape)
                    tensors.append(torch.from_numpy(arr.copy()))
                yield _rebuild(f, tensors, device)

    def release(self) -> None:
        self._cleanup()   # idempotent: detaches the finalizer and unlinks

    @property
    def size_bytes(self) -> int:
        return self._size


class SpillManager:
    """The spills of one consumer; picks the tier."""

    def __init__(self, name: str = "spill"):
        self.name = name
        self.spills: List[Spill] = []
        self._lock = threading.Lock()

    def new_spill(self, prefer_host: Optional[bool] = None) -> Spill:
        if prefer_host is None:
            prefer_host = bool(conf.get("auron.spill.host.memory.first"))
        s: Spill = HostMemSpill() if prefer_host else FileSpill()
        with self._lock:
            self.spills.append(s)
        return s

    def release_all(self) -> None:
        with self._lock:
            for s in self.spills:
                s.release()
            self.spills.clear()

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(s.size_bytes for s in self.spills)

    def __len__(self) -> int:
        with self._lock:
            return len(self.spills)

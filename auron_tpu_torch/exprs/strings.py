"""String equality and order over the padded device layout (counterpart
of auron_tpu/exprs/strings_device.py `string_eq`, `string_cmp` and
`_pad_width`).

A string column is a zero-padded byte matrix `uint8[rows, W]` with
`int32` lengths (`columnar/batch.py`); the bytes at or past a row's
length are zero.  Two operands may come in different width buckets:
each is padded with zero bytes to the wider, which keeps both equality
and order.  An operand may also be a single row (`[1, W]` bytes, one
length, one validity), which broadcasts against a column: a string
literal compared with a column is one row, never a `[rows, W]` matrix.
"""

from __future__ import annotations

import torch

from auron_tpu_torch.columnar.batch import DeviceStringColumn


def _pad_width(data: torch.Tensor, w: int) -> torch.Tensor:
    """The byte matrix padded with zero bytes to width w >= its own."""
    cur = int(data.shape[1])
    if cur == w:
        return data
    return torch.nn.functional.pad(data, (0, w - cur))


def string_eq(a: DeviceStringColumn, b: DeviceStringColumn
              ) -> torch.Tensor:
    """bool[rows]: the same bytes and the same length (validity is the
    caller's)."""
    w = max(a.width, b.width)
    same = (_pad_width(a.data, w) == _pad_width(b.data, w)).all(1)
    return same & (a.lengths == b.lengths)


def string_cmp(a: DeviceStringColumn, b: DeviceStringColumn
               ) -> torch.Tensor:
    """int32[rows] of -1 / 0 / 1: Spark's binary order of unsigned
    bytes.  The first differing byte decides; where every byte is the
    same (pad bytes included), the shorter sorts first, so a proper
    prefix comes first and "ab" before "ab\\x00"."""
    w = max(a.width, b.width)
    diff = _pad_width(a.data, w).to(torch.int16) - \
        _pad_width(b.data, w).to(torch.int16)
    nz = diff != 0
    first = diff.gather(1, nz.to(torch.uint8).argmax(1, keepdim=True))[:, 0]
    len_cmp = torch.sign(a.lengths - b.lengths)
    return torch.where(nz.any(1), torch.sign(first).to(torch.int32),
                       len_cmp.to(torch.int32))

"""Spark-compatible murmur3 on torch tensors (counterpart of
auron_tpu/exprs/hashing.py).

pid = pmod(murmur3(keys, seed=42), num_partitions), bit-identical to
Spark and to the JAX package, so both engines shuffle alike.

torch has no uint32 shift, add, compare or modulo on every backend, so
the 32-bit words live in int64 tensors holding values in [0, 2^32) and
every step masks back to 32 bits.  A product of two such words would
overflow int64; `_mul32` splits the constant into 16-bit halves so every
intermediate stays below 2^49.  The same code runs on the CPU and the
card, and is the plain version the hash-pid kernel is held against.
Strings hash as Spark's `hashUnsafeBytes` (`hash_bytes`), in torch ops
as the JAX package computes them with jnp ops; no kernel of either
package computes it.
"""

from __future__ import annotations

from typing import List

import torch

from auron_tpu_torch.columnar.batch import Column, DeviceStringColumn
from auron_tpu_torch.ir.schema import TypeId

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return _mul32(_rotl32(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl32(h1 ^ k1, 13)
    return (_mul32(h1, 5) + 0xE6546B64) & _M32


def _fmix(h1: torch.Tensor, length: int) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _words_of_i64(v: torch.Tensor):
    v = v.to(torch.int64)
    return v & _M32, (v >> 32) & _M32


def hash_int32(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashInt: v int32 values, seed int64 words in [0, 2^32)."""
    k1 = _mix_k1(v.to(torch.int64) & _M32)
    return _fmix(_mix_h1(seed, k1), 4)


def hash_int64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashLong: the value as two 4-byte blocks (low word first)."""
    lo, hi = _words_of_i64(v)
    h1 = _mix_h1(seed, _mix_k1(lo))
    h1 = _mix_h1(h1, _mix_k1(hi))
    return _fmix(h1, 8)


_CANONICAL_NAN = 0x7FF8000000000000


def hash_float64(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashLong of `Double.doubleToLongBits`: -0.0 hashes as 0.0 and
    every NaN as the canonical NaN 0x7FF8000000000000, as Spark hashes
    them (the JAX package hashes a NaN's own bits, ROADMAP Queue 3)."""
    v = v.to(torch.float64)
    v = torch.where(v == 0.0, torch.zeros((), dtype=v.dtype,
                                          device=v.device), v)
    bits = torch.where(torch.isnan(v), _CANONICAL_NAN, v.view(torch.int64))
    return hash_int64(bits, seed)


def hash_bytes(data: torch.Tensor, lengths: torch.Tensor,
               seed: torch.Tensor) -> torch.Tensor:
    """Spark's hashUnsafeBytes of zero-padded byte rows: data
    uint8[rows, W], lengths int32[rows], seed int64 words in [0, 2^32).
    Each row mixes its len // 4 little-endian 4-byte blocks, then each
    tail byte as a *signed* int8, then fmix with its length.  The blocks
    of every position are read and mixed (`_mix_k1`) at once; only the
    chain into h, which each row takes as far as its own length, goes
    block by block."""
    rows, w = data.shape
    if w % 4:
        data = torch.nn.functional.pad(data, (0, 4 - w % 4))
    ln = lengths.to(torch.int64)
    nblocks = ln // 4
    # little-endian int32 words of each 4-byte block, as u32 in int64
    k1 = _mix_k1(data.contiguous().view(torch.int32).to(torch.int64)
                 & _M32)
    h = seed
    for b in range(k1.shape[1]):
        h = torch.where(b < nblocks, _mix_h1(h, k1[:, b]), h)
    # the (up to 3) tail bytes, sign-extended to 32 bits
    at = torch.clamp(nblocks[:, None] * 4 + torch.arange(
        3, device=data.device), max=data.shape[1] - 1)
    tail = torch.gather(data, 1, at).to(torch.int64)
    tail = _mix_k1(torch.where(tail >= 128, tail - 256, tail) & _M32)
    for t in range(3):
        h = torch.where(nblocks * 4 + t < ln, _mix_h1(h, tail[:, t]), h)
    return _fmix(h, ln)


def hash_column(col: Column, seed: torch.Tensor) -> torch.Tensor:
    """Per-type dispatch; null rows keep the incoming seed."""
    if isinstance(col, DeviceStringColumn):
        return torch.where(col.validity,
                           hash_bytes(col.data, col.lengths, seed), seed)
    tid = col.dtype.id
    if tid in (TypeId.BOOL, TypeId.INT8, TypeId.INT16, TypeId.INT32,
               TypeId.DATE32):
        h = hash_int32(col.data, seed)
    elif tid in (TypeId.INT64, TypeId.TIMESTAMP_US):
        h = hash_int64(col.data, seed)
    elif tid == TypeId.FLOAT64:
        h = hash_float64(col.data, seed)
    else:
        raise TypeError(f"unhashable type {col.dtype!r} in auron_tpu_torch")
    return torch.where(col.validity, h, seed)


def hash_columns(cols: List[Column], seed: int = 42) -> torch.Tensor:
    """Chained multi-column hash (each column's hash seeds the next),
    Spark HashExpression semantics; returns int32."""
    v0 = cols[0].validity
    h = torch.full(v0.shape, seed & _M32, dtype=torch.int64,
                   device=v0.device)
    for c in cols:
        h = hash_column(c, h)
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def pmod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Positive modulo of int32 hashes (the partition id)."""
    return torch.remainder(x.to(torch.int64), m).to(torch.int32)

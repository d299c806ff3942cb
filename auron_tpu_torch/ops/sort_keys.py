"""Sortable key encoding (counterpart of auron_tpu/ops/sort_keys.py).

Each sort key column becomes words whose lexicographic order is the SQL
order (asc/desc, nulls first/last): a leading null-rank word, then the
value words.  Multi-key order is a stable lexsort over the concatenated
word list.

Word representation.  torch has no uint64 comparison or sort, so every
word is an int64 tensor:
- a u32 word (a claim of at most 32 bits: null rank, bool, int8/16/32,
  date32, float32) is held as its non-negative value;
- a u64 word (a claim of 64 bits: int64, timestamp, decimal(p <= 18)
  as its unscaled value, float64, each 8 bytes of a string) is held as
  `u ^ 2^63`, so that signed order is unsigned order.
A string or binary column of width W gives ceil(W / 8) words, its bytes
big-endian 8 at a time (zero-padded), then its length as a u32 word:
Spark's binary order, where a proper prefix sorts first and `"ab"`
before `"ab\\x00"`.  The words depend on the width, so the rows they
compare must be at one width (`concat_batches` pads every part to the
widest).
The words are the JAX package's words in this representation, with two
differences.  For float64 and float32: Spark compares -0.0 equal to 0.0
and puts every NaN after +inf, all NaNs equal.  The JAX encoder orders
-0.0 before 0.0 and a NaN with its sign bit set before -inf; the port
normalises -0.0 to 0.0 and every NaN to the positive quiet NaN before
encoding, which gives Spark's order (ROADMAP Queue 3).  A float32 key
is one u32 word of its orderable bits, where the JAX package's
`_orderable_u64_from_f32` puts the same 32 bits in the high half of a
u64 word: the order is the same.

The JAX package's `auron.sort.f64.exactbits` (an exact float64 encoding
for backends that demote float64) and `auron.sort.multipass.enable`
(one multi-key lexsort in place of composed argsorts) have no
counterpart: torch keeps float64 exact on the card and the CPU, and has
no multi-key sort, so the argsort strategy is always the composition.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from auron_tpu_torch.columnar.batch import Column, DeviceStringColumn
from auron_tpu_torch.ir.schema import DataType, TypeId
from auron_tpu_torch.ops.radix_sort import SIGN64, radix_sort_indices
from auron_tpu_torch.ops.strategy import sort_strategy

MASK32 = 0xFFFFFFFF
# int64 view of a negative double, xor this: the order-preserving word
F64_NEG_FLIP = 0x7FFFFFFFFFFFFFFF

NARROW_INTS = (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.DATE32)
WIDE_INTS = (TypeId.INT64, TypeId.TIMESTAMP_US)


def value_bits(dtype: DataType) -> int:
    """Claimed bit width of a column's value word (before the null-rank
    word): 1 for bool, 32 for narrow ints, 64 for 64-bit types and for
    each byte word of a string (whose count depends on the column's
    width, `encode_key_column_bits`); raises for a type the port cannot
    encode yet."""
    if dtype.id == TypeId.BOOL:
        return 1
    if dtype.id in NARROW_INTS or dtype.id == TypeId.FLOAT32:
        return 32
    if dtype.id in WIDE_INTS or dtype.id == TypeId.FLOAT64 or \
            dtype.is_stringlike or \
            (dtype.is_decimal and not dtype.is_wide_decimal):
        return 64
    raise NotImplementedError(
        f"sort keys of type {dtype!r} are not in auron_tpu_torch yet")


def normalize_f64(x: torch.Tensor) -> torch.Tensor:
    """-0.0 as 0.0 and every NaN as the positive quiet NaN, as Spark's
    `NormalizeFloatingNumbers` emits grouping keys."""
    x = torch.where(x == 0, 0.0, x)
    return torch.where(torch.isnan(x), float("nan"), x)


def f64_word(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving int64 word of a float64 (normalized first):
    Spark's order, -0.0 equal to 0.0, every NaN equal and above +inf."""
    b = normalize_f64(x).view(torch.int64)
    return torch.where(b >= 0, b, b ^ F64_NEG_FLIP)


def f64_from_word(w: torch.Tensor) -> torch.Tensor:
    """Inverse of `f64_word` on its image: the (normalized) float64."""
    return torch.where(w >= 0, w, w ^ F64_NEG_FLIP).view(torch.float64)


def f32_word(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving u32 word (in int64) of a float32, normalized
    first: the bits with the sign flipped for a non-negative value, all
    flipped for a negative one (`_orderable_u64_from_f32`'s high word)."""
    b = normalize_f64(x).to(torch.float32).view(torch.int32) \
        .to(torch.int64) & MASK32
    return torch.where(b < (1 << 31), b ^ (1 << 31), b ^ MASK32)


def f32_from_word(w: torch.Tensor) -> torch.Tensor:
    """Inverse of `f32_word` on its image: the (normalized) float32."""
    b = torch.where(w >= (1 << 31), w ^ (1 << 31), w ^ MASK32)
    return torch.where(b >= (1 << 31), b - (1 << 32), b) \
        .to(torch.int32).view(torch.float32)


def string_words(col: DeviceStringColumn) -> List[torch.Tensor]:
    """The byte words of a string column (ascending), then its length."""
    rows, w = col.data.shape
    nw = (w + 7) // 8
    d = col.data if w == 8 * nw else \
        torch.nn.functional.pad(col.data, (0, 8 * nw - w))
    # 8 bytes reversed and read as a little-endian int64 is the u64 of
    # the bytes big-endian; then the word's top bit flipped
    be = d.reshape(rows, nw, 8).flip(-1).contiguous().view(torch.int64)
    words = list((be.reshape(rows, nw) ^ SIGN64).unbind(1))
    return words + [col.lengths.to(torch.int64)]


def encode_key_column(col: Column, asc: bool = True,
                      nulls_first: bool = True) -> List[torch.Tensor]:
    """-> [null rank, value word(s)] as int64[capacity] words, most
    significant first."""
    # the rank is 1 where the row sorts after the other kind
    null_rank = (col.validity if nulls_first else ~col.validity) \
        .to(torch.int64)
    if isinstance(col, DeviceStringColumn):
        words = string_words(col)
        if not asc:
            words = [~w for w in words[:-1]] + [words[-1] ^ MASK32]
        return [null_rank] + words
    tid = col.dtype.id
    nbits = value_bits(col.dtype)
    if tid == TypeId.FLOAT64:
        w = f64_word(col.data)
    elif tid == TypeId.FLOAT32:
        w = f32_word(col.data)
    elif tid in NARROW_INTS:
        w = col.data.to(torch.int64) + (1 << 31)
    else:   # bool, int64, timestamp, decimal
        w = col.data.to(torch.int64)
    if not asc:
        w = ~w if nbits == 64 else w ^ MASK32
    return [null_rank, w]


def encode_key_column_bits(col: Column) -> List[int]:
    """Meaningful bit width of each word `encode_key_column` emits (of the
    unflipped value set); must stay in lockstep with it."""
    if isinstance(col, DeviceStringColumn):
        return [1] + [64] * ((col.width + 7) // 8) + [32]
    return [1, value_bits(col.dtype)]


def encode_sort_keys(cols: Sequence[Column],
                     orders: Sequence[Tuple[bool, bool]]
                     ) -> List[torch.Tensor]:
    """Columns + (asc, nulls_first) -> word list, most significant
    first."""
    words: List[torch.Tensor] = []
    for col, (asc, nf) in zip(cols, orders):
        words.extend(encode_key_column(col, asc, nf))
    return words


def encode_sort_keys_bits(cols: Sequence[Column]) -> List[int]:
    """Bit widths parallel to encode_sort_keys' word list."""
    bits: List[int] = []
    for col in cols:
        bits.extend(encode_key_column_bits(col))
    return bits


def lexsort_indices(words: List[torch.Tensor], num_rows: int, capacity: int,
                    bits: Optional[List[int]] = None) -> torch.Tensor:
    """Stable argsort by word list (most significant first); padding rows
    (index >= num_rows) sort last.  Returns the int64 permutation.  With
    no padding (num_rows == capacity) no pad-rank word is sorted."""
    if words and num_rows >= capacity:
        return lexsort_indices_live(words, None, bits)
    dev = words[0].device if words else None
    live = torch.arange(capacity, device=dev) < num_rows
    return lexsort_indices_live(words, live, bits)


def _multipass_lexsort(keys: List[torch.Tensor]) -> torch.Tensor:
    """Composed stable single-word argsorts, least significant key first
    (`keys` as jnp.lexsort takes them: primary key last)."""
    perm: Optional[torch.Tensor] = None
    for k in keys:
        data = k if perm is None else k[perm]
        p = torch.sort(data, stable=True).indices
        perm = p if perm is None else perm[p]
    return perm


def sort_form(capacity: int, n_words: int, device_type: str) -> str:
    """The form `lexsort_indices_live` sorts in: 'radix' (the pack-sort)
    or 'multipass' (composed stable argsorts)."""
    if sort_strategy(capacity, max(n_words, 1), device_type) == "radix":
        return "radix"
    return "multipass"


def lexsort_indices_live(words: List[torch.Tensor],
                         live: Optional[torch.Tensor],
                         bits: Optional[List[int]] = None) -> torch.Tensor:
    """Stable argsort by word list from an explicit live mask (non-live
    rows sort last; None: every row is live).  The strategy is the JAX
    package's: the pack-sort of ops/radix_sort.py, or stable argsorts
    composed (multipass); both give the same permutation."""
    ref = words[0] if live is None else live
    if sort_form(int(ref.shape[0]), len(words), ref.device.type) == "radix":
        return radix_sort_indices(words, bits, live)
    # a word of at most 8 claimed bits (a null or pad rank) sorts as
    # uint8: a radix sort of one byte in place of eight
    bits = bits if bits is not None else [64] * len(words)
    keys = [w.to(torch.uint8) if b <= 8 else w for w, b in zip(words, bits)]
    lead = [] if live is None else [(~live).to(torch.uint8)]
    return _multipass_lexsort(list(reversed(lead + keys)))


def keys_equal_prev(words: List[torch.Tensor]) -> torch.Tensor:
    """bool[rows]: row i's words all equal row i-1's (row 0: False).  The
    group boundaries of sorted key words."""
    same: Optional[torch.Tensor] = None
    for w in words:
        e = w[1:] == w[:-1]
        same = e if same is None else same & e
    return torch.cat([same.new_zeros(1), same])

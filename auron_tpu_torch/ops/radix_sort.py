"""Stable argsort built from value sorts: the pack-sort (counterpart of
auron_tpu/ops/radix_sort.py).

The row index is packed into the low bits of the key word and the packed
word is value-sorted; the low bits come back out as the permutation.
Multi-word keys compose least-significant group first, each pass
carrying the current permutation position in its rank bits, so ties
keep the previous pass's order and the composition is a stable lexsort.
Words are greedily packed: one pass sorts as many adjacent words as fit
in 64 bits minus the rank bits.  Packed keys are distinct, so any sort of
them gives the one stable lexsort permutation.

The value sort of each pass is `torch.sort` on the int64 form of the
packed word (its top bit flipped, so signed order is unsigned order),
standing in for the JAX package's `jnp.sort`.  Words follow the
representation of ops/sort_keys.py: a word claiming more than 32 bits is
held as `u ^ 2^63`, a narrower one as its non-negative value.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

SIGN64 = -(1 << 63)          # int64 with only the top bit set
_MASK32 = 0xFFFFFFFF


def ceil_log2(n: int) -> int:
    """Bits needed to index n slots (>=1)."""
    return max(1, (int(n) - 1).bit_length())


def radix_supported(capacity: int) -> bool:
    """Pack-sort needs the rank carry + at least a 32-bit word half to fit
    one 64-bit pass."""
    return 1 <= capacity <= (1 << 31)


def _units(words: Sequence[torch.Tensor], bits: Sequence[int], budget: int
           ) -> List[Tuple[torch.Tensor, int]]:
    """Split words wider than the per-pass budget into 32-bit halves and
    mask every unit to its claimed bits.  Masking is order-preserving for
    descending (flipped) words: flipping maps {0..2^b-1} to itself under
    the b-bit mask.  Right shifts of int64 are arithmetic, so each is
    masked."""
    units: List[Tuple[torch.Tensor, int]] = []
    for w, b in zip(words, bits):
        u = w ^ SIGN64 if b > 32 else w      # the word's unsigned bits
        if b > budget:
            units.append(((u >> 32) & _MASK32, 32))
            units.append((u & _MASK32, 32))
        else:
            units.append((u & ((1 << b) - 1), b))
    return units


def _plan_passes(units: List[Tuple[torch.Tensor, int]], budget: int
                 ) -> List[List[Tuple[torch.Tensor, int]]]:
    """Greedy LSD packing: walk units least-significant first, filling
    each pass up to `budget` bits; within a pass units keep their
    most-significant-first order."""
    passes: List[List[Tuple[torch.Tensor, int]]] = []
    cur: List[Tuple[torch.Tensor, int]] = []
    cur_bits = 0
    for w, b in reversed(units):
        if cur and cur_bits + b > budget:
            passes.append(cur)
            cur, cur_bits = [], 0
        cur.insert(0, (w, b))
        cur_bits += b
    if cur:
        passes.append(cur)
    return passes


def radix_sort_indices(words: Sequence[torch.Tensor],
                       bits: Optional[Sequence[int]] = None,
                       live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable argsort by word list (most-significant first): non-live rows
    sort last, ties keep the original row order.  Returns the int64
    (torch's index type) permutation of all `capacity` rows.  `bits[i]`
    is the meaningful bit width of the unflipped value set of words[i]."""
    if not words and live is None:
        raise ValueError("radix_sort_indices needs at least one word")
    capacity = int((words[0] if words else live).shape[0])
    if not radix_supported(capacity):
        raise ValueError(f"capacity {capacity} outside pack-sort range")
    if bits is None:
        # 64 is safe for both representations: a narrow word's value s
        # reads as the u64 s + 2^63, in the same order
        bits = [64] * len(words)
    rank_bits = ceil_log2(capacity)
    budget = 64 - rank_bits
    ws: List[torch.Tensor] = list(words)
    bs: List[int] = list(bits)
    if live is not None:
        ws = [(~live).to(torch.int64)] + ws
        bs = [1] + bs
    passes = _plan_passes(_units(ws, bs, budget), budget)
    rank_mask = (1 << rank_bits) - 1
    dev = ws[0].device
    pos0 = torch.arange(capacity, dtype=torch.int64, device=dev)
    perm: Optional[torch.Tensor] = None
    for p in passes:
        key: Optional[torch.Tensor] = None
        for w, b in p:
            w = w if perm is None else w[perm]
            key = w if key is None else (key << b) | w
        key = (key << rank_bits) | pos0
        # the packed word is an unsigned 64-bit value: flip its top bit
        # so that torch's signed sort orders it as unsigned
        pos = torch.sort(key ^ SIGN64).values & rank_mask
        perm = pos if perm is None else perm[pos]
    if perm is None:
        perm = pos0
    return perm

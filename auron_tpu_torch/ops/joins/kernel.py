"""The shared join kernel: sorted-hash build table + searchsorted probe
(counterpart of auron_tpu/ops/joins/kernel.py).

Build:  key columns -> 64-bit hash (two murmur3 passes packed) with a
        null-key sentinel -> stable argsort -> (sorted_hashes, perm)
Probe:  probe hashes -> [lo, hi) by searchsorted -> candidate counts ->
        chunked pair expansion -> exact key verification -> joined rows.

All device work is torch ops; the JAX package's is jnp (its `join.range`
and `join.pair` programs), no Pallas kernel.

Hash words.  torch has no unsigned 64-bit sort or searchsorted, so the
packed u64 hash `(h1 << 32) | h2` is held as int64 with its top bit
flipped (`u ^ 2^63`), as the sort words of ops/sort_keys.py are: signed
order is then unsigned order, and both sentinels (`NULL_BUILD` =
2^64 - 1, `NULL_PROBE` = 2^64 - 2) keep their places at the top.  Each
murmur3 pass is masked to 32 bits before the shift.

Float keys follow Spark (`NormalizeFloatingNumbers`): -0.0 joins 0.0
and a NaN joins every NaN.  The port's `hash_float64` and
`hash_float32` hash -0.0 as 0.0 and every NaN as the canonical NaN, and
`verify_pairs` holds two NaNs equal.  A decimal(p <= 18) key hashes and
compares as its unscaled int64 (both sides of one type, as Spark casts
them).  The JAX package hashes a NaN's own bits and compares with `==`,
so no NaN key matches there (ROADMAP Queue 3).

String keys hash as Spark's `hashUnsafeBytes` (`hash_bytes`, over the
same [2, rows] seed) and verify by `string_eq`, the two sides padded to
the wider width bucket.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from auron_tpu_torch.columnar.batch import (
    Batch, Column, DeviceStringColumn, null_column,
)
from auron_tpu_torch.exprs.hashing import hash_column
from auron_tpu_torch.exprs.strings import string_eq
from auron_tpu_torch.ir.schema import Schema
from auron_tpu_torch.ops.radix_sort import SIGN64, radix_sort_indices
from auron_tpu_torch.ops.strategy import join_probe_strategy, sort_strategy

# the sentinels u64 2^64 - 1 (build) and 2^64 - 2 (probe), top bit flipped
NULL_BUILD = (1 << 63) - 1
NULL_PROBE = (1 << 63) - 2
SEED_1, SEED_2 = 42, 0x9747B28C


def join_key_hash(cols: List[Column]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 hash words, bool all-keys-valid): two chained murmur3
    passes, seeds 42 and 0x9747B28C, packed into 64 bits (the first in
    the high half), the top bit flipped.  Both passes run as one over a
    [2, rows] seed (`hash_column` broadcasts it), so the data's mixing
    is computed once and each op launches once for both."""
    valid = cols[0].validity
    h = (torch.arange(2, device=valid.device) * (SEED_2 - SEED_1) +
         SEED_1)[:, None]
    for c in cols:
        h = hash_column(c, h)
    h = ((h[0] << 32) | h[1]) ^ SIGN64
    for c in cols[1:]:
        valid = valid & c.validity
    return h, valid


def stable_hash_argsort(h: torch.Tensor) -> torch.Tensor:
    """The stable ascending permutation of hash words: equal hashes keep
    their row order, so pairs come out in build order within a hash.
    The pack-sort (ops/radix_sort.py) or a stable `torch.sort`, as
    `sort_strategy` resolves for the device (the JAX package's
    `stable_argsort_u64` or `jnp.argsort`)."""
    cap = int(h.shape[0])
    if sort_strategy(cap, 1, h.device.type) == "radix":
        # the flipped word reads as u64 again under the 64-bit claim
        return radix_sort_indices([h], [64])
    return torch.sort(h, stable=True).indices


@dataclass
class BuildTable:
    """The 'hash map': the build rows and their hash-sorted permutation.
    `live` marks real rows: `batch` may be an uncompacted device concat of
    the build stream, whose dead rows carry the null sentinel and never
    match (so its padding is not at the end, unlike other batches)."""
    batch: Batch
    key_cols: List[Column]
    sorted_hashes: torch.Tensor      # int64 words, ascending
    perm: torch.Tensor               # int64: sorted position -> batch row
    live: torch.Tensor               # bool[capacity]

    @staticmethod
    def build(batch: Batch, key_cols: List[Column],
              live: Optional[torch.Tensor] = None) -> "BuildTable":
        join_probe_strategy()
        h, valid = join_key_hash(key_cols)
        if live is None:
            live = torch.arange(batch.capacity, device=h.device) < \
                batch.num_rows
        h = torch.where(live & valid, h, NULL_BUILD)
        perm = stable_hash_argsort(h)
        return BuildTable(batch=batch, key_cols=key_cols,
                          sorted_hashes=h[perm], perm=perm, live=live)


def probe_ranges(sorted_hashes: torch.Tensor, probe_hash: torch.Tensor,
                 probe_valid: torch.Tensor, probe_live: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, counts): each probe row's candidates are sorted positions
    [lo, lo + counts); a null or dead probe row gets the probe sentinel,
    which no build row holds."""
    ph = torch.where(probe_live & probe_valid, probe_hash, NULL_PROBE)
    lo = torch.searchsorted(sorted_hashes, ph)
    hi = torch.searchsorted(sorted_hashes, ph, right=True)
    return lo, hi - lo


def _keys_equal(p: Column, b: Column) -> torch.Tensor:
    """Row-wise key equality, Spark's for floats: -0.0 = 0.0, NaN = NaN;
    strings by their bytes and lengths."""
    if isinstance(p, DeviceStringColumn):
        return string_eq(p, b)
    eq = p.data == b.data
    if p.dtype.is_floating:
        eq = eq | (torch.isnan(p.data) & torch.isnan(b.data))
    return eq


def verify_pairs(probe_keys: List[Column], build_keys: List[Column],
                 probe_idx: torch.Tensor, build_idx: torch.Tensor,
                 pair_live: torch.Tensor) -> torch.Tensor:
    """Exact key equality of candidate pairs (the hash-collision filter);
    a null key matches nothing."""
    ok = pair_live
    for pk, bk in zip(probe_keys, build_keys):
        p = pk.gather(probe_idx, pair_live)
        b = bk.gather(build_idx, pair_live)
        ok = ok & _keys_equal(p, b) & p.validity & b.validity
    return ok


def expand_pairs(lo: torch.Tensor, counts: torch.Tensor, chunk_start: int,
                 chunk_cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pair slots [chunk_start, chunk_start + chunk_cap) of the probe
    rows' candidate lists laid end to end: (probe row, offset in its
    list, live) per slot."""
    prefix = torch.cumsum(counts, 0)                 # inclusive
    starts = prefix - counts
    slots = chunk_start + torch.arange(chunk_cap, dtype=torch.int64,
                                       device=lo.device)
    probe_idx = torch.searchsorted(prefix, slots, right=True)
    live = slots < prefix[-1]
    safe = torch.clamp(probe_idx, max=counts.shape[0] - 1)
    return safe, slots - starts[safe], live


def mark_matched(matched: torch.Tensor, idx: torch.Tensor,
                 ok: torch.Tensor) -> torch.Tensor:
    """matched[i] |= any(ok[j] for idx[j] == i).  The indices repeat, so
    an accumulating `index_add_` (deterministic for integers), not a
    plain scatter."""
    hits = torch.zeros(matched.shape[0], dtype=torch.int32,
                       device=matched.device)
    hits.index_add_(0, idx, ok.to(torch.int32))
    return matched | (hits > 0)


def compact_padded(mask: torch.Tensor, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices, count) of the set bits of `mask`, ascending, padded to
    `cap` slots, the count left on the device: the compaction of the
    JAX package's `compact_indices`, with no host read."""
    m = mask.to(torch.int64)
    pos = torch.cumsum(m, 0) - 1
    # unset rows write to a spare slot past the end
    target = torch.where(mask, pos, cap)
    out = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, target, torch.arange(mask.shape[0], dtype=torch.int64,
                                         device=mask.device))
    return out[:cap], m.sum()


def null_columns_like(schema: Schema, capacity: int,
                      dev: torch.device) -> List[Column]:
    """All-null columns of a schema: outer-join padding."""
    return [null_column(f.dtype, capacity, dev) for f in schema]


def probe_range(pkeys: List[Column], sorted_hashes: torch.Tensor,
                probe_num_rows: int):
    """Once per probe batch: key hash + range lookup, (lo, counts, total
    pairs on the device); every chunk of the pair program reads them."""
    pcap = pkeys[0].validity.shape[0]
    plive = torch.arange(pcap, device=sorted_hashes.device) < probe_num_rows
    ph, pvalid = join_key_hash(pkeys)
    lo, counts = probe_ranges(sorted_hashes, ph, pvalid, plive)
    return lo, counts, counts.sum()


@dataclass
class PairChunk:
    """What one chunk of the pair program gives: the pairs' probe and
    build columns, the probe-side emission (on the final chunk), the
    packed (total, pairs, side rows) on the device, the updated flags."""
    out_p: List[Column]
    out_b: List[Column]
    side_cols: List[Column]
    counts3: torch.Tensor
    probe_matched: torch.Tensor
    build_matched: torch.Tensor


def pair_chunk(probe_cols, pkeys, build_cols, bkeys, lo, counts, total,
               perm, probe_num_rows: int, probe_matched, build_matched,
               start: int, chunk_cap: int, *, emit_pairs: bool,
               track_build: bool, side_kind: str, is_final: bool
               ) -> PairChunk:
    """The per-chunk probe program: pair expansion -> verification ->
    matched flags -> pair gathers -> (final chunk only) the probe-side
    emission of unmatched, semi or anti rows."""
    pcap = probe_matched.shape[0]
    bcap = perm.shape[0]
    dev = lo.device
    probe_idx, offset, pair_live = expand_pairs(lo, counts, start, chunk_cap)
    sorted_pos = torch.clamp(lo[probe_idx] + offset, 0, bcap - 1)
    build_idx = perm[sorted_pos]
    ok = verify_pairs(pkeys, bkeys, probe_idx, build_idx, pair_live)
    probe_matched = mark_matched(probe_matched, probe_idx, ok)
    if track_build:
        build_matched = mark_matched(build_matched, build_idx, ok)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out_p: List[Column] = []
    out_b: List[Column] = []
    n_pairs = zero
    if emit_pairs:
        idx, n_pairs = compact_padded(ok, chunk_cap)
        ev = torch.arange(chunk_cap, device=dev) < n_pairs
        pi, bi = probe_idx[idx], build_idx[idx]
        out_p = [c.gather(pi, ev) for c in probe_cols]
        out_b = [c.gather(bi, ev) for c in build_cols]
    side_cols: List[Column] = []
    n_side = zero
    if is_final and side_kind in ("unmatched", "semi", "anti"):
        plive = torch.arange(pcap, device=dev) < probe_num_rows
        smask = probe_matched if side_kind == "semi" else ~probe_matched
        sidx, n_side = compact_padded(smask & plive, pcap)
        sv = torch.arange(pcap, device=dev) < n_side
        side_cols = [c.gather(sidx, sv) for c in probe_cols]
    counts3 = torch.stack([total, n_pairs, n_side])
    return PairChunk(out_p, out_b, side_cols, counts3, probe_matched,
                     build_matched)

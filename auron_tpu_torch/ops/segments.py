"""Segment reductions (counterpart of auron_tpu/ops/segments.py:
`sorted_segment_sum`).

The JAX package reduces sorted segment ids with a cumulative sum and a
binary search for each segment's bounds, the gather-shaped form a TPU
wants.  On the card the port sums with `index_add_` over the ids, which
needs no order: its float additions land in no fixed order, so float
sums match other engines to a tolerance, not bit for bit.  Integer sums
are exact (and wrap on overflow, as the JAX package's do).  Min and max
segments come with the Min/Max aggregates.
"""

from __future__ import annotations

import torch


def sorted_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s] = sum of x[i] over the rows with seg[i] == s, for s in
    [0, num_segments); an empty segment sums to 0."""
    return torch.zeros(num_segments, dtype=x.dtype,
                       device=x.device).index_add_(0, seg, x)

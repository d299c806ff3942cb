"""Segment reductions (counterpart of auron_tpu/ops/segments.py:
`sorted_segment_sum`, `sorted_segment_min`, `sorted_segment_max`).

The JAX package reduces sorted segment ids with a cumulative scan and a
binary search for each segment's bounds, the gather-shaped form a TPU
wants.  On the card the port reduces with `index_add_` and
`scatter_reduce_` over the ids, which need no order: float additions land
in no fixed order, so float sums match other engines to a tolerance, not
bit for bit.  Integer sums are exact (and wrap on overflow, as the JAX
package's do); minima and maxima are exact.

Float64 minima and maxima reduce over the order-preserving int64 word of
ops/sort_keys.py and are decoded afterwards, which gives Spark's order:
every NaN equal and above +inf, -0.0 equal to 0.0.  A NaN or a zero that
wins comes out normalized (the positive quiet NaN, 0.0).  The JAX
package's `jnp.minimum` scan propagates NaN instead, so its min of
[1.0, NaN] is NaN where Spark's is 1.0 (ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from auron_tpu_torch.ops.sort_keys import f64_from_word, f64_word


def sorted_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s] = sum of x[i] over the rows with seg[i] == s, for s in
    [0, num_segments); an empty segment sums to 0."""
    return torch.zeros(num_segments, dtype=x.dtype,
                       device=x.device).index_add_(0, seg, x)


def _extreme(x: torch.Tensor, seg: torch.Tensor, num_segments: int,
             is_min: bool) -> torch.Tensor:
    """out[s] = min (max) of x over segment s; an empty segment holds the
    type's identity: +inf / -inf for float64, the integer type's maximum
    / minimum, true / false for bool.  The rows reduce among themselves
    only (include_self is False), so a float segment of NaNs alone gives
    NaN, not the identity."""
    op = "amin" if is_min else "amax"
    if x.dtype == torch.bool:          # false < true, as Spark orders
        return _extreme(x.to(torch.uint8), seg, num_segments,
                        is_min).to(torch.bool)
    if x.dtype == torch.float64:
        ident = torch.full((num_segments,), float("inf") if is_min
                           else float("-inf"), dtype=torch.float64,
                           device=x.device)
        return f64_from_word(f64_word(ident).scatter_reduce_(
            0, seg, f64_word(x), op, include_self=False))
    info = torch.iinfo(x.dtype)
    out = torch.full((num_segments,), info.max if is_min else info.min,
                     dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, op, include_self=False)


def sorted_segment_min(x: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    return _extreme(x, seg, num_segments, True)


def sorted_segment_max(x: torch.Tensor, seg: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    return _extreme(x, seg, num_segments, False)

"""Kernel-strategy selection for sorts and join probes (counterpart of
auron_tpu/ops/strategy.py; `sort_strategy` and `join_probe_strategy`).

`auron.kernel.sort.strategy` picks the argsort family of the encoded
sort-key sorts.  Where the JAX package resolves 'auto' by
`jax.default_backend()`, the port resolves it by the device type of the
rows: 'cuda' like the JAX 'gpu' backend (argsort), 'cpu' like 'cpu'
(radix above `auron.kernel.sort.radix.min.rows`, when the cost model
agrees).  The cost model is the JAX package's embedded seed: per-row
costs from its recorded XLA-CPU kernel profile (BENCH_r05, 4M rows),
which decide 'auto' there and so decide it here; they are no
measurement of the port.  The calibration and profile-file sources of
the JAX cost model are not in the port.
"""

from __future__ import annotations

from auron_tpu_torch.config import conf
from auron_tpu_torch.ops.radix_sort import radix_supported

# the JAX package's seed profile: argsort of 4M u64 keys in 1666.42 ms,
# and a pack-sort pass taken as 1/4.8 of it when no radix time is recorded
_SEED_ARGSORT_U64_MS = 1666.42
_SEED_PROFILE_ROWS = 1 << 22
ARGSORT_NS = _SEED_ARGSORT_U64_MS * 1e6 / _SEED_PROFILE_ROWS
PACKSORT_PASS_NS = ARGSORT_NS / 4.8


def sort_strategy(capacity: int, n_words: int = 1,
                  device_type: str = "cuda") -> str:
    """'radix' | 'argsort' for a sort of `capacity` rows on a device of
    type `device_type`.  Forced values apply on every device (within the
    pack-sort's capacity range)."""
    mode = str(conf.get("auron.kernel.sort.strategy"))
    if mode in ("radix", "argsort"):
        return mode if radix_supported(capacity) else "argsort"
    if device_type != "cpu" or not radix_supported(capacity):
        return "argsort"
    if capacity < int(conf.get("auron.kernel.sort.radix.min.rows")):
        return "argsort"
    # one packed pass per ~32-bit word group vs one argsort per word
    est_radix = 2.0 * n_words * PACKSORT_PASS_NS
    est_argsort = n_words * ARGSORT_NS
    return "radix" if est_radix < est_argsort else "argsort"


def join_probe_strategy() -> str:
    """'searchsorted' for a hash-join probe (ops/joins/kernel.py).

    The JAX package resolves 'auto' to searchsorted on a GPU and to its
    bucket-partitioned probe index (`kernel.py::ProbeIndex`) on the CPU
    backend; both give the same (lo, counts).  The port resolves 'auto'
    to searchsorted on every device: the partitioned index is not in the
    port yet, and forcing it raises."""
    mode = str(conf.get("auron.kernel.join.probe.strategy"))
    if mode == "partitioned":
        raise NotImplementedError(
            "auron.kernel.join.probe.strategy=partitioned: the "
            "bucket-partitioned probe index (ProbeIndex, build_probe_index, "
            "bounded_probe) is not in auron_tpu_torch yet")
    if mode not in ("auto", "searchsorted"):
        raise ValueError(f"unknown join probe strategy {mode!r}")
    return "searchsorted"

"""Device-memory budget with host and file spill (counterpart of
auron_tpu/memmgr): a registry of `MemConsumer`s with wait-or-spill
arbitration (`manager.py`) and the spill tiers (`spill.py`).  The JAX
package's per-query kill and pressure hooks (`set_kill_hook`,
`set_pressure_hook`, `reset_hooks`) wait for the port's tracing and
task pool (ROADMAP Queue 1 items 16 and 18)."""

from auron_tpu_torch.memmgr.manager import (
    MemConsumer, MemManager, get_manager,
)
from auron_tpu_torch.memmgr.spill import Spill, SpillManager

__all__ = ["MemConsumer", "MemManager", "get_manager", "Spill",
           "SpillManager"]

"""A bounded ring of structured events (counterpart of
auron_tpu/runtime/events.py).

Each event is one dict: a monotone sequence number, a wall timestamp,
a kind, a message, the affected query ids and free-form attributes.
The ring holds the newest `MAX_EVENTS` and is process-wide; emitting is
one append under one lock, cheap enough to stay always on (the emit
sites are failure and lifecycle paths, never per batch).  The JAX
package's fleet and serving tier emit most of its events; the port has
neither yet (ROADMAP Queue 1 item 18), so the module is here for the
sites that come with them.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["emit", "snapshot", "clear"]

# The JAX package's default for `auron.events.max`; the port has no
# emitter that needs another bound yet.
MAX_EVENTS = 512

_LOCK = threading.Lock()
_EVENTS: List[Dict[str, Any]] = []
_SEQ = 0


def emit(kind: str, message: str = "",
         query_ids: Iterable[str] = (), **attrs: Any) -> Dict[str, Any]:
    """Record one event; returns the stored dict (its `seq` is the
    cursor `snapshot(since=)` pages by)."""
    global _SEQ
    ev = {"kind": kind, "message": message, "t": time.time(),
          "query_ids": [str(q) for q in query_ids]}
    if attrs:
        ev["attrs"] = {k: v for k, v in attrs.items() if v is not None}
    with _LOCK:
        _SEQ += 1
        ev["seq"] = _SEQ
        _EVENTS.append(ev)
        if len(_EVENTS) > MAX_EVENTS:
            del _EVENTS[:len(_EVENTS) - MAX_EVENTS]
    return ev


def snapshot(since: int = 0, kind: Optional[str] = None,
             query_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Events with seq > `since`, oldest first, optionally filtered by
    kind prefix and by affected query id."""
    with _LOCK:
        evs = [dict(e) for e in _EVENTS if e["seq"] > int(since)]
    if kind:
        evs = [e for e in evs if str(e["kind"]).startswith(kind)]
    if query_id:
        evs = [e for e in evs if query_id in e.get("query_ids", ())]
    return evs


def clear() -> None:
    """Test hook: empty the ring (the sequence keeps counting, so `since`
    cursors stay monotone across a clear)."""
    with _LOCK:
        _EVENTS.clear()

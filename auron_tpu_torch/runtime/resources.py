"""Task-scoped resource registry (counterpart of
auron_tpu/runtime/resources.py).

Front ends and exchanges park batch sources and shuffle writers here
under the string ids that plan nodes name (FFIReader.resource_id,
IpcReader.resource_id, RssShuffleWriter.rss_resource_id); a broadcast
join's build table is cached here under `bhm:<cache id>` for every task
of the stage that shares the registry.
"""

from __future__ import annotations

import threading
from typing import Any, Dict


class ResourceRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._map: Dict[str, Any] = {}

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._map[key] = value

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._map

    def get(self, key: str) -> Any:
        with self._lock:
            if key not in self._map:
                raise KeyError(f"resource {key!r} not registered")
            return self._map[key]

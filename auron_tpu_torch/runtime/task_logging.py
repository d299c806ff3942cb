"""Structured task logging (counterpart of
auron_tpu/runtime/task_logging.py).

A contextvar carries (stage_id, partition_id) across a task's generator
frames, and a `logging.Filter` puts the prefix on every record of the
`auron_tpu_torch` logger tree.  The prefix carries the query id too when
one is ambient (runtime/tracing.py mints it per `AuronSession.execute`):
``[q 3f2a9c stage 1 part 0]``, the key that span attributes and the
query record use as well, so a log line, a trace span and a metric tree
correlate on one string.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
from typing import Iterator, Optional, Tuple

_task: contextvars.ContextVar[Optional[Tuple[int, int]]] = \
    contextvars.ContextVar("auron_torch_task", default=None)


class TaskContextFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        ctx = _task.get()
        from auron_tpu_torch.runtime.tracing import current_query_id
        qid = current_query_id()
        if ctx is not None:
            q = f"q {qid} " if qid else ""
            record.task = f"[{q}stage {ctx[0]} part {ctx[1]}] "
        elif qid:
            record.task = f"[q {qid}] "
        else:
            record.task = ""
        return True


_installed = False


def install() -> None:
    """Attach the prefixing filter and formatter to the package logger
    (idempotent).  The handler is added only where neither the package
    logger nor the root logger has one, so an application that set up
    its own logging sees each record once; the level is left as the
    application set it (WARNING by default), so `DebugExec` reads no
    rows back from the device unless someone asked for INFO."""
    global _installed
    if _installed:
        return
    logger = logging.getLogger("auron_tpu_torch")
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s "
                              "%(task)s%(message)s"))
        handler.addFilter(TaskContextFilter())
        logger.addHandler(handler)
    _installed = True


@contextlib.contextmanager
def task_scope(stage_id: int, partition_id: int) -> Iterator[None]:
    token = _task.set((stage_id, partition_id))
    try:
        yield
    finally:
        _task.reset(token)


def current() -> Optional[Tuple[int, int]]:
    return _task.get()


def current_ids() -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """(query_id, stage_id, partition_id): the whole correlation key."""
    from auron_tpu_torch.runtime.tracing import current_query_id
    ctx = _task.get()
    if ctx is None:
        return current_query_id(), None, None
    return current_query_id(), ctx[0], ctx[1]

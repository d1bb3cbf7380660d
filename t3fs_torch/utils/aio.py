"""Asyncio teardown helper (the port's copy of t3fs/utils/aio.reap_task)."""

from __future__ import annotations

import asyncio
import logging

_fallback_log = logging.getLogger("t3fs_torch.aio")


async def reap_task(task: asyncio.Task | None,
                    log: logging.Logger | None = None,
                    what: str = "task") -> None:
    """Await a (typically just-cancelled) background task to completion.

    Cancellation is the expected outcome and stays silent; any other
    exception means the worker crashed at some point and is logged with
    its traceback.  If the *caller* is cancelled while reaping, that
    cancellation propagates normally.
    """
    if task is None:
        return
    try:
        # shield: a bare `await task` links the awaiter's cancellation to
        # the task, which would make the task look self-cancelled and
        # swallow the awaiter's cancel
        await asyncio.shield(task)
    except asyncio.CancelledError:
        # the task's own cancellation is the expected outcome; if the
        # *awaiter* was cancelled instead (task still running), propagate
        if not task.cancelled():
            raise
    except Exception:
        (log or _fallback_log).exception("%s crashed before teardown", what)

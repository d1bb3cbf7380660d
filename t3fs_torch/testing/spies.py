"""Class-level spies for the benches and the card's smoke script: collect
the objects a coroutine method ran on or returned, or look at an object
just before it stops."""

from __future__ import annotations

import contextlib
import inspect


@contextlib.contextmanager
def spied(cls, name: str, seen: list, result: bool = False):
    """cls.name (a coroutine method) wrapped while the block runs: each call
    appends its result (result=True) or its self to seen."""
    orig = getattr(cls, name)

    async def spy(self, *args, **kwargs):
        out = await orig(self, *args, **kwargs)
        seen.append(out if result else self)
        return out
    setattr(cls, name, spy)
    try:
        yield seen
    finally:
        setattr(cls, name, orig)


@contextlib.contextmanager
def checked_before_stop(cls, check):
    """cls.stop runs check(self) first while the block runs (awaiting what
    it returns, where that is awaitable); the object stops even where the
    check raises."""
    orig = cls.stop

    async def stop(self):
        try:
            out = check(self)
            if inspect.isawaitable(out):
                await out
        finally:
            await orig(self)
    cls.stop = stop
    try:
        yield
    finally:
        cls.stop = orig

"""Two-layer fault injection, mirroring the reference (SURVEY.md §4):

1. In-process probabilistic injection points (FAULT_INJECTION_POINT macro,
   common/utils/FaultInjection.h:16-33): code calls fault_point("name") at
   interesting spots; an enabled injector fires with probability p.
2. Wire-level DebugFlags carried per request (fbs/storage/Common.h:290-307):
   inject_server_error / inject_client_error probabilities + a countdown of
   injection points to pass before failing.
"""

from __future__ import annotations

import contextlib
import contextvars
import random
from dataclasses import dataclass, field

from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import StatusCode, make_error

_injection = contextvars.ContextVar("t3fs_fault_injection", default=None)


@dataclass
class Injection:
    probability: float = 0.0      # chance each fault_point fires
    max_count: int = -1           # total fires allowed (-1 = unlimited)
    fired: int = 0
    rng: random.Random = field(default_factory=random.Random)


@contextlib.contextmanager
def enable_injection(probability: float, max_count: int = -1, seed: int | None = None):
    inj = Injection(probability, max_count)
    if seed is not None:
        inj.rng.seed(seed)
    token = _injection.set(inj)
    try:
        yield inj
    finally:
        _injection.reset(token)


def fault_point(name: str) -> bool:
    """Returns True if a fault should be injected here."""
    inj = _injection.get()
    if inj is None or inj.probability <= 0:
        return False
    if 0 <= inj.max_count <= inj.fired:
        return False
    if inj.rng.random() < inj.probability:
        inj.fired += 1
        return True
    return False


def fault_raise(name: str, code: StatusCode = StatusCode.INTERNAL) -> None:
    if fault_point(name):
        raise make_error(code, f"fault injection at {name}")


@serde_struct
@dataclass
class DebugFlags:
    """Carried in storage requests; drives server/client-side injection
    (reference fbs/storage/Common.h:290-307)."""
    inject_server_error_prob: float = 0.0
    inject_client_error_prob: float = 0.0
    num_points_before_fail: int = 0

    def server_should_fail(self, rng: random.Random | None = None) -> bool:
        r = (rng or random).random()
        return self.inject_server_error_prob > 0 and r < self.inject_server_error_prob

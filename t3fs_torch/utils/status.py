"""Status error model: the subset of t3fs/utils/status.py the codec seams
raise.  Codes keep the reference's numeric values so errors read the same
on either package."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class StatusCode(enum.IntEnum):
    OK = 0
    INTERNAL = 2005


@dataclass(frozen=True)
class Status:
    code: StatusCode = StatusCode.OK
    message: str = ""


class StatusError(Exception):
    """Exception form of a non-OK Status."""

    def __init__(self, code: StatusCode, message: str = ""):
        super().__init__(f"{StatusCode(code).name}: {message}")
        self.status = Status(StatusCode(code), message)

    @property
    def code(self) -> StatusCode:
        return self.status.code


def make_error(code: StatusCode, message: str = "") -> StatusError:
    return StatusError(code, message)

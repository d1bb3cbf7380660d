"""The port's host library as it loads where io_uring_setup is refused, for
the tests of the native transport's failure path.  Imported by
tests/test_torch_port_hygiene.py and tests/test_torch_native_net.py."""

import pytest


class RefusingLib:
    """The host library with t3fs_pump_create returning NULL, as it does
    where the syscall fails; every other symbol is the real one."""

    def __init__(self, lib):
        self._lib = lib

        def t3fs_pump_create(entries):
            return None
        self.t3fs_pump_create = t3fs_pump_create

    def __getattr__(self, name):
        return getattr(self._lib, name)


def refuse_pump(monkeypatch: pytest.MonkeyPatch) -> None:
    """Make every NativePump made from now on fail as io_uring_setup's
    refusal makes it fail (the pumps of running loops stay)."""
    from t3fs_torch.ops import _build

    lib = _build.host_library()
    monkeypatch.setattr(_build, "host_library", lambda: RefusingLib(lib))

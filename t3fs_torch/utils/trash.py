"""Trash: mv-to-trash UX + expiry cleaner over the t3fs namespace.

Reference analogs: hf3fs_utils/trash.py (timestamped trash directories
named "{config}-{start}-{end}" in %Y%m%d_%H%M slices; TrashConfig presets
1h/3h/8h/1d/3d/7d) and src/client/trash_cleaner/ (the scanner that deletes
entries whose end timestamp has passed).  Same directory-name convention,
driven through the async FileSystem instead of a FUSE mountpoint.

The port of t3fs/utils/trash.py.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone

from t3fs_torch.utils.status import StatusCode, StatusError

log = logging.getLogger("t3fs_torch.trash")

DATE_FORMAT = "%Y%m%d_%H%M"
TRASH_ROOT = "/trash"


def format_date(t: datetime) -> str:
    return t.astimezone(timezone.utc).strftime(DATE_FORMAT)


def parse_date(s: str) -> datetime:
    return datetime.strptime(s, DATE_FORMAT).replace(tzinfo=timezone.utc)


@dataclass
class TrashConfig:
    name: str
    expire: timedelta
    time_slice: timedelta

    def __post_init__(self):
        assert self.name and "-" not in self.name, f"invalid name {self.name}"
        assert self.time_slice >= timedelta(minutes=1)
        assert self.time_slice < self.expire

    def current_dir(self, now: datetime | None = None) -> str:
        """Slice-aligned directory: items dropped in the same slice share a
        dir, and its name carries the expiry the cleaner acts on."""
        now = now or datetime.now(timezone.utc)
        slice_s = int(self.time_slice.total_seconds())
        ts = int(now.timestamp()) // slice_s * slice_s
        start = datetime.fromtimestamp(ts, timezone.utc)
        end = start + self.expire + self.time_slice
        return f"{self.name}-{format_date(start)}-{format_date(end)}"


TRASH_CONFIGS = {
    "1h": TrashConfig("1h", timedelta(hours=1), timedelta(minutes=10)),
    "3h": TrashConfig("3h", timedelta(hours=3), timedelta(minutes=30)),
    "8h": TrashConfig("8h", timedelta(hours=8), timedelta(minutes=30)),
    "1d": TrashConfig("1d", timedelta(days=1), timedelta(hours=1)),
    "3d": TrashConfig("3d", timedelta(days=3), timedelta(days=1)),
    "7d": TrashConfig("7d", timedelta(days=7), timedelta(days=1)),
}


def parse_trash_dir(name: str) -> tuple[str, datetime, datetime] | None:
    """"{config}-{start}-{end}" -> parts, or None for foreign entries."""
    parts = name.split("-")
    if len(parts) != 3:
        return None
    try:
        return parts[0], parse_date(parts[1]), parse_date(parts[2])
    except ValueError:
        return None


class Trash:
    """App-side: move paths into timestamped trash dirs instead of deleting
    (hf3fs_cli mv-to-trash UX)."""

    def __init__(self, fs):
        self.fs = fs  # t3fs_torch.fuse.vfs.FileSystem

    async def put(self, path: str, ttl: str = "3d") -> str:
        cfg = TRASH_CONFIGS.get(ttl)
        if cfg is None:
            raise ValueError(f"unknown trash ttl {ttl!r} "
                             f"(have {sorted(TRASH_CONFIGS)})")
        slot = f"{TRASH_ROOT}/{cfg.current_dir()}"
        try:
            await self.fs.mkdirs(slot)
        except StatusError as e:
            if "EXISTS" not in e.code.name:
                raise
        base = path.rstrip("/").rsplit("/", 1)[-1]
        dest = f"{slot}/{base}"
        for i in range(1, 1000):
            try:
                await self.fs.stat(dest)
            except StatusError as e:
                if "NOT_FOUND" not in e.code.name:
                    raise  # transient error is NOT evidence the name is free
                break
            dest = f"{slot}/{base}.{i}"
        else:
            # rename overwrites an existing destination — never risk
            # clobbering previously trashed data
            raise StatusError(StatusCode.META_EXISTS,
                              f"trash slot exhausted for {base!r}")
        await self.fs.rename(path, dest)
        return dest

    async def list(self) -> list[tuple[str, datetime, list[str]]]:
        """[(trash-dir, expiry, entries)] for valid trash slots."""
        out = []
        try:
            slots = await self.fs.readdir(TRASH_ROOT)
        except StatusError:
            return []
        for e in slots:
            parsed = parse_trash_dir(e.name)
            if parsed is None:
                continue
            entries = [x.name for x in
                       await self.fs.readdir(f"{TRASH_ROOT}/{e.name}")]
            out.append((e.name, parsed[2], entries))
        return out


class TrashCleaner:
    """Daemon-side: delete trash dirs whose end timestamp has passed
    (src/client/trash_cleaner/src/main.rs clean_if_expired analog)."""

    def __init__(self, fs):
        self.fs = fs

    async def clean_once(self, now: datetime | None = None) -> list[str]:
        now = now or datetime.now(timezone.utc)
        removed = []
        try:
            slots = await self.fs.readdir(TRASH_ROOT)
        except StatusError:
            return removed
        for e in slots:
            parsed = parse_trash_dir(e.name)
            if parsed is None:
                log.info("trash: skipping foreign entry %r", e.name)
                continue
            name, begin, end = parsed
            if begin > end:
                log.warning("trash: %r has begin > end; skipping", e.name)
                continue
            if now >= end:
                path = f"{TRASH_ROOT}/{e.name}"
                try:
                    await self.fs.unlink(path, recursive=True)
                    removed.append(e.name)
                    log.info("trash: removed expired %r", e.name)
                except StatusError as err:
                    log.warning("trash: failed to remove %r: %s", e.name, err)
        return removed

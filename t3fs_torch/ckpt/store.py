"""Checkpoint manifest store: listing, atomic commit, keep-last-N GC.

A checkpoint directory holds one committed manifest file per step
(`step-NNN.t3ckpt`) plus, transiently, the in-flight temp the writer is
filling.  Commit is write-temp + meta `rename` (flags=0 replaces, so
re-committing a step is atomic too): a manifest is either fully present or
absent — there is no torn-commit state to repair, only orphaned data
chunks, which a resumed save reuses and GC of the step reclaims.

The port of t3fs/ckpt/store.py.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from t3fs_torch.ckpt.manifest import (CheckpointManifest, MANIFEST_SUFFIX,
                                manifest_name, parse_step)
from t3fs_torch.client.ec_client import PARITY_NS
from t3fs_torch.client.layout import FileLayout
from t3fs_torch.utils import serde
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.ckpt")


@dataclass
class GCReport:
    steps_removed: list[int] = field(default_factory=list)
    steps_kept: list[int] = field(default_factory=list)
    leaves_removed: int = 0
    bytes_removed: int = 0


class CheckpointStore:
    """Manifest-file operations for one checkpoint directory."""

    def __init__(self, fs, directory: str):
        self.fs = fs
        self.directory = directory.rstrip("/")

    def _path(self, step: int) -> str:
        return f"{self.directory}/{manifest_name(step)}"

    async def list_steps(self) -> list[int]:
        """Committed steps, ascending; [] when the directory is absent."""
        try:
            entries = await self.fs.readdir(self.directory)
        except StatusError as e:
            if e.status.code in (StatusCode.NOT_FOUND,
                                 StatusCode.META_NOT_FOUND):
                return []
            raise
        return sorted(s for e in entries
                      if (s := parse_step(e.name)) is not None)

    async def load(self, step: int | None = None) -> CheckpointManifest:
        """Load one step's manifest (default: the latest committed)."""
        if step is None:
            steps = await self.list_steps()
            if not steps:
                raise make_error(
                    StatusCode.NOT_FOUND,
                    f"{self.directory}: no committed checkpoints")
            step = steps[-1]
        blob = await self.fs.read_file(self._path(step))
        manifest = serde.loads(blob)
        if not isinstance(manifest, CheckpointManifest):
            raise make_error(
                StatusCode.INVALID_ARG,
                f"{self._path(step)}: not a checkpoint manifest")
        return manifest

    async def commit(self, manifest: CheckpointManifest) -> str:
        """Atomic commit point: the manifest blob lands at a temp path and
        a single meta `rename` makes the checkpoint visible.  Data chunks
        written before a crash are invisible until this rename — a re-run
        finds them by CRC probe (resume) or reclaims them via GC."""
        try:
            await self.fs.mkdirs(self.directory, recursive=True)
        except StatusError as e:
            if e.status.code != StatusCode.META_EXISTS:
                raise
        final = self._path(manifest.step)
        tmp = f"{self.directory}/.tmp-{manifest_name(manifest.step)}"
        try:
            # a stale temp from a crashed commit would splice its tail into
            # a shorter re-write (write_file opens existing files in place)
            await self.fs.unlink(tmp)
        except StatusError:
            pass
        await self.fs.write_file(tmp, serde.dumps(manifest))
        await self.fs.rename(tmp, final)
        return final

    async def remove(self, storage_client, step: int) -> GCReport:
        """Drop one step: data + parity chunks on every chain first, the
        manifest last — interrupted removal leaves a manifest whose re-GC
        is idempotent, never chunks with no manifest pointing at them."""
        report = GCReport(steps_removed=[step])
        manifest = await self.load(step)
        lay = manifest.layout
        flayout = FileLayout(chunk_size=lay.chunk_size, chains=lay.chains)
        for lf in manifest.leaves:
            await storage_client.remove_file_chunks(flayout, lf.inode)
            await storage_client.remove_file_chunks(flayout,
                                                    lf.inode | PARITY_NS)
            report.leaves_removed += 1
            report.bytes_removed += lf.nbytes
        await self.fs.unlink(self._path(step))
        return report

    async def gc(self, storage_client, keep_last: int) -> GCReport:
        """Keep the newest `keep_last` committed steps, reclaim the rest."""
        if keep_last < 1:
            raise make_error(StatusCode.INVALID_ARG,
                             f"keep_last must be >= 1, got {keep_last}")
        steps = await self.list_steps()
        report = GCReport(steps_kept=steps[len(steps) - keep_last:]
                          if keep_last < len(steps) else steps)
        for step in steps[:max(0, len(steps) - keep_last)]:
            one = await self.remove(storage_client, step)
            report.steps_removed += one.steps_removed
            report.leaves_removed += one.leaves_removed
            report.bytes_removed += one.bytes_removed
            log.info("ckpt gc: removed step %d (%d leaves, %d bytes)",
                     step, one.leaves_removed, one.bytes_removed)
        return report

"""Scrub-target discovery from checkpoint metadata.

The ScrubScheduler originally needed every EC file registered by hand
(`add_target`), which meant nothing protected a checkpoint the operator
forgot to register.  Checkpoints are the one place the metadata already
knows everything scrub needs: a committed manifest carries the ECLayout,
each leaf's hash-derived inode, and the byte counts the per-stripe
length map derives from.  `manifest_discovery` turns one or more
checkpoint directories into a `ScrubScheduler(discovery=...)` callable
that walks the committed steps through the meta layer each tick — new
steps enter scrub the moment their manifest rename lands, GC'd steps
drop out before the walk can probe reclaimed chunks, and bit-rot found
by a storage node's CheckWorker heals with no manual registration at
all (the soak harness's disk-fault path).

Target naming is `<directory>/step-N/<leaf-path>` — stable across
refreshes (cursors survive) and readable in `repair-status` output.

The port of t3fs/ckpt/scrub.py.
"""

from __future__ import annotations

from t3fs_torch.ckpt.store import CheckpointStore
from t3fs_torch.storage.scrub_scheduler import ScrubTarget


async def checkpoint_scrub_targets(store: CheckpointStore
                                   ) -> list[ScrubTarget]:
    """One ScrubTarget per leaf of every committed step in `store`'s
    directory.  Steps whose manifest vanishes mid-walk (concurrent GC)
    are skipped, not errors — the next refresh won't list them."""
    targets: list[ScrubTarget] = []
    for step in await store.list_steps():
        try:
            manifest = await store.load(step)
        except Exception:
            continue
        lay = manifest.layout
        for lf in manifest.leaves:
            stripe_lens = {s: lf.stripe_len(lay, s)
                           for s in range(lf.num_stripes)}
            targets.append(ScrubTarget(
                name=f"{store.directory}/step-{step}/{lf.path}",
                layout=lay, inode=lf.inode, stripe_lens=stripe_lens))
    return targets


def manifest_discovery(fs, directories: list[str]):
    """-> async callable for `ScrubScheduler(discovery=...)` covering
    every checkpoint directory in `directories` through one meta fs."""
    stores = [CheckpointStore(fs, d) for d in directories]

    async def discover() -> list[ScrubTarget]:
        found: list[ScrubTarget] = []
        for store in stores:
            found.extend(await checkpoint_scrub_targets(store))
        return found

    return discover

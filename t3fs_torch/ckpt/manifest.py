"""Checkpoint manifest: the serde commit record + pytree (de)structuring.

The manifest is the checkpoint's ONLY metadata: leaf data chunks live at
hash-derived inodes (kvcache-style zero-metadata placement — no create/open
per leaf), so a checkpoint "exists" exactly when its manifest file does.
The writer commits it last via write-temp + meta `rename`; everything the
reader, scrubber, and GC need (treedef, per-leaf shard map, per-shard
committed CRCs, the ECLayout itself) is inside.

Treedef: dict/list/tuple nesting is recorded as a JSON skeleton whose
leaves are indices into the manifest's leaf list (dict keys sorted, the
order JAX's tree utilities use), so restore rebuilds the exact container
structure from the manifest alone.

The port of t3fs/ckpt/manifest.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from hashlib import blake2b

from t3fs_torch.client.ec_client import ECLayout
from t3fs_torch.utils.status import StatusCode, make_error
from t3fs_torch.utils.serde import serde_struct

# bit 63 marks client-derived inode namespaces (kvcache uses the same bit
# with a different person tag); the hash is masked to 61 bits so bit 62
# (the EC parity chunk-id namespace) never collides with a derived inode
_CKPT_NS = 1 << 63
_HASH_MASK = (1 << 61) - 1

MANIFEST_SUFFIX = ".t3ckpt"


def ckpt_inode(directory: str, step: int, leaf_path: str) -> int:
    """Deterministic data inode for one leaf of one checkpoint: re-running
    an interrupted save lands on the same chunks (resume), with no meta
    round trip on the data path."""
    h = blake2b(f"{directory}\x00{step}\x00{leaf_path}".encode(),
                digest_size=8, person=b"t3fs-ckp")
    return _CKPT_NS | (int.from_bytes(h.digest(), "big") & _HASH_MASK)


def manifest_name(step: int) -> str:
    return f"step-{step:012d}{MANIFEST_SUFFIX}"


def parse_step(name: str) -> int | None:
    """step-NNN{suffix} -> NNN; None for anything else (tmp files etc.)."""
    if not (name.startswith("step-") and name.endswith(MANIFEST_SUFFIX)):
        return None
    digits = name[len("step-"):-len(MANIFEST_SUFFIX)]
    return int(digits) if digits.isdigit() else None


@serde_struct
@dataclass
class CkptLeaf:
    """One pytree leaf's shard map: where its bytes live and what CRC each
    stored chunk committed with (`shard_crcs` is num_stripes x (k+m), data
    shards then parity per stripe; 0 marks a zero-hole data shard that is
    ABSENT by the EC decode contract)."""
    path: str = ""
    dtype: str = ""
    shape: list[int] = field(default_factory=list)
    nbytes: int = 0
    inode: int = 0
    num_stripes: int = 0
    shard_crcs: list[int] = field(default_factory=list)

    def stripe_len(self, layout: ECLayout, stripe: int) -> int:
        full = layout.k * layout.chunk_size
        return max(0, min(full, self.nbytes - stripe * full))

    def stripe_crcs(self, layout: ECLayout, stripe: int) -> list[int]:
        n = layout.k + layout.m
        return self.shard_crcs[stripe * n:(stripe + 1) * n]


@serde_struct
@dataclass
class CheckpointManifest:
    version: int = 1
    directory: str = ""
    step: int = 0
    treedef: str = ""                # JSON skeleton; leaves = indices
    layout: ECLayout | None = None
    leaves: list[CkptLeaf] = field(default_factory=list)
    created_at: float = 0.0

    def leaf(self, path: str) -> CkptLeaf:
        for lf in self.leaves:
            if lf.path == path:
                return lf
        raise make_error(StatusCode.NOT_FOUND,
                         f"checkpoint step {self.step}: no leaf {path!r}")

    def total_bytes(self) -> int:
        return sum(lf.nbytes for lf in self.leaves)


# --- pytree structuring (dict/list/tuple containers, no framework dependency) ---

def flatten_tree(tree) -> tuple[list[tuple[str, object]], str]:
    """-> ([(path, leaf), ...], treedef_json).  Containers are dict (keys
    sorted, must be str without '/'), list, and tuple; anything else is a
    leaf.  Paths are '/'-joined key/index segments ('' for a bare leaf)."""
    leaves: list[tuple[str, object]] = []

    def walk(node, path: str):
        if isinstance(node, dict):
            keys = sorted(node.keys())
            for key in keys:
                if not isinstance(key, str) or "/" in key:
                    raise make_error(
                        StatusCode.INVALID_ARG,
                        f"checkpoint tree keys must be '/'-free strings, "
                        f"got {key!r}")
            return {"t": "dict", "k": keys,
                    "c": [walk(node[key], f"{path}/{key}" if path else key)
                          for key in keys]}
        if isinstance(node, (list, tuple)):
            kind = "tuple" if isinstance(node, tuple) else "list"
            return {"t": kind,
                    "c": [walk(x, f"{path}/{i}" if path else str(i))
                          for i, x in enumerate(node)]}
        if node is None:
            return {"t": "none"}
        leaves.append((path, node))
        return {"t": "leaf", "i": len(leaves) - 1}

    spec = walk(tree, "")
    return leaves, json.dumps(spec, separators=(",", ":"))


def unflatten_tree(treedef: str, leaves: dict[int, object]):
    """Rebuild the container structure from the treedef skeleton; leaf
    index -> value from `leaves` (missing indices — partial restore —
    become None)."""
    def build(spec):
        t = spec["t"]
        if t == "dict":
            return {key: build(c) for key, c in zip(spec["k"], spec["c"])}
        if t == "list":
            return [build(c) for c in spec["c"]]
        if t == "tuple":
            return tuple(build(c) for c in spec["c"])
        if t == "none":
            return None
        return leaves.get(spec["i"])
    return build(json.loads(treedef))

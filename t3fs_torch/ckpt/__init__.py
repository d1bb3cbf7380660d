"""Parallel checkpoint engine: striped, EC-protected pytree save/restore.

One of the paper's four headline workloads (high-throughput parallel
checkpointing): a pytree's leaves are partitioned into RS(k+m) stripes and
fanned out through ECStorageClient with per-chain admission, the fused
device encode+CRC step supplying the chunk checksums; a serde
CheckpointManifest committed last via write-temp + meta rename is the
atomic commit point, making saves resumable and restores verifiable
(healthy, partial, resharded, or degraded through RS reconstruction).

The port of t3fs/ckpt: the stripe encode and every chunk CRC run on the
port's CUDA kernels (TorchECCodec's fused encode+CRC step).
"""

from t3fs_torch.ckpt.manifest import (CheckpointManifest, CkptLeaf, ckpt_inode,
                                flatten_tree, manifest_name, parse_step,
                                unflatten_tree)
from t3fs_torch.ckpt.reader import CheckpointReader, ScrubReport
from t3fs_torch.ckpt.store import CheckpointStore, GCReport
from t3fs_torch.ckpt.writer import CheckpointWriter, SaveStats

__all__ = [
    "CheckpointManifest", "CkptLeaf", "CheckpointReader", "CheckpointStore",
    "CheckpointWriter", "GCReport", "SaveStats", "ScrubReport", "ckpt_inode",
    "flatten_tree", "manifest_name", "parse_step", "unflatten_tree",
]

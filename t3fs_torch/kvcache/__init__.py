"""KVCache serving tier: sessions, TTL/capacity eviction, write-behind
batching, ledger compaction, and a cross-process admission plane —
layered on the raw block store (t3fs_torch/lib/kvcache.py).

See docs/kvcache.md for the design;
t3fs_torch/benchmarks/kvcache_fleet_bench.py drives it at inference-fleet
scale (the reference's kvcache_scale_bench needs the ring data plane,
which the port does not have yet).

The port of t3fs/kvcache, a copy with its imports re-pointed.
"""

from t3fs_torch.kvcache.admission import (
    AdmissionConfig, AdmissionController, AdmissionPlane, resolve_plane,
)
from t3fs_torch.kvcache.compact import CompactionConfig, LedgerCompactor
from t3fs_torch.kvcache.gc import EvictionConfig, EvictionWorker
from t3fs_torch.kvcache.ledger import (
    DEFAULT_LANES, OP_DEL, OP_HIT, OP_PUT, LedgerCheckpoint, LedgerReader,
    LedgerRecord, LedgerTable, LedgerWriter, checkpoint_chunk, ledger_inode,
    read_checkpoint, segment_chunk, write_checkpoint,
)
from t3fs_torch.kvcache.tier import (
    KVCacheTier, KVCacheTierConfig, render_kvcache_stats,
)
from t3fs_torch.kvcache.writebehind import WriteBehind, WriteBehindConfig

__all__ = [
    "AdmissionConfig", "AdmissionController", "AdmissionPlane",
    "CompactionConfig", "DEFAULT_LANES", "EvictionConfig",
    "EvictionWorker", "KVCacheTier", "KVCacheTierConfig",
    "LedgerCheckpoint", "LedgerCompactor", "LedgerReader", "LedgerRecord",
    "LedgerTable", "LedgerWriter", "OP_DEL", "OP_HIT", "OP_PUT",
    "WriteBehind", "WriteBehindConfig", "checkpoint_chunk", "ledger_inode",
    "read_checkpoint", "render_kvcache_stats", "resolve_plane",
    "segment_chunk", "write_checkpoint",
]

"""t3fs_torch.usrbio: the ring-native zero-copy data plane.

The app-side shm rings live in t3fs_torch/lib/usrbio.py; this package is
the CLIENT side of the storage fabric: `RingClient` registers an arena with
each storage node at attach time (shm aliasing on the same host,
one-sided Buf ops across hosts) and moves whole submission batches as
packed SQE arrays through `Storage.ring_rw` — one envelope, one serde
pass, N IOs, completions carrying the nodes' CRCs.  `SlotAllocator` is the
slot discipline of its staging arena, and `ShmTokenArena` the
cross-process token arena that the KVCache tier's host-scope admission
draws from.

The port of t3fs/usrbio.
"""

from t3fs_torch.usrbio.ring_client import RingArena, RingClient, RingUnsupported
from t3fs_torch.usrbio.slots import ShmTokenArena, SlotAllocator

__all__ = ["RingArena", "RingClient", "RingUnsupported", "ShmTokenArena",
           "SlotAllocator"]

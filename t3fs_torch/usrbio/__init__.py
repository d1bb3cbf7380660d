"""t3fs_torch.usrbio: the slot discipline of the ring data plane.

The port of t3fs/usrbio's `slots.py` alone: `SlotAllocator` and the
cross-process `ShmTokenArena` that the KVCache tier's host-scope admission
draws its tokens from.  The ring client (t3fs/usrbio/ring_client.py) and
the ring data plane it drives are not ported yet.
"""

from t3fs_torch.usrbio.slots import ShmTokenArena, SlotAllocator

__all__ = ["ShmTokenArena", "SlotAllocator"]

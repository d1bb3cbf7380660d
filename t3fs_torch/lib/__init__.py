"""App-side user libraries (reference: src/lib/ — generic helpers).

The port of t3fs/lib: the KVCache block store (`kvcache.py`).  The USRBIO
shared-memory rings of t3fs/lib/usrbio.py belong to the ring data plane,
which the port does not have yet.
"""

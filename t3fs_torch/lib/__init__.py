"""App-side user libraries (reference: src/lib/ — generic helpers).

The port of t3fs/lib: the KVCache block store (`kvcache.py`) and the
USRBIO shared-memory rings and iovs (`usrbio.py`).
"""

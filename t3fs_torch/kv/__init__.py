"""Transactional KV abstraction + in-memory engine (reference:
src/common/kv/ IKVEngine/ITransaction, src/common/kv/mem/ MemKV — SURVEY.md §2.1)."""

from t3fs_torch.kv.engine import KVEngine, MemKVEngine, Transaction, with_transaction
from t3fs_torch.kv.prefixes import KeyPrefix

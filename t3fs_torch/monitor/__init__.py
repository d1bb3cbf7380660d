"""Cluster health: the scorecard types mgmtd caches (the monitor service
itself is not ported)."""

"""Cluster health and metrics: the monitor collector service (service.py),
its rollups and ClickHouse sink, the per-process reporter, and the
scorecard types mgmtd caches (health.py)."""

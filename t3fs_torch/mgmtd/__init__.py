"""Cluster manager types: routing info, chains and nodes."""

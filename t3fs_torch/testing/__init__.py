"""Test fabrics: an in-process storage cluster."""

"""Shared utilities (the metrics registry)."""

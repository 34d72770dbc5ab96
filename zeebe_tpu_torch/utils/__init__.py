"""Shared utilities."""

from zeebe_tpu_torch.utils.time_util import InvalidTimerError, parse_cycle, parse_duration_millis

__all__ = ["InvalidTimerError", "parse_cycle", "parse_duration_millis",
           "evict_oldest_half"]


def evict_oldest_half(cache: dict, limit: int) -> None:
    """Drop the oldest-inserted half of ``cache`` when it reached ``limit``
    (dicts iterate in insertion order) — the shared cheap-LRU idiom of the
    hot-path caches (key codec, record-frame cache, decoded-batch cache):
    one sweep every limit/2 insertions beats per-hit LRU bookkeeping."""
    if len(cache) >= limit:
        for key in list(cache)[: limit // 2]:
            cache.pop(key, None)

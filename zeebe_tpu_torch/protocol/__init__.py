"""Protocol definitions the device path needs (element and event types)."""

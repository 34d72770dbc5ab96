"""Mean milliseconds per kernel group that the stream processor waited on
the device loop (the pipeline's device stage, ``device_elapsed``) in the
window."""


def read(w):
    count, total = w.histogram("zeebe_stream_processor_pipeline_device")
    return 1e3 * total / count if count else None

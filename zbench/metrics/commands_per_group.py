"""Mean commands per processed batch in the window, from the stream
processor's batch-commands histogram (kernel groups and sequential
batches alike)."""


def read(w):
    count, total = w.histogram("zeebe_stream_processor_batch_processing_commands")
    return total / count if count else None

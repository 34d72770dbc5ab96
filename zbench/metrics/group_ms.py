"""Mean milliseconds per kernel group in the window: the sum of the stream
processor's pipeline stage histograms over the groups they observed."""

STAGES = ("decode", "device", "materialize", "append", "flush", "side_effects")


def read(w):
    groups, _ = w.histogram("zeebe_stream_processor_pipeline_decode")
    if not groups:
        return None
    total = sum(w.histogram(f"zeebe_stream_processor_pipeline_{s}")[1] for s in STAGES)
    return 1e3 * total / groups

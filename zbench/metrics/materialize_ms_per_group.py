"""Mean milliseconds per kernel group of the kernel backend's
materialization (the pipeline's materialize stage, ``t_materialize``) in
the window."""


def read(w):
    count, total = w.histogram("zeebe_stream_processor_pipeline_materialize")
    return 1e3 * total / count if count else None

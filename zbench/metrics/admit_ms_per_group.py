"""Mean milliseconds per kernel group of the kernel backend's admission
(the pipeline's decode stage, ``t_admit``) in the window."""


def read(w):
    count, total = w.histogram("zeebe_stream_processor_pipeline_decode")
    return 1e3 * total / count if count else None

"""Share of the window's job activations that returned no job (each one a
command written to the log for nothing), counted by the closed loop."""


def read(w):
    if not w.activations:
        return None
    return 100.0 * sum(1 for jobs in w.activations if jobs == 0) / len(w.activations)

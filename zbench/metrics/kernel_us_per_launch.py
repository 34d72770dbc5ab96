"""Device microseconds per launch of the port's automaton kernels in the
traced window: the trace's time in kernels of ``csrc/automaton.cu`` (named
``k_*``, in an anonymous namespace; the decision kernels left out) over the
grid launches the automaton's wrappers counted."""


def _kernel(name: str) -> str:
    """``(anonymous namespace)::k_chunk(ZtTables, ...)`` -> ``k_chunk``."""
    if name.endswith(")"):
        name = name[:name.rfind("(")]
    return name.rsplit("::", 1)[-1]


def read(w):
    if w.trace is None:
        return None
    launches = sum(w.grid_launches.values())
    seconds = sum(s for name, (s, _) in w.trace["ops"].items()
                  if _kernel(name).startswith("k_") and not _kernel(name).startswith("k_decision"))
    if not launches or not seconds:
        return None
    return 1e6 * seconds / launches

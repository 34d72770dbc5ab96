"""The 3x3 cell's completed instances per second: the instances that ended
in the window over its seconds. Users see it, but its spread from run to
run (the journal's flushes on the host set each instance's pace) is wider
than a bound may be, so here it is a per-layer metric."""


def read(w):
    return w.e2e["instances_per_s"] if w.e2e.get("instances") else None

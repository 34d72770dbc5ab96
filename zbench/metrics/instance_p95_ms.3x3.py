"""The 3x3 cell's 95th percentile of instance time (ms): over the
instances that ended in the window, from the create's send to the reply
that ended the instance. Zeebe's dashboards show it; its spread from run
to run is wider than a bound may be, so here it is a per-layer metric."""


def read(w):
    return w.e2e["instance_p95_ms"] if w.e2e.get("instances") else None

"""The 1x1 cell's 95th percentile of create latency (ms): over the creates
sent in the window, from send to reply. Zeebe's dashboards show it; its
spread from run to run is wider than a bound may be, so here it is a
per-layer metric."""


def read(w):
    return w.e2e["create_p95_ms"] if w.e2e.get("creates") else None

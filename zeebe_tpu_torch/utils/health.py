"""Component health aggregation.

Reference: scheduler/src/main/java/io/camunda/zeebe/scheduler/health/
CriticalComponentsHealthMonitor.java:26 — named components report
HEALTHY/UNHEALTHY/DEAD; the monitor aggregates to the worst status; partition
health feeds broker health (BrokerHealthCheckService) and the startup/ready/
liveness probes on the management server.
"""

from __future__ import annotations

import enum
from typing import Callable

from zeebe_tpu_torch.utils.zlogging import Loggers


class HealthStatus(enum.IntEnum):
    # ordered by severity so aggregation is max()
    HEALTHY = 0
    # a component is limping but self-healing (e.g. an exporter in retry
    # backoff): the node keeps serving, probes stay green, operators see it
    DEGRADED = 1
    UNHEALTHY = 2
    DEAD = 3


class HealthReport:
    def __init__(self, component: str, status: HealthStatus,
                 message: str = "") -> None:
        self.component = component
        self.status = status
        self.message = message

    def to_dict(self) -> dict:
        return {"component": self.component, "status": self.status.name,
                "message": self.message}


class CriticalComponentsHealthMonitor:
    """Aggregates component healths; listeners fire on any status change."""

    def __init__(self, name: str = "broker") -> None:
        self.name = name
        self._components: dict[str, HealthReport] = {}
        self._listeners: list[Callable[[HealthReport], None]] = []

    def register(self, component: str) -> None:
        self._components.setdefault(
            component, HealthReport(component, HealthStatus.HEALTHY)
        )

    def add_listener(self, listener: Callable[[HealthReport], None]) -> None:
        self._listeners.append(listener)

    def deregister(self, component: str) -> None:
        """Forget a component (e.g. a partition replica moved off this node);
        its last report must not pin the aggregate health forever."""
        self._components.pop(component, None)

    def deregister_matching(self, prefix: str) -> None:
        """Forget every component under a prefix (a stopped partition takes
        its exporter sub-components with it)."""
        for component in [c for c in self._components if c.startswith(prefix)]:
            self._components.pop(component, None)

    def report(self, component: str, status: HealthStatus, message: str = "") -> None:
        # the component map is updated BEFORE listeners fire: a listener that
        # throws (or reads back status()) must observe the new report, never
        # a half-applied monitor
        previous = self._components.get(component)
        report = HealthReport(component, status, message)
        self._components[component] = report
        if previous is None or previous.status != status:
            for listener in self._listeners:
                try:
                    listener(report)
                except Exception:  # noqa: BLE001 — one bad listener must not
                    # starve the rest (probes, metrics) of the status change
                    Loggers.SYSTEM.exception(
                        "health listener failed for %s -> %s",
                        component, status.name)

    def status(self) -> HealthStatus:
        if not self._components:
            return HealthStatus.HEALTHY
        return max(r.status for r in self._components.values())

    def is_healthy(self) -> bool:
        # DEGRADED keeps serving: probes must not evict a node whose only
        # problem is a backing-off exporter
        return self.status() <= HealthStatus.DEGRADED

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "status": self.status().name,
            "components": [r.to_dict() for r in self._components.values()],
        }

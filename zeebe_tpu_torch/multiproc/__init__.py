"""Multi-process mesh scale-out: per-core broker worker processes behind one
gateway; ROADMAP item 1).

The in-process ``ClusterRuntime`` runs every partition's stream processor in
ONE interpreter — the GIL is effectively the cluster scheduler, and
``mesh_serving`` p8 measured *below* p1 because eight partitions' Python
serialized on one core. This package makes partition throughput additive by
moving brokers into per-core **worker processes**:

- :mod:`zeebe_tpu_torch.multiproc.worker` — the worker process: one
  :class:`~zeebe_tpu_torch.broker.Broker` (hosting one or more partitions, its own
  data dir, metrics registry, and optional management port) over TCP cluster
  messaging, plus the gateway-facing protocol (client commands in, responses
  / status / jobs-available out).
- :mod:`zeebe_tpu_torch.multiproc.supervisor` — spawns, monitors, and restarts the
  workers (SIGTERM then SIGKILL on stop; crashed workers restart with
  backoff and recover through the snapshot+replay path).
- :mod:`zeebe_tpu_torch.multiproc.runtime` — the gateway-side
  :class:`MultiProcClusterRuntime`: the same surface the gRPC gateway and
  the management server already consume (``submit``, ``topology``,
  ``cluster_status``, jobs-available), so topology, command routing, and
  ``/cluster/status`` aggregation are unchanged from the client's point of
  view.

Trace discipline, Dapper): the trace id stays derivable everywhere —
``partition:command position`` — and the gateway request id rides the
command envelope across the process boundary, so ``cli trace`` reconstructs
lineage spanning processes from the worker's journal alone.
"""

from zeebe_tpu_torch.multiproc.runtime import MultiProcClusterRuntime
from zeebe_tpu_torch.multiproc.supervisor import WorkerSpec, WorkerSupervisor
from zeebe_tpu_torch.multiproc.worker import WorkerRuntime

__all__ = [
    "MultiProcClusterRuntime",
    "WorkerRuntime",
    "WorkerSpec",
    "WorkerSupervisor",
]

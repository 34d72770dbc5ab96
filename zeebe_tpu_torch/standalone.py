"""Standalone broker+gateway app (reference: dist/…/StandaloneBroker.java with
embedded gateway): boots a cluster runtime and serves the gRPC client API.

Three deployment shapes:

- in-process (default): N brokers in ONE process over the loopback network —
  the single-machine / dev shape.
  ``python -m zeebe_tpu_torch.standalone --brokers 3 --partitions 3``

- multi-process over TCP: ONE broker per process; Raft, membership gossip,
  inter-partition commands, and gateway request routing all ride TCP
  (reference: a real deployed cluster of StandaloneBroker instances).
  ``python -m zeebe_tpu_torch.standalone --node-id broker-0 \
       --bind 127.0.0.1:26601 \
       --contact broker-0=127.0.0.1:26601,broker-1=127.0.0.1:26602,... \
       --partitions 3 --replication 3 --port 26500 --data-dir /data/b0``

- supervised per-core workers (the scale-out shape): this process runs
  ONLY the gateway; a supervisor spawns one broker worker process per core
  (``zeebe_tpu_torch/multiproc/``), partitions distribute round-robin over
  them, and crash-restarted workers recover via snapshots+replay.
  ``python -m zeebe_tpu_torch.standalone --workers 8 --partitions 8 \
       --port 26500 --data-dir /data --management-port 9600``

Every shape takes ``--device``, the kernel backend's device, and passes it
on to the brokers (the workers' spawn lines included): none is the card,
``--device cpu`` the plain version. Without ``--device cpu`` the process
first runs the start-up guard (``utils/backend_probe.boot_card``): where no
card answers it exits 2 with the probe's verdict on stderr; the reference
pins the CPU there. The two helpers of the copied run are the reference's;
``_run_workers_mode`` is the reference's plus the workers' device, and
``main`` the reference's plus ``--device`` and the guard, less the JAX
compile cache (the kernel library is built once per source digest).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


# copied from the reference: _gateway_oauth .. _free_ports
def _gateway_oauth():
    """ZEEBE_GATEWAY_SECURITY_AUTHENTICATION_* → OAuthValidator (mode
    `identity` enables the JWT interceptor; reference: gateway security
    authentication config + IdentityInterceptor)."""
    import os

    mode = os.environ.get("ZEEBE_GATEWAY_SECURITY_AUTHENTICATION_MODE", "none")
    if mode != "identity":
        return None
    from zeebe_tpu_torch.gateway.oauth import OAuthValidator, OAuthValidatorConfig

    secret = os.environ.get("ZEEBE_GATEWAY_SECURITY_AUTHENTICATION_SECRET")
    if not secret:
        raise SystemExit(
            "ZEEBE_GATEWAY_SECURITY_AUTHENTICATION_MODE=identity requires "
            "ZEEBE_GATEWAY_SECURITY_AUTHENTICATION_SECRET")
    return OAuthValidator(OAuthValidatorConfig(
        mode="identity",
        secret=secret,
        audience=os.environ.get("ZEEBE_GATEWAY_SECURITY_AUTHENTICATION_AUDIENCE"),
    ))



def _parse_contacts(spec: str) -> dict[str, tuple[str, int]]:
    out: dict[str, tuple[str, int]] = {}
    for part in spec.split(","):
        name, addr = part.split("=", 1)
        host, port = addr.rsplit(":", 1)
        out[name.strip()] = (host.strip(), int(port))
    return out


def _free_ports(n: int) -> list[int]:
    """n distinct OS-assigned loopback ports (bound briefly, then released).

    Bind-then-release is racy by construction: another process can claim a
    port in the gap, which surfaces as the worker crash-looping on bind (see
    its worker.log) and boot failing at await_leaders. Acceptable for the
    single-operator single-host shape this mode targets; fixed ports via a
    real config are the answer when two clusters share a host."""
    import socket

    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports
# end of the copy


def _run_workers_mode(args) -> int:
    """``--workers N``: this process hosts ONLY the gateway (+ management);
    N broker worker processes are spawned and supervised, one per core
    (zeebe_tpu/multiproc/). Partitions distribute round-robin over the
    workers via the standard distribution; the client-visible surface
    (gRPC API, topology, /cluster/status) is unchanged."""
    from pathlib import Path

    from zeebe_tpu_torch.gateway import Gateway
    from zeebe_tpu_torch.multiproc import (
        MultiProcClusterRuntime,
        WorkerSpec,
        WorkerSupervisor,
    )
    from zeebe_tpu_torch.multiproc.supervisor import worker_cmd
    from zeebe_tpu_torch.utils.external_code import gateway_interceptors_from_env

    gateway_member = "gateway-0"
    worker_names = [f"worker-{i}" for i in range(args.workers)]
    ports = _free_ports(args.workers + 1)
    contacts = {m: ("127.0.0.1", p) for m, p in zip(worker_names, ports)}
    contacts[gateway_member] = ("127.0.0.1", ports[-1])
    contact_str = ",".join(
        f"{m}={h}:{p}" for m, (h, p) in sorted(contacts.items()))
    specs = []
    for name in worker_names:
        data_dir = (str(Path(args.data_dir) / name)
                    if args.data_dir else None)
        specs.append(WorkerSpec(
            node_id=name,
            cmd=worker_cmd(
                name, f"127.0.0.1:{contacts[name][1]}", contact_str,
                gateway_member, args.partitions, args.replication,
                data_dir=data_dir, device=args.device),
            data_dir=data_dir,
        ))
    supervisor = WorkerSupervisor(specs)
    runtime = MultiProcClusterRuntime(
        gateway_member,
        {m: a for m, a in contacts.items() if m != gateway_member},
        partition_count=args.partitions,
        replication_factor=args.replication,
        bind=contacts[gateway_member],
        supervisor=supervisor,
    )
    # signal handlers BEFORE anything spawns: a SIGTERM during the (long —
    # probe deadline + CUDA start-up and the kernel library load) boot window
    # must run the teardown below, not the default action that would orphan
    # the detached workers
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    gateway = None
    management = None
    try:
        # runtime.start() spawns the workers (via the supervisor) — it must
        # sit INSIDE the teardown scope: a thread-start failure after the
        # spawn would otherwise orphan the detached worker processes
        runtime.start()
        # worker boot pays the killable device probe BEFORE binding
        # messaging (up to ZEEBE_PROBE_TIMEOUT_S on a wedged card), then
        # CUDA start-up, the kernel library load, the link measurement and
        # broker recovery: budget for all of it, in short slices so a stop
        # signal interrupts the wait
        import time as _time

        from zeebe_tpu_torch.utils.backend_probe import probe_timeout_secs

        boot_deadline = _time.monotonic() + probe_timeout_secs() + 120.0
        while not stop.is_set():
            try:
                runtime.await_leaders(timeout_s=2.0)
                break
            except RuntimeError:
                if _time.monotonic() >= boot_deadline:
                    raise
        if stop.is_set():
            raise SystemExit(143)  # stopped during boot: teardown below
        gateway = Gateway(runtime, bind=f"0.0.0.0:{args.port}",
                          oauth=_gateway_oauth(),
                          extra_interceptors=gateway_interceptors_from_env())
        gateway.start()
        print(f"gateway listening on {gateway.address} "
              f"({args.workers} worker process(es), {args.partitions} "
              f"partition(s))", file=sys.stderr, flush=True)
        if args.management_port:
            from zeebe_tpu_torch.broker.management import ManagementServer

            management = ManagementServer(
                None, bind=("0.0.0.0", args.management_port), runtime=runtime)
            management.start()
            print(f"management on :{management.port}", file=sys.stderr,
                  flush=True)
    except BaseException:
        # ANY boot failure (leader timeout, gateway/management port in use)
        # must tear the supervisor down: the workers are detached processes
        # (start_new_session) and would otherwise outlive the failed boot
        if management is not None:
            management.stop()
        if gateway is not None:
            gateway.stop()
        runtime.stop()  # stops the supervisor (SIGTERM→SIGKILL) too
        raise
    stop.wait()
    # shutdown must reach runtime.stop() even if a front-end stop raises:
    # the workers are detached processes and only the supervisor (stopped
    # by runtime.stop) can tear them down
    try:
        if management is not None:
            management.stop()
    finally:
        try:
            gateway.stop()
        finally:
            runtime.stop()
    return 0


def main(argv: list[str] | None = None) -> int:
    from zeebe_tpu_torch.utils.zlogging import configure_logging

    # ZEEBE_LOG_APPENDER=stackdriver selects the JSON layout; ZEEBE_LOG_LEVEL
    # binds the zeebe_tpu logger hierarchy (reference: dist log4j2.xml)
    configure_logging()
    parser = argparse.ArgumentParser(prog="zeebe-tpu-broker")
    parser.add_argument("--port", type=int, default=26500)
    parser.add_argument("--partitions", type=int, default=1)
    parser.add_argument("--brokers", type=int, default=1)
    parser.add_argument("--replication", type=int, default=1)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--management-port", type=int, default=0,
                        help="health/metrics/admin HTTP port (0 = disabled)")
    parser.add_argument("--workers", type=int, default=0,
                        help="spawn N supervised broker worker processes "
                             "(one per core) behind this gateway process "
                             "(0 = host brokers in-process)")
    parser.add_argument("--node-id", default=None,
                        help="this broker's member id (enables the "
                             "multi-process TCP cluster mode)")
    parser.add_argument("--bind", default=None,
                        help="host:port for cluster TCP messaging")
    parser.add_argument("--contact", default=None,
                        help="comma-separated member=host:port initial "
                             "contact points (including this node)")
    parser.add_argument("--device", default=None,
                        help="the brokers' kernel backend device (default: "
                             "the card; cpu runs the plain version)")
    args = parser.parse_args(argv)

    # start-up guard: no card (and no --device cpu), no serving; a process
    # that hosts brokers brings the card up before they bind (the workers
    # shape's gateway hosts none: its workers run their own guard)
    from zeebe_tpu_torch.utils.backend_probe import boot_card

    rc = boot_card(args.device, f"[{args.node_id or 'standalone'}]",
                   warm=args.workers <= 0)
    if rc:
        return rc
    from zeebe_tpu_torch.broker.config import load_broker_cfg
    from zeebe_tpu_torch.gateway import ClusterRuntime, Gateway

    if args.workers > 0:
        return _run_workers_mode(args)

    if args.node_id is not None:
        if not args.bind or not args.contact:
            parser.error("--node-id requires --bind and --contact")
        from zeebe_tpu_torch.gateway.tcp_runtime import TcpClusterRuntime

        from zeebe_tpu_torch.backup import backup_store_from_env

        host, port = args.bind.rsplit(":", 1)
        contacts = _parse_contacts(args.contact)
        peers = {m: a for m, a in contacts.items() if m != args.node_id}
        # cluster-messaging TLS (reference: zeebe.broker.network.security.*)
        tls = None
        import os as _os

        if _os.environ.get("ZEEBE_BROKER_NETWORK_SECURITY_ENABLED", "").lower() in (
                "1", "true", "yes"):
            from zeebe_tpu_torch.cluster.messaging import TlsConfig

            cert = _os.environ.get("ZEEBE_BROKER_NETWORK_SECURITY_CERTIFICATECHAINPATH")
            key = _os.environ.get("ZEEBE_BROKER_NETWORK_SECURITY_PRIVATEKEYPATH")
            if not cert or not key:
                raise SystemExit(
                    "ZEEBE_BROKER_NETWORK_SECURITY_ENABLED requires "
                    "ZEEBE_BROKER_NETWORK_SECURITY_CERTIFICATECHAINPATH and "
                    "ZEEBE_BROKER_NETWORK_SECURITY_PRIVATEKEYPATH")
            tls = TlsConfig(
                cert_file=cert, key_file=key,
                ca_file=_os.environ.get(
                    "ZEEBE_BROKER_NETWORK_SECURITY_CERTIFICATEAUTHORITYPATH"),
            )
        from zeebe_tpu_torch.utils.external_code import (
            exporters_factory_from_env,
            gateway_interceptors_from_env,
        )

        runtime = TcpClusterRuntime(
            args.node_id, (host, int(port)), peers, tls=tls,
            partition_count=args.partitions,
            replication_factor=args.replication,
            directory=args.data_dir,
            backup_store=backup_store_from_env(),
            kernel_backend=load_broker_cfg().base.kernel_backend,
            exporters_factory=exporters_factory_from_env(),
            device=args.device,
        )
        runtime.start()
        gateway = Gateway(runtime, bind=f"0.0.0.0:{args.port}",
                      oauth=_gateway_oauth(),
                      extra_interceptors=gateway_interceptors_from_env())
        gateway.start()
        print(f"[{args.node_id}] gateway on {gateway.address}, cluster bind "
              f"{args.bind}", file=sys.stderr, flush=True)
        management = None
        if args.management_port:
            from zeebe_tpu_torch.broker.management import ManagementServer

            management = ManagementServer(
                runtime.broker, bind=("0.0.0.0", args.management_port),
            )
            management.start()
            print(f"management on :{management.port}", file=sys.stderr, flush=True)
        stop = threading.Event()
        signal.signal(signal.SIGINT, lambda *a: stop.set())
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        stop.wait()
        if management is not None:
            management.stop()
        gateway.stop()
        runtime.stop()
        return 0

    # ZEEBE_BROKER_* env vars bind first; explicit CLI flags override
    overrides = {}
    if "--partitions" in (argv or sys.argv):
        overrides["base.partition_count"] = args.partitions
    if "--replication" in (argv or sys.argv):
        overrides["base.replication_factor"] = args.replication
    from zeebe_tpu_torch.backup import backup_store_from_env

    from zeebe_tpu_torch.utils.external_code import (
        exporters_factory_from_env,
        gateway_interceptors_from_env,
    )

    cfg = load_broker_cfg(overrides=overrides)
    runtime = ClusterRuntime(
        backup_store=backup_store_from_env(),
        exporters_factory=exporters_factory_from_env(),
        kernel_backend=cfg.base.kernel_backend,
        broker_count=args.brokers,
        partition_count=(args.partitions if "base.partition_count" in overrides
                         else cfg.base.partition_count),
        replication_factor=(args.replication if "base.replication_factor" in overrides
                            else cfg.base.replication_factor),
        directory=args.data_dir,
        backpressure_algorithm=cfg.backpressure.algorithm,
        backpressure_enabled=cfg.backpressure.enabled,
        disk_min_free_bytes=(cfg.disk.min_free_bytes
                             if cfg.disk.enable_monitoring and args.data_dir else 0),
        device=args.device,
    )
    runtime.start()
    gateway = Gateway(runtime, bind=f"0.0.0.0:{args.port}",
                  oauth=_gateway_oauth(),
                  extra_interceptors=gateway_interceptors_from_env())
    gateway.start()
    print(f"gateway listening on {gateway.address} "
          f"({args.brokers} broker(s), {runtime.partition_count} partition(s))",
          file=sys.stderr)
    management = None
    if args.management_port:
        from zeebe_tpu_torch.broker.management import ManagementServer

        management = ManagementServer(
            next(iter(runtime.brokers.values())),
            bind=("0.0.0.0", args.management_port),
            runtime=runtime,  # /cluster/status fans out over every broker
        )
        management.start()
        print(f"management on :{management.port}", file=sys.stderr)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    stop.wait()
    if management is not None:
        management.stop()
    gateway.stop()
    runtime.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

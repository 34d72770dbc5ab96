# tests/test_tcp_cluster.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Deployable multi-process cluster over TCP (VERDICT round-1 item 7): three
`python -m zeebe_tpu_torch.standalone` processes on localhost form a cluster, serve
clients through any gateway, survive killing the leader, and let it rejoin.

Reference: dist/…/StandaloneBroker.java, qa/integration-tests clustering
(BrokerLeaderChangeTest runs the same scenario in-JVM)."""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml

pytestmark = pytest.mark.slow


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def one_task():
    return (
        Bpmn.create_executable_process("p")
        .start_event("s").service_task("t", job_type="w").end_event("e").done()
    )


class Proc:
    def __init__(self, node_id: str, bind_port: int, gateway_port: int,
                 contact: str, data_dir: str) -> None:
        self.node_id = node_id
        self.bind_port = bind_port
        self.gateway_port = gateway_port
        self.contact = contact
        self.data_dir = data_dir
        self.popen: subprocess.Popen | None = None

    def start(self) -> None:
        # kernel off: this test exercises cluster failover, and three broker
        # subprocesses each paying a JAX compile on the CI box's single core
        # pushes leader re-election past the test's deadlines
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), JAX_PLATFORMS="cpu",
                   ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND="false")
        self.popen = subprocess.Popen(
            [sys.executable, "-m", "zeebe_tpu_torch.standalone",
             "--node-id", self.node_id,
             "--bind", f"127.0.0.1:{self.bind_port}",
             "--contact", self.contact,
             "--partitions", "2", "--replication", "3",
             "--port", str(self.gateway_port),
             "--data-dir", self.data_dir, "--device", "cpu"],
            env=env, stderr=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        )

    def kill(self) -> None:
        if self.popen is not None:
            self.popen.send_signal(signal.SIGKILL)
            self.popen.wait(timeout=10)
            self.popen = None

    def stop(self) -> None:
        if self.popen is not None:
            self.popen.send_signal(signal.SIGTERM)
            try:
                self.popen.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.popen.kill()
            self.popen = None


def _client(port: int):
    from zeebe_tpu_torch.client import ZeebeTpuClient

    return ZeebeTpuClient(f"127.0.0.1:{port}")


def _await_topology(port: int, timeout_s: float = 60.0):
    deadline = time.time() + timeout_s
    last = None
    while time.time() < deadline:
        try:
            client = _client(port)
            topo = client.topology()
            return client, topo
        except Exception as exc:  # noqa: BLE001 — still booting
            last = exc
            time.sleep(0.5)
    pytest.fail(f"gateway :{port} never became reachable: {last}")


def test_three_process_cluster_survives_leader_kill_and_restart(tmp_path):
    ports = _free_ports(6)
    bind_ports, gw_ports = ports[:3], ports[3:]
    names = [f"broker-{i}" for i in range(3)]
    contact = ",".join(
        f"{n}=127.0.0.1:{p}" for n, p in zip(names, bind_ports)
    )
    procs = [
        Proc(n, bp, gp, contact, str(tmp_path / n))
        for n, bp, gp in zip(names, bind_ports, gw_ports)
    ]
    try:
        for p in procs:
            p.start()
        client, _ = _await_topology(gw_ports[0])

        # the cluster serves: deploy + run one instance end to end
        client.deploy_resource(("p.bpmn", to_bpmn_xml(one_task())))
        created = client.create_instance("p")
        assert created.process_instance_key > 0
        deadline = time.time() + 60
        jobs = []
        while time.time() < deadline and not jobs:
            jobs = client.activate_jobs("w", max_jobs=5, timeout_ms=10_000)
        assert jobs, "job never became activatable"
        client.complete_job(jobs[0].key, {"done": True})

        # kill broker-0 (it hosts replicas of every partition at RF=3) —
        # the survivors elect new leaders and keep serving via another gateway
        procs[0].kill()
        client2, _ = _await_topology(gw_ports[1])
        deadline = time.time() + 120
        created2 = None
        while time.time() < deadline and created2 is None:
            try:
                created2 = client2.create_instance("p")
            except Exception:  # noqa: BLE001 — mid-failover
                time.sleep(1)
        assert created2 is not None and created2.process_instance_key > 0

        # restart the killed broker: it rejoins and the cluster still serves
        procs[0].start()
        client3, _ = _await_topology(gw_ports[0])
        deadline = time.time() + 120
        created3 = None
        while time.time() < deadline and created3 is None:
            try:
                created3 = client3.create_instance("p")
            except Exception:  # noqa: BLE001 — rejoining
                time.sleep(1)
        assert created3 is not None and created3.process_instance_key > 0
    finally:
        for p in procs:
            p.stop()


def _make_certs(tmp_path):
    """Self-signed CA + one node cert signed by it (openssl CLI)."""
    ca_key = tmp_path / "ca.key"
    ca_crt = tmp_path / "ca.crt"
    node_key = tmp_path / "node.key"
    node_csr = tmp_path / "node.csr"
    node_crt = tmp_path / "node.crt"
    run = lambda *a: subprocess.run(a, check=True, capture_output=True)  # noqa: E731
    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", str(ca_key), "-out", str(ca_crt),
        "-days", "1", "-subj", "/CN=zeebe-tpu-test-ca")
    run("openssl", "req", "-newkey", "rsa:2048", "-nodes",
        "-keyout", str(node_key), "-out", str(node_csr),
        "-subj", "/CN=zeebe-tpu-node")
    run("openssl", "x509", "-req", "-in", str(node_csr),
        "-CA", str(ca_crt), "-CAkey", str(ca_key), "-CAcreateserial",
        "-out", str(node_crt), "-days", "1")
    return str(node_crt), str(node_key), str(ca_crt)


class TestClusterTls:
    def test_tls_round_trip_and_plaintext_rejection(self, tmp_path):
        """Mutual-TLS messaging between two members round-trips frames;
        a plaintext connection to the TLS port delivers nothing
        (reference: atomix Netty TLS, zeebe.broker.network.security.*)."""
        from zeebe_tpu_torch.cluster.messaging import TcpMessagingService, TlsConfig

        cert, key, ca = _make_certs(tmp_path)
        tls = TlsConfig(cert_file=cert, key_file=key, ca_file=ca)
        pa, pb = _free_ports(2)
        a = TcpMessagingService("a", ("127.0.0.1", pa), {"b": ("127.0.0.1", pb)},
                                tls=tls)
        b = TcpMessagingService("b", ("127.0.0.1", pb), {"a": ("127.0.0.1", pa)},
                                tls=tls)
        received = []
        b.subscribe("ping", lambda sender, payload: received.append((sender, payload)))
        a.start()
        b.start()
        try:
            a.send("b", "ping", {"n": 41})
            deadline = time.time() + 10
            while time.time() < deadline and not received:
                b.poll()
                time.sleep(0.02)
            assert received == [("a", {"n": 41})]

            # plaintext to the TLS port: handshake fails, nothing delivered
            plain = TcpMessagingService(
                "c", ("127.0.0.1", _free_ports(1)[0]), {"b": ("127.0.0.1", pb)})
            plain.start()
            try:
                plain.send("b", "ping", {"n": 99})
                time.sleep(1.0)
                b.poll()
                assert all(p.get("n") != 99 for _s, p in received)
            finally:
                plain.stop()
        finally:
            a.stop()
            b.stop()


def test_compose_shaped_tls_cluster_smoke(tmp_path):
    """The docker/compose.yml deployment shape without docker: 3 standalone
    broker processes with TLS cluster messaging from docker/gen-certs.sh
    certs, then the zbctl-parity `status` view shows all 3 brokers (VERDICT
    r4 item 10 smoke; reference: docker/compose up + zbctl status)."""
    import shutil

    gen = Path(__file__).resolve().parent.parent / "docker" / "gen-certs.sh"
    workdir = tmp_path / "docker"
    workdir.mkdir()
    shutil.copy(gen, workdir / "gen-certs.sh")
    subprocess.run(["sh", str(workdir / "gen-certs.sh")], check=True,
                   capture_output=True)
    certs = workdir / "certs"
    assert (certs / "node.crt").exists()

    ports = _free_ports(6)
    bind_ports, gw_ports = ports[:3], ports[3:]
    names = [f"broker-{i}" for i in range(3)]
    contact = ",".join(
        f"{n}=127.0.0.1:{p}" for n, p in zip(names, bind_ports)
    )
    env_tls = {
        "ZEEBE_BROKER_NETWORK_SECURITY_ENABLED": "true",
        "ZEEBE_BROKER_NETWORK_SECURITY_CERTIFICATECHAINPATH": str(certs / "node.crt"),
        "ZEEBE_BROKER_NETWORK_SECURITY_PRIVATEKEYPATH": str(certs / "node.key"),
        "ZEEBE_BROKER_NETWORK_SECURITY_CERTIFICATEAUTHORITYPATH": str(certs / "ca.crt"),
    }
    procs = []
    try:
        for name, bp, gp in zip(names, bind_ports, gw_ports):
            env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), JAX_PLATFORMS="cpu",
                       ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND="false",
                       **env_tls)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "zeebe_tpu_torch.standalone",
                 "--node-id", name,
                 "--bind", f"127.0.0.1:{bp}",
                 "--contact", contact,
                 "--partitions", "3", "--replication", "3",
                 "--port", str(gp),
                 "--data-dir", str(tmp_path / name), "--device", "cpu"],
                env=env, stderr=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            ))
        client, topo = _await_topology(gw_ports[0], timeout_s=90.0)
        deadline = time.time() + 90
        while time.time() < deadline:
            leaders = {
                pid
                for b in topo.brokers
                for pid, role in b["partitions"].items()
                if role == "LEADER"
            }
            if len(topo.brokers) == 3 and leaders == {1, 2, 3}:
                break
            time.sleep(1.0)
            topo = client.topology()
        # all three compose brokers visible, every partition led
        assert len(topo.brokers) == 3, topo.brokers
        assert {b["nodeId"] for b in topo.brokers} == {0, 1, 2}
        leaders = {
            pid
            for b in topo.brokers
            for pid, role in b["partitions"].items()
            if role == "LEADER"
        }
        assert leaders == {1, 2, 3}, topo.brokers
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()

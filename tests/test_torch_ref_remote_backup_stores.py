# tests/test_remote_backup_stores.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""S3 / GCS remote backup store tests against in-process fake object stores.

Reference: backup-stores/s3 (S3BackupStoreIT against localstack),
backup-stores/gcs (against fake-gcs-server) — same idea, zero containers:
a threaded stdlib HTTP server emulating the minimal API surface each client
uses."""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from zeebe_tpu_torch.backup import (
    Backup,
    GcsBackupStore,
    GcsClient,
    S3BackupStore,
    S3Client,
)
from zeebe_tpu_torch.backup.store import BackupStatusCode
from zeebe_tpu_torch.backup.s3 import sign_v4


class TestSigV4:
    def test_aws_published_vector(self):
        """The get-vanilla-query example from AWS's SigV4 test suite."""
        auth = sign_v4(
            method="GET", host="example.amazonaws.com", path="/",
            query={"Param1": "value1", "Param2": "value2"},
            headers={"x-amz-date": "20150830T123600Z"},
            payload_hash="e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
            region="us-east-1", service="service",
            access_key="AKIDEXAMPLE",
            secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
            amz_date="20150830T123600Z",
        )
        assert auth == (
            "AWS4-HMAC-SHA256 "
            "Credential=AKIDEXAMPLE/20150830/us-east-1/service/aws4_request, "
            "SignedHeaders=host;x-amz-date, "
            "Signature=b97d918cfa904a5beff61c982a1b6f458b799221646efd99d3219ec94cdf2500"
        )


# ---------------------------------------------------------------------------
# fake object stores


class _FakeS3Handler(BaseHTTPRequestHandler):
    """Path-style S3 subset: PUT/GET/DELETE object + ListObjectsV2."""

    store: dict[str, bytes] = {}
    seen_auth: list[str] = []

    def log_message(self, *args):  # quiet
        pass

    def _key(self) -> str:
        path = urllib.parse.urlparse(self.path).path
        return urllib.parse.unquote(path).lstrip("/").split("/", 1)[1]

    def do_PUT(self):
        self.seen_auth.append(self.headers.get("Authorization", ""))
        length = int(self.headers.get("Content-Length", 0))
        self.store[self._key()] = self.rfile.read(length)
        self.send_response(200)
        self.end_headers()

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        query = urllib.parse.parse_qs(parsed.query)
        if "list-type" in query:
            prefix = query.get("prefix", [""])[0]
            keys = sorted(k for k in self.store if k.startswith(prefix))
            body = "<ListBucketResult>" + "".join(
                f"<Contents><Key>{k}</Key></Contents>" for k in keys
            ) + "</ListBucketResult>"
            self.send_response(200)
            self.end_headers()
            self.wfile.write(body.encode())
            return
        data = self.store.get(self._key())
        if data is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.end_headers()
        self.wfile.write(data)

    def do_DELETE(self):
        self.store.pop(self._key(), None)
        self.send_response(204)
        self.end_headers()


class _FakeGcsHandler(BaseHTTPRequestHandler):
    """GCS JSON API subset: media upload/download, delete, list."""

    store: dict[str, bytes] = {}

    def log_message(self, *args):
        pass

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        query = urllib.parse.parse_qs(parsed.query)
        name = query.get("name", [""])[0]
        length = int(self.headers.get("Content-Length", 0))
        self.store[name] = self.rfile.read(length)
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"{}")

    def _object_name(self) -> str:
        parsed = urllib.parse.urlparse(self.path)
        return urllib.parse.unquote(parsed.path.rsplit("/o/", 1)[1])

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        if "/o/" in parsed.path:
            data = self.store.get(self._object_name())
            if data is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.end_headers()
            self.wfile.write(data)
            return
        query = urllib.parse.parse_qs(parsed.query)
        prefix = query.get("prefix", [""])[0]
        items = [{"name": k} for k in sorted(self.store) if k.startswith(prefix)]
        self.send_response(200)
        self.end_headers()
        self.wfile.write(json.dumps({"items": items}).encode())

    def do_DELETE(self):
        self.store.pop(self._object_name(), None)
        self.send_response(204)
        self.end_headers()


@pytest.fixture()
def fake_server(request):
    handler = request.param
    handler.store = {}
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}", handler
    server.shutdown()
    thread.join(timeout=2)


def _sample_backup() -> Backup:
    return Backup(
        checkpoint_id=7, partition_id=1, node_id="broker-0",
        checkpoint_position=123,
        descriptor={"snapshotId": "5-2-100-100"},
        snapshot_files={"state.bin": b"\x01\x02state", "meta.bin": b"meta"},
        segment_files={"segment-001.log": b"\x00seg"},
    )


def _store_for(endpoint: str, handler) -> object:
    if handler is _FakeS3Handler:
        return S3BackupStore(S3Client(endpoint, "bucket", "key", "secret"))
    return GcsBackupStore(GcsClient("bucket", access_token="tok",
                                    endpoint=endpoint))


@pytest.mark.parametrize("fake_server", [_FakeS3Handler, _FakeGcsHandler],
                         indirect=True, ids=["s3", "gcs"])
class TestRemoteBackupStores:
    def test_save_status_read_roundtrip(self, fake_server):
        endpoint, handler = fake_server
        store = _store_for(endpoint, handler)
        backup = _sample_backup()
        assert store.get_status(7, 1).status == BackupStatusCode.DOES_NOT_EXIST
        status = store.save(backup)
        assert status.status == BackupStatusCode.COMPLETED
        restored = store.read(7, 1)
        assert restored.snapshot_files == backup.snapshot_files
        assert restored.segment_files == backup.segment_files
        assert restored.checkpoint_position == 123

    def test_list_and_delete(self, fake_server):
        endpoint, handler = fake_server
        store = _store_for(endpoint, handler)
        store.save(_sample_backup())
        listed = store.list_backups()
        assert [(s.partition_id, s.checkpoint_id) for s in listed] == [(1, 7)]
        store.delete(7, 1)
        assert store.list_backups() == []
        assert store.get_status(7, 1).status == BackupStatusCode.DOES_NOT_EXIST

    def test_partial_upload_reads_in_progress(self, fake_server):
        endpoint, handler = fake_server
        store = _store_for(endpoint, handler)
        # only content, no manifest yet (crash mid-save)
        store.client.put_object("backups/1/9/snapshot/state.bin", b"x")
        assert store.get_status(9, 1).status == BackupStatusCode.IN_PROGRESS


class TestS3Signing:
    @pytest.mark.parametrize("fake_server", [_FakeS3Handler],
                             indirect=True, ids=["s3"])
    def test_requests_carry_sigv4_authorization(self, fake_server):
        endpoint, handler = fake_server
        handler.seen_auth = []
        store = _store_for(endpoint, handler)
        store.save(_sample_backup())
        assert handler.seen_auth
        for auth in handler.seen_auth:
            assert auth.startswith("AWS4-HMAC-SHA256 Credential=key/")
            assert "Signature=" in auth


class TestBrokerWithRemoteStore:
    @pytest.mark.parametrize("fake_server", [_FakeS3Handler],
                             indirect=True, ids=["s3"])
    def test_checkpoint_backs_up_to_s3(self, fake_server):
        from zeebe_tpu_torch.broker.broker import Broker, BrokerCfg
        from zeebe_tpu_torch.cluster.messaging import LoopbackNetwork

        endpoint, handler = fake_server
        store = _store_for(endpoint, handler)
        import time

        net = LoopbackNetwork()
        broker = Broker(BrokerCfg(device="cpu"), net.join("broker-0"), backup_store=store)
        try:
            deadline = time.time() + 30
            while not broker.partitions[1].is_leader:
                broker.pump()
                net.deliver_all()
                time.sleep(0.005)
                assert time.time() < deadline, "no leader elected"
            assert broker.trigger_checkpoint(5) == 1
            for _ in range(50):
                broker.pump()
                net.deliver_all()
            statuses = store.list_backups()
            assert [(s.partition_id, s.checkpoint_id) for s in statuses] == [(1, 5)]
            assert statuses[0].status == BackupStatusCode.COMPLETED
        finally:
            broker.close()

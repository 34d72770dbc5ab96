"""S3 backup store: the BackupStore interface over the S3 REST API.

Reference: backup-stores/s3/src/main/java/io/camunda/zeebe/backup/s3/
S3BackupStore.java — objects under ``<basePath>/<partitionId>/<checkpointId>/``
(manifest + named contents), manifest written last so its presence is the
COMPLETED marker. The reference uses the AWS SDK; this build has zero
third-party dependencies, so the client below speaks the REST API directly
over stdlib ``http.client`` with AWS Signature Version 4 request signing
(path-style addressing — works against AWS, MinIO, localstack).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import json
import urllib.parse
import xml.etree.ElementTree as ET

from zeebe_tpu_torch.backup.store import Backup, BackupStatus, BackupStatusCode

_ALGO = "AWS4-HMAC-SHA256"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def sign_v4(method: str, host: str, path: str, query: dict[str, str],
            headers: dict[str, str], payload_hash: str, region: str,
            service: str, access_key: str, secret_key: str,
            amz_date: str) -> str:
    """AWS Signature Version 4: returns the Authorization header value.
    Split out (and pure) so the canonicalization is unit-testable against
    AWS's published test vectors."""
    date_stamp = amz_date[:8]
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
        for k, v in sorted(query.items())
    )
    all_headers = {**{k.lower(): v.strip() for k, v in headers.items()},
                   "host": host}
    signed_headers = ";".join(sorted(all_headers))
    canonical_headers = "".join(
        f"{k}:{all_headers[k]}\n" for k in sorted(all_headers)
    )
    canonical_request = "\n".join([
        method, urllib.parse.quote(path), canonical_query,
        canonical_headers, signed_headers, payload_hash,
    ])
    scope = f"{date_stamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        _ALGO, amz_date, scope,
        hashlib.sha256(canonical_request.encode("utf-8")).hexdigest(),
    ])
    k_date = _hmac(("AWS4" + secret_key).encode("utf-8"), date_stamp)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode("utf-8"),
                         hashlib.sha256).hexdigest()
    return (f"{_ALGO} Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}")


class S3Error(Exception):
    def __init__(self, status: int, body: str) -> None:
        super().__init__(f"S3 request failed: HTTP {status}: {body[:500]}")
        self.status = status


class PersistentHttpClient:
    """Shared blob-client transport: endpoint parsing, one persistent
    connection (a backup save uploads many objects to the same endpoint and
    must not pay a handshake per file), reconnect-once on a stale
    keep-alive."""

    def __init__(self, endpoint: str, timeout_s: float = 30.0) -> None:
        parsed = urllib.parse.urlparse(endpoint)
        if parsed.scheme not in ("http", "https"):
            raise ValueError(f"endpoint must be http(s)://…, got {endpoint!r}")
        self._secure = parsed.scheme == "https"
        self._host = parsed.netloc
        self.timeout_s = timeout_s
        self._conn: http.client.HTTPConnection | None = None

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            conn_cls = (http.client.HTTPSConnection if self._secure
                        else http.client.HTTPConnection)
            self._conn = conn_cls(self._host, timeout=self.timeout_s)
        return self._conn

    def _send(self, method: str, target: str, body: bytes,
              headers: dict[str, str]) -> tuple[int, bytes]:
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request(method, target, body=body, headers=headers)
                response = conn.getresponse()
                return response.status, response.read()
            except (http.client.HTTPException, OSError):
                self._conn = None  # stale keep-alive: reconnect once
                if attempt:
                    raise
        raise AssertionError("unreachable")


class S3Client(PersistentHttpClient):
    """Minimal path-style S3 client: put/get/delete/list with SigV4."""

    def __init__(self, endpoint: str, bucket: str, access_key: str,
                 secret_key: str, region: str = "us-east-1",
                 timeout_s: float = 30.0) -> None:
        super().__init__(endpoint, timeout_s)
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def _request(self, method: str, key: str = "",
                 query: dict[str, str] | None = None,
                 body: bytes = b"") -> tuple[int, bytes]:
        query = query or {}
        path = f"/{self.bucket}" + (f"/{key}" if key else "")
        payload_hash = hashlib.sha256(body).hexdigest()
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
        headers = {
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
        }
        headers["Authorization"] = sign_v4(
            method, self._host, path, query, headers, payload_hash,
            self.region, "s3", self.access_key, self.secret_key, amz_date,
        )
        target = urllib.parse.quote(path)
        if query:
            # EXACTLY the canonical encoding sign_v4 used (quote, not
            # urlencode/quote_plus): a space must be %20 on the wire too, or
            # the signature covers a different string than the request
            target += "?" + "&".join(
                f"{urllib.parse.quote(k, safe='')}="
                f"{urllib.parse.quote(v, safe='')}"
                for k, v in sorted(query.items())
            )
        return self._send(method, target, body, headers)

    def put_object(self, key: str, data: bytes) -> None:
        status, body = self._request("PUT", key, body=data)
        if status not in (200, 201):
            raise S3Error(status, body.decode("utf-8", "replace"))

    def get_object(self, key: str) -> bytes | None:
        status, body = self._request("GET", key)
        if status == 404:
            return None
        if status != 200:
            raise S3Error(status, body.decode("utf-8", "replace"))
        return body

    def delete_object(self, key: str) -> None:
        status, body = self._request("DELETE", key)
        if status not in (200, 204, 404):
            raise S3Error(status, body.decode("utf-8", "replace"))

    def list_keys(self, prefix: str) -> list[str]:
        """ListObjectsV2 with continuation (reference: the SDK paginates)."""
        keys: list[str] = []
        token = ""
        while True:
            query = {"list-type": "2", "prefix": prefix}
            if token:
                query["continuation-token"] = token
            status, body = self._request("GET", query=query)
            if status != 200:
                raise S3Error(status, body.decode("utf-8", "replace"))
            root = ET.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for contents in root.findall(f"{ns}Contents"):
                key = contents.find(f"{ns}Key")
                if key is not None and key.text:
                    keys.append(key.text)
            next_token = root.find(f"{ns}NextContinuationToken")
            if next_token is None or not next_token.text:
                return keys
            token = next_token.text


class BlobBackupStore:
    """BackupStore over any blob client exposing put_object/get_object/
    delete_object/list_keys; same manifest-last COMPLETED semantics as the
    filesystem store (and the reference's S3/GCS implementations)."""

    def __init__(self, client, base_path: str = "backups") -> None:
        self.client = client
        self.base_path = base_path.strip("/")

    def _prefix(self, partition_id: int, checkpoint_id: int) -> str:
        return f"{self.base_path}/{partition_id}/{checkpoint_id}"

    def save(self, backup: Backup) -> BackupStatus:
        prefix = self._prefix(backup.partition_id, backup.checkpoint_id)
        for name, data in backup.snapshot_files.items():
            self.client.put_object(f"{prefix}/snapshot/{name}", data)
        for name, data in backup.segment_files.items():
            self.client.put_object(f"{prefix}/segments/{name}", data)
        manifest = {
            "checkpointId": backup.checkpoint_id,
            "partitionId": backup.partition_id,
            "nodeId": backup.node_id,
            "checkpointPosition": backup.checkpoint_position,
            "descriptor": backup.descriptor,
            "snapshotFiles": sorted(backup.snapshot_files),
            "segmentFiles": sorted(backup.segment_files),
        }
        # manifest LAST: its presence is the COMPLETED marker
        self.client.put_object(
            f"{prefix}/manifest.json", json.dumps(manifest).encode("utf-8"))
        return self.get_status(backup.checkpoint_id, backup.partition_id)

    def get_status(self, checkpoint_id: int, partition_id: int) -> BackupStatus:
        prefix = self._prefix(partition_id, checkpoint_id)
        manifest_bytes = self.client.get_object(f"{prefix}/manifest.json")
        if manifest_bytes is None:
            if self.client.list_keys(prefix + "/"):
                return BackupStatus(checkpoint_id, partition_id,
                                    BackupStatusCode.IN_PROGRESS)
            return BackupStatus(checkpoint_id, partition_id,
                                BackupStatusCode.DOES_NOT_EXIST)
        try:
            manifest = json.loads(manifest_bytes)
        except json.JSONDecodeError as exc:
            return BackupStatus(checkpoint_id, partition_id,
                                BackupStatusCode.FAILED,
                                failure_reason=f"corrupt manifest: {exc}")
        return BackupStatus(checkpoint_id, partition_id,
                            BackupStatusCode.COMPLETED, descriptor=manifest)

    def list_backups(self, partition_id: int | None = None) -> list[BackupStatus]:
        prefix = self.base_path + "/"
        if partition_id is not None:
            prefix += f"{partition_id}/"
        out = []
        for key in self.client.list_keys(prefix):
            if not key.endswith("/manifest.json"):
                continue
            parts = key[len(self.base_path) + 1:].split("/")
            out.append(self.get_status(int(parts[1]), int(parts[0])))
        out.sort(key=lambda s: (s.partition_id, s.checkpoint_id))
        return out

    def delete(self, checkpoint_id: int, partition_id: int) -> None:
        prefix = self._prefix(partition_id, checkpoint_id)
        # manifest FIRST: a half-deleted backup must read as not-completed
        self.client.delete_object(f"{prefix}/manifest.json")
        for key in self.client.list_keys(prefix + "/"):
            self.client.delete_object(key)

    def read(self, checkpoint_id: int, partition_id: int) -> Backup:
        prefix = self._prefix(partition_id, checkpoint_id)
        manifest_bytes = self.client.get_object(f"{prefix}/manifest.json")
        if manifest_bytes is None:
            raise FileNotFoundError(
                f"backup {checkpoint_id} for partition {partition_id} does not "
                f"exist (no {prefix}/manifest.json)"
            )
        manifest = json.loads(manifest_bytes)

        def require(key: str) -> bytes:
            data = self.client.get_object(key)
            if data is None:
                # manifest-last save order makes this impossible for an
                # intact store: a listed object vanished after completion
                raise FileNotFoundError(
                    f"backup {checkpoint_id}/{partition_id} is corrupt: "
                    f"object {key} listed in the manifest is missing"
                )
            return data

        return Backup(
            checkpoint_id=manifest["checkpointId"],
            partition_id=manifest["partitionId"],
            node_id=manifest["nodeId"],
            checkpoint_position=manifest["checkpointPosition"],
            descriptor=manifest["descriptor"],
            snapshot_files={
                name: require(f"{prefix}/snapshot/{name}")
                for name in manifest["snapshotFiles"]
            },
            segment_files={
                name: require(f"{prefix}/segments/{name}")
                for name in manifest["segmentFiles"]
            },
        )


class S3BackupStore(BlobBackupStore):
    """BackupStore over an S3Client (reference: backup-stores/s3)."""

    def __init__(self, client: S3Client, base_path: str = "backups") -> None:
        super().__init__(client, base_path)

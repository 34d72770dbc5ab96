"""GCS backup store: the BackupStore interface over the GCS JSON API.

Reference: backup-stores/gcs/src/main/java/io/camunda/zeebe/backup/gcs/
GcsBackupStore.java — same object layout and manifest-last semantics as the
S3 store, addressed through Google Cloud Storage's JSON API
(``/storage/v1/b/<bucket>/o`` + ``/upload/storage/v1`` media uploads) with a
bearer token. The endpoint is configurable so fake-gcs-server-style emulators
work; auth is a static token (no metadata-server round trips in this build).
"""

from __future__ import annotations

import json
import urllib.parse

from zeebe_tpu_torch.backup.s3 import BlobBackupStore, PersistentHttpClient


class GcsError(Exception):
    def __init__(self, status: int, body: str) -> None:
        super().__init__(f"GCS request failed: HTTP {status}: {body[:500]}")
        self.status = status


class GcsClient(PersistentHttpClient):
    """Minimal GCS JSON-API client: upload/download/delete/list."""

    def __init__(self, bucket: str, access_token: str = "",
                 endpoint: str = "https://storage.googleapis.com",
                 timeout_s: float = 30.0) -> None:
        super().__init__(endpoint, timeout_s)
        self.bucket = bucket
        self.access_token = access_token

    def _request(self, method: str, target: str,
                 body: bytes = b"") -> tuple[int, bytes]:
        headers = {}
        if self.access_token:
            headers["Authorization"] = f"Bearer {self.access_token}"
        return self._send(method, target, body, headers)

    def _object_path(self, key: str) -> str:
        return (f"/storage/v1/b/{self.bucket}/o/"
                f"{urllib.parse.quote(key, safe='')}")

    def put_object(self, key: str, data: bytes) -> None:
        target = (f"/upload/storage/v1/b/{self.bucket}/o?uploadType=media"
                  f"&name={urllib.parse.quote(key, safe='')}")
        status, body = self._request("POST", target, body=data)
        if status not in (200, 201):
            raise GcsError(status, body.decode("utf-8", "replace"))

    def get_object(self, key: str) -> bytes | None:
        status, body = self._request("GET", self._object_path(key) + "?alt=media")
        if status == 404:
            return None
        if status != 200:
            raise GcsError(status, body.decode("utf-8", "replace"))
        return body

    def delete_object(self, key: str) -> None:
        status, body = self._request("DELETE", self._object_path(key))
        if status not in (200, 204, 404):
            raise GcsError(status, body.decode("utf-8", "replace"))

    def list_keys(self, prefix: str) -> list[str]:
        keys: list[str] = []
        page_token = ""
        while True:
            target = (f"/storage/v1/b/{self.bucket}/o"
                      f"?prefix={urllib.parse.quote(prefix, safe='')}")
            if page_token:
                target += f"&pageToken={urllib.parse.quote(page_token, safe='')}"
            status, body = self._request("GET", target)
            if status != 200:
                raise GcsError(status, body.decode("utf-8", "replace"))
            listing = json.loads(body)
            keys.extend(item["name"] for item in listing.get("items", []))
            page_token = listing.get("nextPageToken", "")
            if not page_token:
                return keys


class GcsBackupStore(BlobBackupStore):
    """BackupStore over a GcsClient (reference: backup-stores/gcs); all the
    layout/manifest logic lives in BlobBackupStore, which only depends on the
    shared blob-client surface."""

    def __init__(self, client: GcsClient, base_path: str = "backups") -> None:
        super().__init__(client, base_path)

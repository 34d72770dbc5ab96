# tests/test_oauth.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""OAuth / JWT authentication: gateway interceptor + client credentials.

Reference: gateway interceptors/impl/IdentityInterceptor.java (reject
unauthenticated calls with UNAUTHENTICATED before any handler runs) and the
Java client's OAuthCredentialsProvider (client-credentials flow, cached
token, Authorization metadata per call)."""

from __future__ import annotations

import http.server
import json
import threading
import time

import grpc
import pytest

from zeebe_tpu_torch.client import ZeebeTpuClient
from zeebe_tpu_torch.client.credentials import (
    OAuthCredentialsProvider,
    StaticCredentialsProvider,
)
from zeebe_tpu_torch.gateway import ClusterRuntime, Gateway
from zeebe_tpu_torch.gateway.oauth import (
    InvalidToken,
    OAuthValidator,
    OAuthValidatorConfig,
    decode_jwt,
    encode_jwt,
)
from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml

SECRET = "test-secret"


class TestJwt:
    def test_round_trip(self):
        claims = {"sub": "worker", "aud": "zeebe", "exp": time.time() + 60,
                  "authorized_tenants": ["a", "b"]}
        token = encode_jwt(claims, SECRET)
        assert decode_jwt(token, SECRET, audience="zeebe") == claims

    def test_bad_signature(self):
        token = encode_jwt({"sub": "x"}, SECRET)
        with pytest.raises(InvalidToken, match="bad signature"):
            decode_jwt(token, "other-secret")

    def test_expired(self):
        token = encode_jwt({"exp": time.time() - 1}, SECRET)
        with pytest.raises(InvalidToken, match="expired"):
            decode_jwt(token, SECRET)

    def test_audience_mismatch(self):
        token = encode_jwt({"aud": "other"}, SECRET)
        with pytest.raises(InvalidToken, match="audience"):
            decode_jwt(token, SECRET, audience="zeebe")

    def test_tampered_payload(self):
        token = encode_jwt({"sub": "x"}, SECRET)
        h, p, s = token.split(".")
        import base64

        forged = base64.urlsafe_b64encode(
            json.dumps({"sub": "admin"}).encode()).rstrip(b"=").decode()
        with pytest.raises(InvalidToken):
            decode_jwt(f"{h}.{forged}.{s}", SECRET)


@pytest.fixture(scope="module")
def authed_stack():
    runtime = ClusterRuntime(broker_count=1, partition_count=1, device="cpu")
    runtime.start()
    oauth = OAuthValidator(OAuthValidatorConfig(
        mode="identity", secret=SECRET, audience="zeebe"))
    gateway = Gateway(runtime, oauth=oauth)
    gateway.start()
    yield gateway, runtime
    gateway.stop()
    runtime.stop()


def _token(ttl: float = 300.0) -> str:
    return encode_jwt({"sub": "tester", "aud": "zeebe",
                       "exp": time.time() + ttl}, SECRET)


class TestGatewayAuthentication:
    def test_unauthenticated_rejected(self, authed_stack):
        gateway, _ = authed_stack
        client = ZeebeTpuClient(gateway.address)
        try:
            with pytest.raises(grpc.RpcError) as err:
                client.topology()
            assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
        finally:
            client.close()

    def test_bad_token_rejected(self, authed_stack):
        gateway, _ = authed_stack
        client = ZeebeTpuClient(
            gateway.address,
            credentials_provider=StaticCredentialsProvider(
                encode_jwt({"aud": "zeebe"}, "wrong-secret")))
        try:
            with pytest.raises(grpc.RpcError) as err:
                client.topology()
            assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
        finally:
            client.close()

    def test_valid_token_serves_end_to_end(self, authed_stack):
        gateway, _ = authed_stack
        client = ZeebeTpuClient(
            gateway.address,
            credentials_provider=StaticCredentialsProvider(_token()))
        try:
            assert client.topology().cluster_size == 1
            client.deploy_resource(("a.bpmn", to_bpmn_xml(
                Bpmn.create_executable_process("auth_p").start_event("s")
                .service_task("t", job_type="aw").end_event("e").done())))
            client.create_instance("auth_p")
            jobs = []
            deadline = time.time() + 10
            while time.time() < deadline and not jobs:
                jobs = client.activate_jobs("aw", max_jobs=1)
            assert jobs
            client.complete_job(jobs[0].key)
        finally:
            client.close()

    def test_streaming_rpc_rejected_without_token(self, authed_stack):
        gateway, _ = authed_stack
        client = ZeebeTpuClient(gateway.address)
        try:
            with pytest.raises(grpc.RpcError) as err:
                client.activate_jobs("aw", max_jobs=1)
            assert err.value.code() == grpc.StatusCode.UNAUTHENTICATED
        finally:
            client.close()


class _TokenEndpoint(http.server.BaseHTTPRequestHandler):
    requests: list = []

    def do_POST(self):  # noqa: N802 — http.server API
        length = int(self.headers["Content-Length"])
        body = self.rfile.read(length).decode()
        type(self).requests.append(body)
        token = encode_jwt({"sub": "m2m", "aud": "zeebe",
                            "exp": time.time() + 120}, SECRET)
        payload = json.dumps({"access_token": token, "token_type": "Bearer",
                              "expires_in": 120}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *args):  # silence
        pass


class TestOAuthCredentialsProvider:
    def test_client_credentials_flow_and_caching(self):
        server = http.server.HTTPServer(("127.0.0.1", 0), _TokenEndpoint)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_port}/oauth/token"
            provider = OAuthCredentialsProvider(
                url, "my-client", "my-secret", audience="zeebe")
            t1 = provider.token()
            t2 = provider.token()
            assert t1 == t2, "token must be cached until near expiry"
            assert len(_TokenEndpoint.requests) == 1
            assert "grant_type=client_credentials" in _TokenEndpoint.requests[0]
            assert "client_id=my-client" in _TokenEndpoint.requests[0]
            assert decode_jwt(t1, SECRET, audience="zeebe")["sub"] == "m2m"
        finally:
            server.shutdown()

    def test_oauth_end_to_end_against_authed_gateway(self, authed_stack):
        gateway, _ = authed_stack
        server = http.server.HTTPServer(("127.0.0.1", 0), _TokenEndpoint)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            provider = OAuthCredentialsProvider(
                f"http://127.0.0.1:{server.server_port}/token",
                "m2m-client", "s3cret", audience="zeebe")
            client = ZeebeTpuClient(gateway.address,
                                    credentials_provider=provider)
            try:
                assert client.topology().partitions_count == 1
            finally:
                client.close()
        finally:
            server.shutdown()

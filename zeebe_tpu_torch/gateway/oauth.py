"""OAuth / JWT authentication for the gateway edge.

Reference: gateway/src/main/java/io/camunda/zeebe/gateway/interceptors/impl/
IdentityInterceptor.java — a gRPC server interceptor that validates the
request's bearer token before any RPC handler runs, resolving the caller's
claims (authorized tenants) for downstream authorization. The reference
delegates token validation to the external Identity service (JWKS/RS256);
this zero-egress build validates HS256 JWTs against a shared secret — the
same wire surface (`Authorization: Bearer <jwt>`), the same rejection
semantics (UNAUTHENTICATED), a simpler trust root.

The client side (zeebe_tpu_torch.client.credentials) speaks the standard OAuth2
client-credentials flow against any token endpoint, mirroring the Java/Go
clients' OAuthCredentialsProvider (ZEEBE_CLIENT_ID / ZEEBE_CLIENT_SECRET /
ZEEBE_AUTHORIZATION_SERVER_URL / ZEEBE_TOKEN_AUDIENCE).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import json
import time
from typing import Any


class InvalidToken(Exception):
    pass


def bearer_token(invocation_metadata) -> str:
    """The request's bearer token from gRPC metadata ('' when absent).
    Case-insensitive on both the key and the Bearer prefix (RFC 6750)."""
    for key, value in invocation_metadata or ():
        if key.lower() == "authorization":
            if value[:7].lower() == "bearer ":
                return value[7:].strip()
            return value.strip()
    return ""


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _b64url_decode(data: str) -> bytes:
    return base64.urlsafe_b64decode(data + "=" * (-len(data) % 4))


def encode_jwt(claims: dict, secret: str) -> str:
    """HS256 JWT (header.payload.signature, RFC 7519)."""
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims).encode())
    signing_input = f"{header}.{payload}".encode("ascii")
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url(sig)}"


def decode_jwt(token: str, secret: str, audience: str | None = None,
               now: float | None = None) -> dict:
    """Validate signature, expiry, and (optionally) audience; returns the
    claims. Raises InvalidToken on any failure — the caller maps it to
    gRPC UNAUTHENTICATED."""
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
    except ValueError as exc:
        raise InvalidToken("malformed token") from exc
    try:
        header = json.loads(_b64url_decode(header_b64))
        claims = json.loads(_b64url_decode(payload_b64))
        signature = _b64url_decode(sig_b64)
    except (ValueError, json.JSONDecodeError) as exc:
        raise InvalidToken("undecodable token") from exc
    if header.get("alg") != "HS256":
        raise InvalidToken(f"unsupported algorithm {header.get('alg')!r}")
    signing_input = f"{header_b64}.{payload_b64}".encode("ascii")
    expected = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(signature, expected):
        raise InvalidToken("bad signature")
    exp = claims.get("exp")
    if exp is not None and (now if now is not None else time.time()) >= exp:
        raise InvalidToken("token expired")
    if audience is not None:
        aud = claims.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if audience not in auds:
            raise InvalidToken(f"audience mismatch ({aud!r})")
    return claims


@dataclasses.dataclass
class OAuthValidatorConfig:
    """`zeebe.gateway.security.authentication` subset: mode `none` (default)
    accepts everything; mode `identity` requires a valid bearer JWT."""

    mode: str = "none"  # "none" | "identity"
    secret: str = ""  # HS256 shared secret (the zero-egress trust root)
    audience: str | None = None


class OAuthValidator:
    def __init__(self, config: OAuthValidatorConfig | None = None) -> None:
        self.config = config or OAuthValidatorConfig()

    @property
    def enabled(self) -> bool:
        return self.config.mode == "identity"

    def validate(self, invocation_metadata) -> dict:
        """Claims of the request's bearer token; raises InvalidToken when
        authentication is enabled and the token is missing/invalid."""
        if not self.enabled:
            return {}
        token = bearer_token(invocation_metadata)
        if not token:
            raise InvalidToken("missing bearer token")
        return decode_jwt(token, self.config.secret,
                          audience=self.config.audience)


def auth_server_interceptor(validator: OAuthValidator):
    """gRPC server interceptor rejecting unauthenticated calls before any
    handler runs (the IdentityInterceptor seam)."""
    import grpc

    class _Interceptor(grpc.ServerInterceptor):
        def intercept_service(self, continuation, handler_call_details):
            handler = continuation(handler_call_details)
            try:
                validator.validate(handler_call_details.invocation_metadata)
                return handler
            except InvalidToken as exc:
                detail = f"Expected a valid bearer token: {exc}"

            if handler is None:  # unknown method: let gRPC answer
                return None

            def abort_unary(request, context) -> Any:
                context.abort(grpc.StatusCode.UNAUTHENTICATED, detail)

            def abort_stream(request, context):
                context.abort(grpc.StatusCode.UNAUTHENTICATED, detail)
                yield  # pragma: no cover — abort raises

            # match the original handler's cardinality so streaming RPCs
            # (ActivateJobs, StreamActivatedJobs) also reject cleanly
            if handler.response_streaming:
                factory = (grpc.stream_stream_rpc_method_handler
                           if handler.request_streaming
                           else grpc.unary_stream_rpc_method_handler)
                return factory(abort_stream,
                               request_deserializer=handler.request_deserializer,
                               response_serializer=handler.response_serializer)
            factory = (grpc.stream_unary_rpc_method_handler
                       if handler.request_streaming
                       else grpc.unary_unary_rpc_method_handler)
            return factory(abort_unary,
                           request_deserializer=handler.request_deserializer,
                           response_serializer=handler.response_serializer)

    return _Interceptor()

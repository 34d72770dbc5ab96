"""Client credentials: attach OAuth bearer tokens to every gRPC call.

Reference: clients/java/…/impl/oauth/OAuthCredentialsProvider.java (and the
Go client's equivalent) — the standard OAuth2 client-credentials flow against
a token endpoint, with the token cached until shortly before expiry and the
`Authorization: Bearer <token>` metadata attached per call. Environment
binding mirrors the reference client:

  ZEEBE_CLIENT_ID / ZEEBE_CLIENT_SECRET
  ZEEBE_AUTHORIZATION_SERVER_URL
  ZEEBE_TOKEN_AUDIENCE
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import urllib.parse
import urllib.request
from typing import Any

import grpc


class CredentialsProvider:
    """Interface: a bearer token per call (empty string = anonymous)."""

    def token(self) -> str:
        raise NotImplementedError


class StaticCredentialsProvider(CredentialsProvider):
    def __init__(self, token: str) -> None:
        self._token = token

    def token(self) -> str:
        return self._token


class OAuthCredentialsProvider(CredentialsProvider):
    """Client-credentials flow with expiry-aware caching (refreshes when
    less than ``refresh_slack_s`` of lifetime remains)."""

    def __init__(self, authorization_server_url: str, client_id: str,
                 client_secret: str, audience: str | None = None,
                 refresh_slack_s: float = 30.0) -> None:
        self.url = authorization_server_url
        self.client_id = client_id
        self.client_secret = client_secret
        self.audience = audience
        self.refresh_slack_s = refresh_slack_s
        self._lock = threading.Lock()
        self._token = ""
        self._expires_at = 0.0

    @classmethod
    def from_env(cls) -> "OAuthCredentialsProvider | None":
        url = os.environ.get("ZEEBE_AUTHORIZATION_SERVER_URL")
        client_id = os.environ.get("ZEEBE_CLIENT_ID")
        if not url or not client_id:
            return None
        return cls(url, client_id,
                   os.environ.get("ZEEBE_CLIENT_SECRET", ""),
                   audience=os.environ.get("ZEEBE_TOKEN_AUDIENCE"))

    def token(self) -> str:
        with self._lock:
            if self._token and time.time() < self._expires_at - self.refresh_slack_s:
                return self._token
            form = {
                "grant_type": "client_credentials",
                "client_id": self.client_id,
                "client_secret": self.client_secret,
            }
            if self.audience:
                form["audience"] = self.audience
            request = urllib.request.Request(
                self.url,
                data=urllib.parse.urlencode(form).encode("ascii"),
                headers={"Content-Type": "application/x-www-form-urlencoded"},
            )
            with urllib.request.urlopen(request, timeout=10) as response:
                body = json.loads(response.read())
            self._token = body["access_token"]
            self._expires_at = time.time() + float(body.get("expires_in", 300))
            return self._token


class _BearerCallDetails(
    # structured clone of grpc.ClientCallDetails with metadata replaced
    collections.namedtuple(
        "_BearerCallDetails",
        ("method", "timeout", "metadata", "credentials",
         "wait_for_ready", "compression"),
    ),
    grpc.ClientCallDetails,
):
    pass


class _AuthInterceptor(grpc.UnaryUnaryClientInterceptor,
                       grpc.UnaryStreamClientInterceptor):
    def __init__(self, provider: CredentialsProvider) -> None:
        self.provider = provider

    def _with_token(self, details: Any) -> Any:
        token = self.provider.token()
        if not token:
            return details
        metadata = list(details.metadata or ())
        metadata.append(("authorization", f"Bearer {token}"))
        return _BearerCallDetails(
            details.method, details.timeout, metadata, details.credentials,
            getattr(details, "wait_for_ready", None),
            getattr(details, "compression", None),
        )

    def intercept_unary_unary(self, continuation, details, request):
        return continuation(self._with_token(details), request)

    def intercept_unary_stream(self, continuation, details, request):
        return continuation(self._with_token(details), request)


def authenticated_channel(channel: grpc.Channel,
                          provider: CredentialsProvider) -> grpc.Channel:
    """Wrap a channel so every call carries the provider's bearer token."""
    return grpc.intercept_channel(channel, _AuthInterceptor(provider))

"""Gateway authorization: tenant validation at the client edge.

Reference: gateway/src/main/java/io/camunda/zeebe/gateway/interceptors/impl/
IdentityInterceptor.java (resolves the caller's authorized tenants from the
request's bearer token and rejects requests addressing other tenants) and
auth/src/main/java/io/camunda/zeebe/auth/impl/Authorization.java (the
authorized-tenants claim the gateway stamps onto broker requests, checked
engine-side by TenantAuthorizationChecker).

Skeleton scope: identity is a static bearer-token → tenants table (the
reference delegates to an external Identity service; zero-egress here), and
multi-tenancy is off by default — exactly the reference's default, where every
request must address the default tenant."""

from __future__ import annotations

import dataclasses

from zeebe_tpu_torch.protocol import DEFAULT_TENANT


@dataclasses.dataclass
class GatewayAuthConfig:
    """`zeebe.gateway.multiTenancy` + identity subset."""

    # off (default): only the default tenant is addressable, any caller
    multi_tenancy_enabled: bool = False
    # bearer token → authorized tenant ids (IdentityInterceptor's token claims)
    token_tenants: dict[str, list[str]] = dataclasses.field(default_factory=dict)
    # tenants granted to calls with no/unknown token while multi-tenancy is on
    anonymous_tenants: list[str] = dataclasses.field(
        default_factory=lambda: [DEFAULT_TENANT])


class TenantAuthorizer:
    def __init__(self, config: GatewayAuthConfig | None = None,
                 oauth=None) -> None:
        self.config = config or GatewayAuthConfig()
        # optional OAuthValidator: with JWT authentication on, the caller's
        # tenants come from the validated token's authorized_tenants claim
        # (the reference reads the same claim via Identity)
        self.oauth = oauth

    @property
    def enabled(self) -> bool:
        return self.config.multi_tenancy_enabled

    def authorized_tenants(self, invocation_metadata) -> list[str]:
        """The caller's authorized tenants, resolved from gRPC metadata."""
        if not self.config.multi_tenancy_enabled:
            return [DEFAULT_TENANT]
        if self.oauth is not None and self.oauth.enabled:
            from zeebe_tpu_torch.gateway.oauth import InvalidToken

            try:
                claims = self.oauth.validate(invocation_metadata)
            except InvalidToken:
                # the server interceptor rejects unauthenticated calls before
                # handlers run; reaching here means a race on config — deny
                return []
            tenants = claims.get("authorized_tenants")
            if tenants:
                return list(tenants)
            return list(self.config.anonymous_tenants)
        from zeebe_tpu_torch.gateway.oauth import bearer_token

        token = bearer_token(invocation_metadata)
        if token and token in self.config.token_tenants:
            return list(self.config.token_tenants[token])
        return list(self.config.anonymous_tenants)

    def check(self, invocation_metadata, tenant: str) -> tuple[str | None, str]:
        """Validate one addressed tenant. Returns (error, detail): error is
        None when authorized, else "disabled" (multi-tenancy off but a
        non-default tenant was addressed) or "denied"."""
        tenant = tenant or DEFAULT_TENANT
        if not self.config.multi_tenancy_enabled:
            if tenant != DEFAULT_TENANT:
                return ("disabled",
                        f"multi-tenancy is disabled: tenant '{tenant}' cannot "
                        "be addressed (only the default tenant)")
            return (None, tenant)
        if tenant not in self.authorized_tenants(invocation_metadata):
            return ("denied", f"not authorized for tenant '{tenant}'")
        return (None, tenant)

"""gRPC gateway: client API front-end (SURVEY §2.11)."""

from zeebe_tpu_torch.gateway.broker_client import ClusterRuntime
from zeebe_tpu_torch.gateway.gateway import Gateway, GatewayService

__all__ = ["ClusterRuntime", "Gateway", "GatewayService"]

"""The gateway's in-process runtime: ``ClusterRuntime`` over the port's
brokers. The gRPC front of the reference's package (``gateway.py`` and its
protocol, authentication and admission modules) is not part of the port
yet, so nothing here imports ``grpc``."""

from zeebe_tpu_torch.gateway.broker_client import ClusterRuntime

__all__ = ["ClusterRuntime"]

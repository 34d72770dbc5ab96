"""Client library: ZeebeClient-equivalent fluent API + job worker (SURVEY §2.11)."""

from zeebe_tpu_torch.client.client import ZeebeTpuClient
from zeebe_tpu_torch.client.worker import JobWorker

__all__ = ["ZeebeTpuClient", "JobWorker"]

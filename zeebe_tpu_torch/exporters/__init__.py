"""Exporter SPI + built-in exporters (SURVEY.md §2.13 exporters)."""

from zeebe_tpu_torch.exporters.api import Exporter, ExporterContext, ExporterController
from zeebe_tpu_torch.exporters.director import (
    ExporterContainer,
    ExporterDirector,
    ExportersState,
)
from zeebe_tpu_torch.exporters.elasticsearch import (
    AuthenticationConfiguration,
    AwsConfiguration,
    BulkConfiguration,
    ElasticsearchExporter,
    IndexConfiguration,
    OpensearchExporter,
    RetentionConfiguration,
)
from zeebe_tpu_torch.exporters.recording import RecordingExporter, RecordStream

__all__ = [
    "AuthenticationConfiguration",
    "AwsConfiguration",
    "BulkConfiguration",
    "Exporter",
    "ExporterContainer",
    "ExporterContext",
    "ExporterController",
    "ExporterDirector",
    "ExportersState",
    "ElasticsearchExporter",
    "IndexConfiguration",
    "OpensearchExporter",
    "RetentionConfiguration",
    "RecordingExporter",
    "RecordStream",
]

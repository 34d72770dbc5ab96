"""Structured logging: per-subsystem logger hierarchy + Stackdriver JSON layout.

Reference: dist/src/main/config/log4j2.xml — a Console (pattern) appender and
a Stackdriver (JSON) appender selected by ``ZEEBE_LOG_APPENDER``, level bound
to ``ZEEBE_LOG_LEVEL``, service name/version from
``ZEEBE_LOG_STACKDRIVER_SERVICENAME`` / ``_SERVICEVERSION``; per-subsystem
``Loggers`` classes (broker/src/main/java/io/camunda/zeebe/broker/Loggers.java,
engine/…, gateway/…); the JSON entry shape follows
util/src/main/java/io/camunda/zeebe/util/logging/stackdriver/StackdriverLogEntry.java
(severity, message, logging.googleapis.com/sourceLocation, serviceContext,
context, timestampSeconds/Nanos, exception).
"""

from __future__ import annotations

import io
import json
import logging
import os
import traceback

_SEVERITY = {
    logging.DEBUG: "DEBUG",
    logging.INFO: "INFO",
    logging.WARNING: "WARNING",
    logging.ERROR: "ERROR",
    logging.CRITICAL: "CRITICAL",
}

_ERROR_REPORT_TYPE = (
    "type.googleapis.com/google.devtools.clouderrorreporting.v1beta1.ReportedErrorEvent"
)


class StackdriverFormatter(logging.Formatter):
    """One JSON object per line, Google Cloud Logging special fields
    (reference: StackdriverLogEntryBuilder)."""

    def __init__(self, service_name: str = "", service_version: str = "") -> None:
        super().__init__()
        self.service_name = service_name
        self.service_version = service_version

    def format(self, record: logging.LogRecord) -> str:
        entry: dict = {
            "severity": _SEVERITY.get(record.levelno, "DEFAULT"),
            "message": record.getMessage(),
            "logging.googleapis.com/sourceLocation": {
                "file": record.pathname,
                "line": record.lineno,
                "function": record.funcName,
            },
            "context": {
                "threadName": record.threadName,
                "loggerName": record.name,
            },
            "timestampSeconds": int(record.created),
            "timestampNanos": int((record.created % 1) * 1e9),
        }
        if self.service_name or self.service_version:
            entry["serviceContext"] = {
                "service": self.service_name,
                "version": self.service_version,
            }
        if record.exc_info:
            buf = io.StringIO()
            traceback.print_exception(*record.exc_info, file=buf)
            entry["exception"] = buf.getvalue()
            if record.levelno >= logging.ERROR:
                # error-reporting ingestion marker (reference: @type on
                # ERROR+ entries carrying an exception)
                entry["@type"] = _ERROR_REPORT_TYPE
        return json.dumps(entry, separators=(",", ":"), default=str)


_CONSOLE_PATTERN = (
    "%(asctime)s.%(msecs)03d [%(threadName)s] %(levelname)-5s %(name)s - %(message)s"
)

# explicit name → level map (reference log4j2 accepts TRACE; and resolving
# arbitrary env strings via getattr(logging, …) could hit unrelated module
# attributes like raiseExceptions). Unknown names fall back to INFO.
_LEVELS = {
    "TRACE": logging.DEBUG,  # python logging has no TRACE tier
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARN": logging.WARNING,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "FATAL": logging.CRITICAL,
    "CRITICAL": logging.CRITICAL,
}


def configure_logging(appender: str | None = None, level: str | None = None,
                      service_name: str | None = None,
                      service_version: str | None = None,
                      stream=None) -> logging.Handler:
    """Install the selected appender on the ``zeebe_tpu_torch`` logger hierarchy
    (reference: log4j2.xml root appender ref ``${env:ZEEBE_LOG_APPENDER:-
    Console}``). Returns the installed handler."""
    appender = (appender or os.environ.get("ZEEBE_LOG_APPENDER", "console")).lower()
    level_name = (level or os.environ.get("ZEEBE_LOG_LEVEL", "info")).upper()
    if appender == "stackdriver":
        formatter: logging.Formatter = StackdriverFormatter(
            service_name=service_name
            or os.environ.get("ZEEBE_LOG_STACKDRIVER_SERVICENAME", ""),
            service_version=service_version
            or os.environ.get("ZEEBE_LOG_STACKDRIVER_SERVICEVERSION", ""),
        )
    else:
        formatter = logging.Formatter(_CONSOLE_PATTERN, datefmt="%Y-%m-%d %H:%M:%S")
    handler = logging.StreamHandler(stream)
    handler.setFormatter(formatter)
    root = logging.getLogger("zeebe_tpu_torch")
    for old in list(root.handlers):
        root.removeHandler(old)
    root.addHandler(handler)
    root.setLevel(_LEVELS.get(level_name.upper(), logging.INFO))
    root.propagate = False
    return handler


class Loggers:
    """Per-subsystem loggers (reference: the per-module Loggers classes —
    io.camunda.zeebe.broker.*, engine processing, gateway, raft, journal)."""

    SYSTEM = logging.getLogger("zeebe_tpu_torch.broker.system")
    CLUSTERING = logging.getLogger("zeebe_tpu_torch.broker.clustering")
    TRANSPORT = logging.getLogger("zeebe_tpu_torch.broker.transport")
    LOGSTREAMS = logging.getLogger("zeebe_tpu_torch.logstreams")
    JOURNAL = logging.getLogger("zeebe_tpu_torch.journal")
    RAFT = logging.getLogger("zeebe_tpu_torch.raft")
    SNAPSHOT = logging.getLogger("zeebe_tpu_torch.snapshot")
    STREAM_PROCESSING = logging.getLogger("zeebe_tpu_torch.stream")
    PROCESS_PROCESSOR = logging.getLogger("zeebe_tpu_torch.engine.processing")
    GATEWAY = logging.getLogger("zeebe_tpu_torch.gateway")
    JOB_STREAM = logging.getLogger("zeebe_tpu_torch.gateway.jobstream")
    EXPORTERS = logging.getLogger("zeebe_tpu_torch.broker.exporter")
    KERNEL = logging.getLogger("zeebe_tpu_torch.kernel_backend")
    TOPOLOGY = logging.getLogger("zeebe_tpu_torch.topology")
    BACKUP = logging.getLogger("zeebe_tpu_torch.backup")

    @staticmethod
    def exporter_logger(exporter_id: str) -> logging.Logger:
        """Per-exporter child logger (reference: Loggers.getExporterLogger)."""
        return logging.getLogger(f"zeebe_tpu_torch.broker.exporter.{exporter_id}")

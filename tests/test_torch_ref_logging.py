# tests/test_logging.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Structured logging tests (reference: dist log4j2.xml Console/Stackdriver
appenders, StackdriverLayoutTest, per-subsystem Loggers classes)."""

import io
import json
import logging

import pytest

from zeebe_tpu_torch.utils.zlogging import Loggers, configure_logging


@pytest.fixture(autouse=True)
def _reset_zeebe_logger():
    root = logging.getLogger("zeebe_tpu_torch")
    saved = (list(root.handlers), root.level, root.propagate)
    yield
    for h in list(root.handlers):
        root.removeHandler(h)
    for h in saved[0]:
        root.addHandler(h)
    root.setLevel(saved[1])
    root.propagate = saved[2]


class TestStackdriverLayout:
    def test_json_entry_fields(self):
        buf = io.StringIO()
        configure_logging(appender="stackdriver", level="info",
                          service_name="zeebe", service_version="8.4.0",
                          stream=buf)
        Loggers.SYSTEM.info("broker %s ready", "b0")
        entry = json.loads(buf.getvalue().strip())
        assert entry["severity"] == "INFO"
        assert entry["message"] == "broker b0 ready"
        loc = entry["logging.googleapis.com/sourceLocation"]
        assert loc["file"].endswith("test_torch_ref_logging.py") and loc["line"] > 0
        assert entry["context"]["loggerName"] == "zeebe_tpu_torch.broker.system"
        assert entry["serviceContext"] == {"service": "zeebe", "version": "8.4.0"}
        assert isinstance(entry["timestampSeconds"], int)

    def test_exception_carries_error_type(self):
        buf = io.StringIO()
        configure_logging(appender="stackdriver", stream=buf)
        try:
            raise ValueError("boom")
        except ValueError:
            Loggers.RAFT.exception("append failed")
        entry = json.loads(buf.getvalue().strip())
        assert entry["severity"] == "ERROR"
        assert "ValueError: boom" in entry["exception"]
        assert entry["@type"].endswith("ReportedErrorEvent")

    def test_each_line_is_one_json_object(self):
        buf = io.StringIO()
        configure_logging(appender="stackdriver", stream=buf)
        for i in range(3):
            Loggers.GATEWAY.warning("w%d", i)
        lines = buf.getvalue().strip().split("\n")
        assert len(lines) == 3
        assert all(json.loads(line)["severity"] == "WARNING" for line in lines)


class TestConsoleLayout:
    def test_pattern_layout(self):
        buf = io.StringIO()
        configure_logging(appender="console", level="debug", stream=buf)
        Loggers.JOURNAL.debug("segment rolled")
        line = buf.getvalue().strip()
        assert "DEBUG" in line
        assert "zeebe_tpu_torch.journal" in line
        assert "segment rolled" in line
        # not JSON
        assert not line.startswith("{")

    def test_level_binding(self):
        buf = io.StringIO()
        configure_logging(appender="console", level="warn", stream=buf)
        Loggers.SYSTEM.info("hidden")
        Loggers.SYSTEM.warning("shown")
        assert "hidden" not in buf.getvalue()
        assert "shown" in buf.getvalue()


class TestEnvBinding:
    def test_env_appender_selection(self, monkeypatch):
        monkeypatch.setenv("ZEEBE_LOG_APPENDER", "stackdriver")
        monkeypatch.setenv("ZEEBE_LOG_LEVEL", "debug")
        monkeypatch.setenv("ZEEBE_LOG_STACKDRIVER_SERVICENAME", "svc")
        buf = io.StringIO()
        configure_logging(stream=buf)
        Loggers.SYSTEM.debug("env test")
        entry = json.loads(buf.getvalue().strip())
        assert entry["severity"] == "DEBUG"
        assert entry["serviceContext"]["service"] == "svc"


class TestLoggerHierarchy:
    def test_subsystem_names(self):
        assert Loggers.RAFT.name == "zeebe_tpu_torch.raft"
        assert Loggers.EXPORTERS.name == "zeebe_tpu_torch.broker.exporter"
        assert (Loggers.exporter_logger("es").name
                == "zeebe_tpu_torch.broker.exporter.es")

    def test_children_inherit_root_handler(self):
        buf = io.StringIO()
        configure_logging(appender="stackdriver", stream=buf)
        Loggers.exporter_logger("es").warning("lag")
        assert json.loads(buf.getvalue().strip())["context"]["loggerName"] \
            == "zeebe_tpu_torch.broker.exporter.es"


class TestLevelMapping:
    def test_trace_maps_to_debug(self):
        buf = io.StringIO()
        configure_logging(appender="console", level="trace", stream=buf)
        Loggers.SYSTEM.debug("trace shown")
        assert "trace shown" in buf.getvalue()

    def test_unknown_level_falls_back_to_info(self):
        # getattr-based resolution once mapped arbitrary logging-module
        # attributes (e.g. raiseExceptions → setLevel(True)); unknown names
        # must fall back to INFO instead
        buf = io.StringIO()
        configure_logging(appender="console", level="raiseExceptions", stream=buf)
        import logging as _logging

        assert _logging.getLogger("zeebe_tpu_torch").level == _logging.INFO

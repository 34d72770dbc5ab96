# tests/test_external_code.py run on the port, written by
# ``python zeebe_tpu_torch/testing/copies.py``: do not edit.
"""Dynamic exporter / gateway-interceptor loading from external artifacts.

Reference: util/…/jar/ExternalJarRepository.java:1 (exporter JARs loaded at
boot) and gateway/…/interceptors/impl/InterceptorRepository.java:1. Here the
artifacts are Python files named by ZEEBE_BROKER_EXPORTERS_<ID>_* /
ZEEBE_GATEWAY_INTERCEPTORS_<ID>_* env vars (utils/external_code.py).
"""

from __future__ import annotations

import textwrap

import pytest

from zeebe_tpu_torch.utils.external_code import (
    exporters_factory_from_env,
    gateway_interceptors_from_env,
    load_external_class,
)

EXPORTER_SRC = textwrap.dedent(
    """
    from zeebe_tpu_torch.exporters.api import Exporter

    SEEN = []  # module-level so the test can observe exports

    class FileDropExporter(Exporter):
        def configure(self, context):
            self.context = context
            SEEN.append(("configured", dict(context.configuration or {})))

        def open(self, controller):
            self.controller = controller

        def export(self, record):
            SEEN.append(("record", record.record.intent.name))
            self.controller.update_last_exported_position(record.position)
    """
)

INTERCEPTOR_SRC = textwrap.dedent(
    """
    import grpc

    class BlockHeaderInterceptor(grpc.ServerInterceptor):
        '''Rejects any rpc carrying the x-blocked metadata key.'''

        def intercept_service(self, continuation, handler_call_details):
            meta = dict(handler_call_details.invocation_metadata or ())
            if meta.get("x-blocked"):
                def abort(request, context):
                    context.abort(grpc.StatusCode.PERMISSION_DENIED,
                                  "blocked by external interceptor")
                return grpc.unary_unary_rpc_method_handler(abort)
            return continuation(handler_call_details)
    """
)


class TestLoadExternalClass:
    def test_load_from_file(self, tmp_path):
        art = tmp_path / "my_exporter.py"
        art.write_text(EXPORTER_SRC)
        cls = load_external_class("FileDropExporter", str(art))
        assert cls.__name__ == "FileDropExporter"
        # content-addressed module names: same path loads once
        assert load_external_class("FileDropExporter", str(art)) is cls

    def test_load_dotted_importable(self):
        cls = load_external_class("zeebe_tpu_torch.exporters.api.Exporter")
        from zeebe_tpu_torch.exporters.api import Exporter

        assert cls is Exporter

    def test_missing_module_path_rejected(self):
        with pytest.raises(ImportError):
            load_external_class("JustAClass")

    def test_non_class_rejected(self, tmp_path):
        art = tmp_path / "notaclass.py"
        art.write_text("thing = 42\n")
        with pytest.raises(TypeError):
            load_external_class("thing", str(art))


class TestExternalExporterOnBroker:
    def test_env_configured_exporter_receives_records(self, tmp_path):
        art = tmp_path / "filedrop.py"
        art.write_text(EXPORTER_SRC)
        env = {
            "ZEEBE_BROKER_EXPORTERS_FILEDROP_CLASSNAME": "FileDropExporter",
            "ZEEBE_BROKER_EXPORTERS_FILEDROP_PATH": str(art),
            "ZEEBE_BROKER_EXPORTERS_FILEDROP_ARGS_TARGET": "/tmp/out",
        }
        factory = exporters_factory_from_env(env)
        assert factory is not None

        from zeebe_tpu_torch.broker import InProcessCluster
        from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
        from zeebe_tpu_torch.protocol import ValueType, command
        from zeebe_tpu_torch.protocol.intent import (
            DeploymentIntent,
            ProcessInstanceCreationIntent,
        )

        c = InProcessCluster(broker_count=1, partition_count=1,
                             replication_factor=1,
                             directory=tmp_path / "cluster",
                             exporters_factory=factory, device="cpu")
        try:
            c.await_leaders()
            model = (Bpmn.create_executable_process("x").start_event("s")
                     .end_event("e").done())
            c.write_command(1, command(
                ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                {"resources": [{"resourceName": "x.bpmn",
                                "resource": to_bpmn_xml(model)}]}))
            c.write_command(1, command(
                ValueType.PROCESS_INSTANCE_CREATION,
                ProcessInstanceCreationIntent.CREATE,
                {"bpmnProcessId": "x", "version": -1, "variables": {}}))
            c.run(500)
        finally:
            c.close()
        import sys

        mod = next(m for name, m in sys.modules.items()
                   if name.startswith("_zb_ext_") and hasattr(m, "SEEN")
                   and any(s[0] == "configured" for s in m.SEEN))
        configured = [s for s in mod.SEEN if s[0] == "configured"]
        assert configured and configured[0][1] == {"target": "/tmp/out"}
        assert any(s == ("record", "ELEMENT_COMPLETED") for s in mod.SEEN)


class TestExternalGatewayInterceptor:
    def test_env_interceptor_blocks_flagged_calls(self, tmp_path):
        art = tmp_path / "blocker.py"
        art.write_text(INTERCEPTOR_SRC)
        env = {
            "ZEEBE_GATEWAY_INTERCEPTORS_BLOCK_CLASSNAME": "BlockHeaderInterceptor",
            "ZEEBE_GATEWAY_INTERCEPTORS_BLOCK_PATH": str(art),
        }
        interceptors = gateway_interceptors_from_env(env)
        assert len(interceptors) == 1

        import grpc

        from zeebe_tpu_torch.gateway import ClusterRuntime, Gateway
        from zeebe_tpu_torch.client import ZeebeTpuClient

        runtime = ClusterRuntime(broker_count=1, partition_count=1, device="cpu")
        runtime.start()
        gateway = Gateway(runtime, extra_interceptors=interceptors)
        gateway.start()
        try:
            client = ZeebeTpuClient(gateway.address)
            topo = client.topology()  # un-flagged: passes the chain
            assert topo.partitions_count == 1

            channel = grpc.insecure_channel(gateway.address)
            from zeebe_tpu_torch.gateway.proto import gateway_pb2 as pb

            stub = channel.unary_unary(
                "/gateway_protocol.Gateway/Topology",
                request_serializer=pb.TopologyRequest.SerializeToString,
                response_deserializer=pb.TopologyResponse.FromString,
            )
            with pytest.raises(grpc.RpcError) as exc:
                stub(pb.TopologyRequest(), metadata=(("x-blocked", "1"),))
            assert exc.value.code() == grpc.StatusCode.PERMISSION_DENIED
        finally:
            gateway.stop()
            runtime.stop()


class TestEnvScanEdgeCases:
    def test_underscore_ids(self, tmp_path):
        art = tmp_path / "audit.py"
        art.write_text(EXPORTER_SRC)
        env = {
            "ZEEBE_BROKER_EXPORTERS_AUDIT_LOG_CLASSNAME": "FileDropExporter",
            "ZEEBE_BROKER_EXPORTERS_AUDIT_LOG_PATH": str(art),
            "ZEEBE_BROKER_EXPORTERS_AUDIT_LOG_ARGS_BULK_SIZE": "9",
        }
        factory = exporters_factory_from_env(env)
        assert factory is not None
        exporters = factory()
        assert set(exporters) == {"audit_log"}
        _exp, config = exporters["audit_log"]
        assert config == {"bulk_size": "9"}

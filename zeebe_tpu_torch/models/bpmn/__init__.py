"""BPMN model library: fluent builder, XML I/O, deploy-time transformer
(SURVEY.md §2.9 bpmn-model + engine deployment transformation)."""

from zeebe_tpu_torch.models.bpmn.executable import (
    ExecutableElement,
    ExecutableFlow,
    ExecutableProcess,
    ProcessValidationError,
    transform,
)
from zeebe_tpu_torch.models.bpmn.model import (
    Bpmn,
    BpmnModelError,
    ProcessBuilder,
    ProcessElement,
    ProcessModel,
    SequenceFlow,
)
from zeebe_tpu_torch.models.bpmn.xml_io import parse_bpmn_xml, to_bpmn_xml

__all__ = [
    "Bpmn",
    "BpmnModelError",
    "ExecutableElement",
    "ExecutableFlow",
    "ExecutableProcess",
    "ProcessBuilder",
    "ProcessElement",
    "ProcessModel",
    "ProcessValidationError",
    "SequenceFlow",
    "parse_bpmn_xml",
    "to_bpmn_xml",
    "transform",
]

"""Workflow engine: BPMN semantics over the stream platform (SURVEY.md §2.8)."""

from zeebe_tpu_torch.engine.engine import Engine
from zeebe_tpu_torch.engine.engine_state import EngineState

__all__ = ["Engine", "EngineState"]

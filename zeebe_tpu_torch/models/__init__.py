"""Model libraries: BPMN."""

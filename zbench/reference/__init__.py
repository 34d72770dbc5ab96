"""The benchmark's plain reference: Zeebe's record semantics for the
benchmark's process models, worked out from their BPMN files, and the
judge that holds a run's logs, replies and state to them. Standard library
only; it imports nothing of the program under test."""

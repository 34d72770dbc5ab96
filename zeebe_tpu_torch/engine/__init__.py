"""The device half of the engine's batched execution backend."""

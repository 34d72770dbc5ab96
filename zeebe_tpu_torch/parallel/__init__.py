"""Partitions as shards of the device batch: the mesh and its runner."""

"""Fixture: the reference's clean twin on the port's seam — the same
storage behavior routed through the seam (zero findings), plus the
read-side calls the rule deliberately does not ban."""

import os
from pathlib import Path

from zeebe_tpu_torch.utils import storage_io


def persist(directory: Path, data: bytes) -> None:
    with storage_io.open_file(directory / "state.bin", "wb") as f:
        f.write(data)
    storage_io.fsync_path(directory / "state.bin")
    storage_io.replace(directory / "tmp", directory / "final")
    storage_io.write_text(directory / "manifest", "ok")


def read_back(directory: Path) -> bytes:
    # reads are not write seams: Path.read_bytes stays legal
    data = (directory / "state.bin").read_bytes()
    os.close(os.dup(0))  # unrelated os call — not a storage-IO sink
    return data

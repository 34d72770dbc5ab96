"""The storage IO seam: ONE indirection between the storage subsystems and
the filesystem.

Every durable-storage writer — the segmented journal, the snapshot store,
the cold tier, the backup store — routes its ``open``/``write``/``fsync``/
``replace`` calls through this module instead of calling the OS directly.
With no controller installed (production) every helper is a passthrough:
one module-global ``is None`` check per call. With a
:class:`~zeebe_tpu_torch.testing.chaos_disk.DiskChaosController` installed
(``ZEEBE_CHAOS_DISK``), writes and fsyncs consult the seeded fault plan
first — EIO/ENOSPC, torn short-writes, fsync stalls, fsync failures land
exactly at the syscall boundary they would come from on real hardware.

The zlint rule ``storage-io-discipline`` machine-enforces the seam: direct
``open``/``os.open``/``os.fsync``/``os.replace``/``write_bytes`` calls
inside the storage modules are findings, so new storage code cannot
silently bypass fault injection (and with it, everything the torture gate
proves).
"""

from __future__ import annotations

import errno
import os
from pathlib import Path

#: the installed DiskChaosController (testing/chaos_disk.py) or None.
#: Installed once at process start (worker entry / test fixture) — not
#: mutated on the IO path, so unsynchronized reads are safe.
_controller = None


def install_controller(controller) -> None:
    """Install (or clear, with None) the process-wide disk-fault
    controller. Testing-only seam; production never calls it."""
    global _controller
    _controller = controller


def controller():
    return _controller


def _raise_write_fault(verdict: str, path) -> None:
    if verdict == "eio":
        raise OSError(errno.EIO, f"chaos write EIO on {path}")
    raise OSError(errno.ENOSPC, f"chaos write ENOSPC on {path}")


class _ChaosFile:
    """File-object proxy applying write faults; everything else delegates.
    Only constructed when a controller is installed AND the path is a
    storage path — the common case never pays the wrapper."""

    __slots__ = ("_f", "_path")

    def __init__(self, f, path) -> None:
        self._f = f
        self._path = path

    def write(self, data):
        c = _controller
        if c is None:  # controller uninstalled after this handle opened
            return self._f.write(data)
        verdict, prefix = c.write_fault(self._path, len(data))
        if verdict == "ok":
            return self._f.write(data)
        if verdict == "torn":
            # the classic short-write: a prefix reaches the file, then the
            # error surfaces — the caller's retry must overwrite the tear
            self._f.write(bytes(data[:prefix]))
            raise OSError(errno.EIO,
                          f"chaos torn write ({prefix}/{len(data)} bytes) "
                          f"on {self._path}")
        _raise_write_fault(verdict, self._path)

    def __getattr__(self, name):
        return getattr(self._f, name)

    # context-manager support must live on the proxy itself (dunder lookup
    # bypasses __getattr__)
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        return False

    def __iter__(self):
        return iter(self._f)


def open_file(path, mode: str = "rb"):
    """``open()`` for storage files. Write-capable handles come back
    fault-wrapped when disk chaos is armed."""
    f = open(path, mode)
    if _controller is not None and any(c in mode for c in "wa+x"):
        return _ChaosFile(f, path)
    return f


def os_open(path, flags: int, mode: int = 0o644) -> int:
    return os.open(path, flags, mode)


def fsync(fd: int, path=None) -> None:
    """``os.fsync`` with the chaos seam in front: a chaos fsync failure
    raises BEFORE the real fsync — after it, the page cache state of the
    simulated device is undefined, which is exactly the fsyncgate contract
    the journal's failed-flush handling is built against."""
    if _controller is not None:
        _controller.fsync_fault(path)
    os.fsync(fd)


def pwrite(fd: int, data: bytes, offset: int, path=None) -> int:
    if _controller is not None:
        verdict, prefix = _controller.write_fault(path, len(data))
        if verdict == "torn":
            os.pwrite(fd, bytes(data[:prefix]), offset)
            raise OSError(errno.EIO, f"chaos torn pwrite on {path}")
        if verdict != "ok":
            _raise_write_fault(verdict, path)
    return os.pwrite(fd, data, offset)


def pread(fd: int, length: int, offset: int) -> bytes:
    return os.pread(fd, length, offset)


def replace(src, dst) -> None:
    os.replace(src, dst)


def write_bytes(path, data: bytes) -> None:
    with open_file(path, "wb") as f:
        f.write(data)


def write_text(path, text: str, encoding: str = "utf-8") -> None:
    write_bytes(path, text.encode(encoding))


def read_bytes(path) -> bytes:
    return Path(path).read_bytes()


def fsync_path(path) -> None:
    """Open-fsync-close a path (file or directory) through the seam."""
    fd = os_open(path, os.O_RDONLY)
    try:
        fsync(fd, path)
    finally:
        os.close(fd)

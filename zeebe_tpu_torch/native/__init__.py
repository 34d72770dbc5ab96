"""Native (C) hot-path components, built on demand with gcc.

The reference gets its native muscle from dependencies (RocksDB JNI, Netty,
Agrona, SBE codegen — SURVEY.md §intro); here the hot paths that stay on the
host CPU are C extensions compiled from sources in this directory the first
time they are needed and cached next to them. Every consumer falls back to
its pure-Python implementation when the toolchain or build is unavailable, so
nothing in the framework *requires* the native path — it is a performance
floor, not a correctness dependency.

Current components:
- ``_zb_codec`` (codec.c): msgpack record codec (spec: protocol/msgpack.py).
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import threading

logger = logging.getLogger("zeebe_tpu_torch.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_CACHE: dict[str, object | None] = {}


def _build_and_load(module_name: str, source: str):
    src = os.path.join(_DIR, source)
    tag = sysconfig.get_config_var("SOABI") or "so"
    out = os.path.join(_DIR, f"{module_name}.{tag}.so")
    if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
        include = sysconfig.get_paths()["include"]
        # compile to a per-pid temp path and rename into place: rename is
        # atomic, so concurrent processes racing the build can never dlopen a
        # half-written .so (they either see the old complete one or the new
        # complete one)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [
            os.environ.get("CC", "gcc"), "-O2", "-shared", "-fPIC",
            f"-I{include}", src, "-o", tmp,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    spec = importlib.util.spec_from_file_location(module_name, out)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load(module_name: str, source: str):
    """Build (if stale) and import a native module; None when unavailable.

    Set ZEEBE_TPU_NO_NATIVE=1 to force the pure-Python fallbacks (used by the
    parity tests to exercise both paths)."""
    if os.environ.get("ZEEBE_TPU_NO_NATIVE"):
        return None
    with _LOCK:
        if module_name in _CACHE:
            return _CACHE[module_name]
        try:
            module = _build_and_load(module_name, source)
        except Exception as exc:  # noqa: BLE001 — any build/load failure → fallback
            logger.warning("native %s unavailable (%s); using pure-Python fallback",
                           module_name, exc)
            module = None
        _CACHE[module_name] = module
        return module


def load_codec():
    return load("_zb_codec", "codec.c")


def codec_fn(name: str):
    """A named function from the codec module, or None when the native
    build is unavailable or predates the function (stale .so)."""
    codec = load_codec()
    return getattr(codec, name, None) if codec is not None else None

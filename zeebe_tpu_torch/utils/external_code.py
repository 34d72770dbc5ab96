"""Dynamic loading of externally-shipped exporters and gateway interceptors.

Reference: util/src/main/java/io/camunda/zeebe/util/jar/ExternalJarRepository
.java:1 (exporter JARs loaded from configured paths at broker boot, each in
an isolated classloader) and gateway/src/main/java/io/camunda/zeebe/gateway/
interceptors/impl/InterceptorRepository.java:1 (gateway interceptor
artifacts). The tpu-native equivalent ships Python artifacts: a class is
named by ``CLASSNAME`` (dotted path, importable) and optionally located by
``PATH`` (a .py file or a directory added to the search path) — operators
drop a file next to the deployment instead of rebuilding the image.

Environment shapes (mirroring the reference's config tree):

    ZEEBE_BROKER_EXPORTERS_<ID>_CLASSNAME = mymod.MyExporter | MyExporter
    ZEEBE_BROKER_EXPORTERS_<ID>_PATH      = /opt/exporters/myexp.py   (opt)
    ZEEBE_BROKER_EXPORTERS_<ID>_ARGS_<K>  = value                      (opt)

    ZEEBE_GATEWAY_INTERCEPTORS_<ID>_CLASSNAME / _PATH                  (opt)
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import os
import sys
from typing import Any, Callable


def load_external_class(class_name: str, path: str | None = None) -> type:
    """Resolve ``class_name`` (``module.sub.Class`` or bare ``Class`` when
    ``path`` names the defining .py file) from an external artifact.

    ``path``: a .py file (loaded under a content-addressed module name, so
    two artifacts defining the same module name cannot collide — the
    classloader-isolation property of the reference's ExternalJarRepository)
    or a directory appended to ``sys.path``.
    """
    module = None
    if path:
        path = os.path.abspath(path)
        if os.path.isdir(path):
            if path not in sys.path:
                sys.path.append(path)
        else:
            mod_name = "_zb_ext_" + hashlib.sha256(path.encode()).hexdigest()[:12]
            module = sys.modules.get(mod_name)
            if module is None:
                spec = importlib.util.spec_from_file_location(mod_name, path)
                if spec is None or spec.loader is None:
                    raise ImportError(f"cannot load external artifact {path!r}")
                module = importlib.util.module_from_spec(spec)
                sys.modules[mod_name] = module
                try:
                    spec.loader.exec_module(module)
                except BaseException:
                    sys.modules.pop(mod_name, None)
                    raise
    if "." in class_name and module is None:
        mod_path, _, attr = class_name.rpartition(".")
        module = importlib.import_module(mod_path)
        class_name = attr
    if module is None:
        raise ImportError(
            f"external class {class_name!r} needs a dotted module path or an "
            "artifact PATH"
        )
    obj: Any = module
    for part in class_name.split("."):
        obj = getattr(obj, part)
    if not isinstance(obj, type):
        raise TypeError(f"{class_name!r} in {getattr(module, '__name__', path)!r} "
                        "is not a class")
    return obj


def _scan_env(env: dict[str, str], prefix: str) -> dict[str, dict[str, Any]]:
    """{id: {"classname":…, "path":…, "args": {k: v}}} from PREFIX_<ID>_*.

    The field suffix is matched from the RIGHT so ids may contain
    underscores (ZEEBE_BROKER_EXPORTERS_AUDIT_LOG_CLASSNAME → id
    ``audit_log``)."""
    out: dict[str, dict[str, Any]] = {}
    for var, value in env.items():
        if not var.startswith(prefix):
            continue
        rest = var[len(prefix):]
        # ARGS first: an ARG key may itself end in CLASSNAME/PATH
        # (…_S3_ARGS_INDEX_PATH is s3's arg, not a phantom exporter's path)
        if "_ARGS_" in rest:
            ext_id, _, arg = rest.partition("_ARGS_")
            field = "args"
        elif rest.endswith("_CLASSNAME"):
            ext_id, field, arg = rest[:-len("_CLASSNAME")], "classname", None
        elif rest.endswith("_PATH"):
            ext_id, field, arg = rest[:-len("_PATH")], "path", None
        else:
            continue
        if not ext_id:
            continue
        entry = out.setdefault(ext_id.lower(), {"args": {}})
        if field == "args":
            entry["args"][arg.lower()] = value
        else:
            entry[field] = value
    return {eid: e for eid, e in out.items() if e.get("classname")}


def exporters_factory_from_env(
    env: dict[str, str] | None = None,
) -> Callable[[], dict[str, tuple[Any, dict]]] | None:
    """A per-partition exporter factory from ``ZEEBE_BROKER_EXPORTERS_*``,
    or None when nothing is configured. Classes resolve at CALL time (boot),
    once per partition instantiation — each partition gets fresh instances,
    with the configured ARGS as the exporter's configuration dict."""
    env = dict(os.environ if env is None else env)
    specs = _scan_env(env, "ZEEBE_BROKER_EXPORTERS_")
    if not specs:
        return None

    def factory() -> dict[str, tuple[Any, dict]]:
        out: dict[str, tuple[Any, dict]] = {}
        for ext_id, spec in sorted(specs.items()):
            cls = load_external_class(spec["classname"], spec.get("path"))
            out[ext_id] = (cls(), spec["args"])
        return out

    return factory


def gateway_interceptors_from_env(
    env: dict[str, str] | None = None,
) -> tuple:
    """Instantiated gRPC server interceptors from
    ``ZEEBE_GATEWAY_INTERCEPTORS_*`` (reference: InterceptorRepository →
    interceptor chain ahead of every handler), ordered by id."""
    env = dict(os.environ if env is None else env)
    specs = _scan_env(env, "ZEEBE_GATEWAY_INTERCEPTORS_")
    return tuple(
        load_external_class(spec["classname"], spec.get("path"))()
        for _eid, spec in sorted(specs.items())
    )

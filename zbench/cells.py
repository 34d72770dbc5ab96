"""Finding a cell's parts by name: the cell in ``BENCHMARK.json``, its
configuration in ``zbench/configs/<config>.json``, its traffic in
``zbench/traffic/<traffic>.json``, the process model the traffic names in
``zbench/models/<model>.bpmn`` and each per-layer metric's reader in
``zbench/metrics/<name>.py``. A later cell, configuration, model or metric
is a new file and a new manifest entry; nothing here changes for it."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

#: the checkout's root: BENCHMARK.json lies there, the benchmark beneath it
ROOT = Path(__file__).resolve().parents[1]


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    model_name: str
    model_xml: str
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]
    root: Path


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with every file it names read; KeyError when the
    manifest has no such cell."""
    bench = manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "zbench" / "traffic" / f"{w['traffic']}.json").read_text())
    model = traffic["model"]
    xml = (root / "zbench" / "models" / f"{model}.bpmn").read_text()

    def reported(metrics: list) -> tuple:
        """The metrics this cell reports: those without ``workloads``, and
        those whose ``workloads`` name it."""
        return tuple(m for m in metrics if name in m.get("workloads", [name]))

    return Cell(name, int(w["chips"]), config, traffic, model, xml,
                reported(bench["end_to_end"]), reported(bench["per_layer"]), root)


def reader(name: str, root: Path = ROOT):
    """The ``read(window)`` function of the per-layer metric ``name``."""
    path = root / "zbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"zbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

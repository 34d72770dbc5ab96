"""Finding a cell's parts by name, the manifest's shape, and adding a cell
and a metric as new files only."""

import json
import re
import shutil

import pytest

from zbench import cells
from zbench.window import Window

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_config_traffic_model_and_metrics():
    bench = cells.manifest()
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["loop"] == "closed"
        assert "<bpmn:process" in cell.model_xml
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))
    with pytest.raises(KeyError):
        cells.load("no-such-cell")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_manifest_names_and_units_use_the_allowed_characters(section):
    bench = cells.manifest()
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for entry in bench[section]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in entry.get("reduced", []):
            assert NAME.match(key)
        for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
            assert text is None or (0 < len(text) <= 200 and "\n" not in text)


def test_manifest_keys_follow_the_contract():
    bench = cells.manifest()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for c in bench["configs"]:
        config = json.loads((cells.ROOT / c["file"]).read_text())
        assert sorted(config["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert config["published"][key] != config[key]


def test_a_cell_and_a_metric_are_added_as_new_files_only(tmp_path):
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(cells.ROOT / "zbench", tmp_path / "zbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "zbench").rglob("*") if p.is_file()}
    traffic = json.loads((tmp_path / "zbench/traffic/one_task.c64.json").read_text())
    (tmp_path / "zbench/traffic/one_task.c8.json").write_text(
        json.dumps(dict(traffic, clients=8)))
    (tmp_path / "zbench/metrics/activations_per_s.py").write_text(
        "def read(w):\n    return len(w.activations) / w.seconds if w.activations else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for path in sorted((tmp_path / "zbench/held").glob("*.json")):
        held = json.loads(path.read_text())
        for key in ("configs", "workloads", "per_layer"):
            bench[key] += held[key]
    bench["workloads"].append({"name": "zeebe-1x1.one_task.c8", "config": "zeebe-1x1",
                               "traffic": "one_task.c8", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "activations_per_s", "unit": "1/s", "better": "lower",
                               "source": "program_counter", "layer": "gateway runtime",
                               "moves": "instances_per_s",
                               "workloads": ["zeebe-1x1.one_task.c8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load("zeebe-1x1.one_task.c8", root=tmp_path)
    assert cell.traffic["clients"] == 8 and cell.config["partitions_count"] == 1
    assert "activations_per_s" in {m["name"] for m in cell.per_layer}
    for other in ("zeebe-3x3.one_task.c1", "zeebe-3x3.one_task.c64"):
        assert "activations_per_s" not in {
            m["name"] for m in cells.load(other, root=tmp_path).per_layer}
    assert "instance_p95_ms.1x1" in {
        m["name"] for m in cells.load("zeebe-1x1.ten_tasks.c128", root=tmp_path).per_layer}
    window = Window(2.0, {}, {}, activations=[3, 0, 5, 1])
    assert cells.reader("activations_per_s", root=tmp_path)(window) == 2.0
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "zbench").rglob("*") if p.is_file()}
    assert all(after[p] == content for p, content in before.items())

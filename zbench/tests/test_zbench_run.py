"""Whole runs on the CPU (the kernel backend's plain version): a sound run
comes out correct, and a run with the timed path broken underneath (the
control, and each fault the cell can have) comes out not correct. The
harness's look for a card is skipped by calling ``run_cell`` with the CPU;
``main`` itself refuses to run without a card."""

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from zbench import cells, drive, faults
from zbench import run as zrun

CELLS = ["zeebe-3x3.one_task.c1", "zeebe-1x1.ten_tasks.c128", "zeebe-3x3.one_task.c64"]
#: the branching fixture made into a cell (an exclusive gateway inside one
#: branch of a fork into three tasks, and the join)
BRANCHING = "fork_exclusive"


def load(name: str, tmp_path):
    """The cell ``name``: from BENCHMARK.json, or for a cell held out of it
    (``zbench/held/<name>.json``) from a copy of the manifest with the held
    entries added."""
    bench = cells.manifest()
    if name in {w["name"] for w in bench["workloads"]}:
        return cells.load(name)
    held = json.loads((cells.ROOT / "zbench" / "held" / f"{name}.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        bench[key] += held[key]
    (tmp_path / "zbench").symlink_to(cells.ROOT / "zbench")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return cells.load(name, root=tmp_path)


def small(name: str, tmp_path):
    cell = load(name, tmp_path)
    return dataclasses.replace(cell, traffic=dict(
        cell.traffic, clients=min(8, cell.traffic["clients"]),
        workers=min(2, cell.traffic["workers"]), warmup_s=1.5))


def branching_cell(tmp_path):
    """A cell of the branching fixture on the published 3x3 cluster, made as
    a later change would make it: in a copy of the benchmark, a new model
    file, a new traffic file (``one_task.c1``'s with its model replaced) and
    a new ``workloads`` entry, with no file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.ROOT / "zbench", root / "zbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(Path(__file__).parent / "models" / f"{BRANCHING}.bpmn",
                root / "zbench" / "models")
    traffic = json.loads((root / "zbench" / "traffic" / "one_task.c1.json").read_text())
    (root / "zbench" / "traffic" / f"{BRANCHING}.c1.json").write_text(
        json.dumps(dict(traffic, model=BRANCHING)))
    bench = cells.manifest()
    name = f"zeebe-3x3.{BRANCHING}.c1"
    bench["workloads"].append({"name": name, "config": "zeebe-3x3",
                               "traffic": f"{BRANCHING}.c1", "chips": 1,
                               "why": "closed loop, 1 client: a fork, a join and an "
                                      "exclusive gateway in one branch"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path in (cells.ROOT / "zbench").rglob("*"):
        copy = root / "zbench" / path.relative_to(cells.ROOT / "zbench")
        if path.is_file() and "tests" not in path.parts and "__pycache__" not in path.parts:
            assert copy.read_bytes() == path.read_bytes(), path
    return cells.load(name, root=root)


@pytest.fixture(autouse=True)
def short_waits(monkeypatch):
    monkeypatch.setattr(zrun, "DRAIN_S", 5.0)
    monkeypatch.setattr(drive, "REQUEST_TIMEOUT_S", 5.0)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, tmp_path):
    cell = small(name, tmp_path)
    result = zrun.run_cell(cell, 2**31 + 11, 3.0, False, "cpu")
    assert result["correct"], result["checks"]
    # the CPU has no device trace: only the host's end-to-end metrics
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end
                                      if m["source"] == "host_clock"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0


def test_a_branching_cell_made_of_new_files_runs_correct(tmp_path):
    cell = branching_cell(tmp_path)
    assert cell.model_name == BRANCHING and cell.traffic["clients"] == 1
    result = zrun.run_cell(dataclasses.replace(cell, traffic=dict(cell.traffic, warmup_s=1.5)),
                           2**31 + 23, 3.0, False, "cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert result["checks"]["stuck_instances"]["value"] == 0
    assert result["checks"]["instances_ended"]["value"] > 0


def test_a_branching_cell_with_half_of_each_group_left_out_is_not_correct(tmp_path,
                                                                          monkeypatch):
    # several clients, so that a kernel group holds more than one command
    monkeypatch.setattr(faults, "EVERY", 5)
    cell = branching_cell(tmp_path)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, clients=8, workers=2,
                                                  warmup_s=1.5))
    result = zrun.run_cell(cell, 5, 3.0, False, "cpu", fault="half_left_out")
    assert not result["correct"]
    assert any(c["value"] > c["max"] for c in result["checks"].values() if "max" in c)


def test_a_traced_run_reports_what_it_can_read_on_the_cpu(tmp_path):
    cell = small(CELLS[1], tmp_path)
    result = zrun.run_cell(cell, 7, 3.0, True, "cpu")
    assert result["correct"], result["checks"]
    assert {"commands_per_group", "kernel_command_pct", "group_ms",
            "journal_flush_ms"} <= set(result["metrics"])
    assert result["metrics"]["kernel_command_pct"]["value"] > 0


def test_a_log_compacted_in_the_window_still_judges_correct(monkeypatch, tmp_path):
    """Small journal segments and a snapshot on every leader a second into
    the window: the snapshot compacts the logs (the exporter has
    acknowledged what it saw), and the judge, which reads what the
    exporter kept, still finds every record."""
    import threading
    import time

    from zbench import system
    from zeebe_tpu_torch.journal import SegmentedJournal

    init = SegmentedJournal.__init__
    monkeypatch.setattr(SegmentedJournal, "__init__",
                        lambda self, directory, *a, **kw: init(
                            self, directory, *a, **{**kw, "max_segment_size": 16 * 1024}))
    cell = small(CELLS[1], tmp_path)
    compacted = []
    start = drive.ClosedLoop.start

    def snapshot_later(loop):
        time.sleep(cell.traffic["warmup_s"] + 1.0)
        for pid in range(1, loop.runtime.partition_count + 1):
            # a leader takes no snapshot while a write is in flight (it waits
            # for the commit): try again until one is taken, within the window
            deadline = time.monotonic() + 1.5
            first = None
            while True:
                with system._guard(loop.runtime, pid):
                    leader = system._leader(loop.runtime, pid)
                    if first is None:
                        first = leader.stream.journal.first_index
                    if leader.take_snapshot() or time.monotonic() > deadline:
                        compacted.append(leader.stream.journal.first_index > first)
                        break
                time.sleep(0.01)

    def start_and_snapshot(loop):
        start(loop)
        threading.Thread(target=snapshot_later, args=(loop,), daemon=True).start()

    monkeypatch.setattr(drive.ClosedLoop, "start", start_and_snapshot)
    result = zrun.run_cell(cell, 2**31 + 17, 3.0, False, "cpu")
    assert compacted and all(compacted)
    assert result["correct"], result["checks"]


def clients(name: str) -> int:
    """The client count of the cell ``name``, held or not."""
    entries = list(cells.manifest()["workloads"])
    for path in (cells.ROOT / "zbench" / "held").glob("*.json"):
        entries += json.loads(path.read_text())["workloads"]
    traffic = next(w["traffic"] for w in entries if w["name"] == name)
    return json.loads((cells.ROOT / "zbench" / "traffic" / f"{traffic}.json").read_text())[
        "clients"]


def can_have(fault: str, name: str) -> bool:
    """A fault the cell can have: one partition has no follower to skip a
    batch, and one client's groups are one command each, with no half to
    leave out."""
    if fault == "replica_skipped":
        return not name.startswith("zeebe-1x1")
    if fault == "half_left_out":
        return clients(name) > 1
    return True


@pytest.mark.parametrize("fault,name", [
    (f, n) for f in faults.FAULTS for n in CELLS if can_have(f, n)])
def test_a_broken_run_is_not_correct(fault, name, tmp_path, monkeypatch):
    # one command in 5 rather than 20: a one-client cell on a loaded CPU
    # may send fewer than 20 creates in the short run
    monkeypatch.setattr(faults, "EVERY", 5)
    result = zrun.run_cell(small(name, tmp_path), 5, 3.0, False, "cpu", fault=fault)
    assert not result["correct"]
    assert any(c["value"] > c["max"] for c in result["checks"].values() if "max" in c)


def test_main_refuses_to_run_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card answers here")
    assert zrun.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(cells.ROOT / "zbench", tmp_path / "zbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "zbench/run.py", "--workload", CELLS[0], "--seed",
                          "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert zrun.main(["--workload", CELLS[0], "--seed", "2147483659", "--seconds", "5",
                      "--trace", "1"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["kernel_command_pct"]["value"] > 0

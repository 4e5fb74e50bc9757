"""The harness finds each configuration, traffic mix, cell and per-layer
metric by its name as a file of its own; BENCHMARK.json names files that
exist and keys that keep to the contract."""

import hashlib
import json
import re
from pathlib import Path

from holdbench import run
from holdbench.tests import toy

REPO = toy.SRC.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_added_files_are_found_with_no_file_edited(toy_root, run_cell):
    before = _digest(toy.SRC)
    (toy_root / "metrics" / "steps_traced.train.py").write_text(
        'KINDS = ("train",)\nUNIT = "steps"\nLAYER = "test"\nMOVES = "train_rays_per_s"\n\n\n'
        'def read(t):\n    return float(t["steps"])\n')
    cell = run.load_cell("toy_train")
    assert cell["config"] == "toy_h1o" and cell["kind"] == "train" and cell["rays_per_frame"] == 8
    assert "steps_traced.train" in run.metric_modules("train")
    assert "steps_traced.train" not in run.metric_modules("render")
    rc, res = run_cell("toy_train", trace=1)
    assert rc == 0 and res["metrics"]["steps_traced.train"]["value"] == 1.0
    assert _digest(toy.SRC) == before


def test_benchmark_json_names_its_files():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["holdbench"] and b["command"] == ["python3", "holdbench/run.py"]
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and w["config"] in configs
        cell = run.load_cell(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert set(cell["end_to_end"]) <= e2e and "setup_s" in cell["end_to_end"]
        assert cell["limits"], w["name"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: run.load_cell(w["name"])["kind"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert NAME.match(m["name"]) and m["moves"] in e2e
        mod = run.metric_modules(cells[m["workloads"][0]])[m["name"]]
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
        assert all(cells[w] in mod.KINDS for w in m["workloads"])

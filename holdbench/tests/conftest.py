import json
import sys

import pytest

from holdbench import run
from holdbench.tests import toy


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    """``holdbench.run`` reading the toy copy of the data files."""
    root = toy.make(tmp_path / "holdbench")
    monkeypatch.setattr(run, "HERE", root)
    return root


@pytest.fixture
def run_cell(capsys):
    """Runs a cell on the CPU in this process; returns (exit code, result)."""
    def go(name, seed=11, seconds=1.0, trace=0):
        rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace), "--device", "cpu"])
        out = capsys.readouterr().out.strip().splitlines()
        return rc, (json.loads(out[-1]) if out else None)
    return go

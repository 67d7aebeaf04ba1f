"""Every cell runs on the card through the one command, prints a result
line of the contract's shape and comes out correct. Marked ``cuda``: run
on the card with ``python -m pytest benchmark/tests -m cuda``."""
import json
import pathlib
import subprocess
import sys

import pytest

from benchmark import run

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in run.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_of_each_cell_is_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 77), "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    man = run.manifest()
    group = man["per_layer"] if trace else man["end_to_end"]
    want = {m["name"] for m in group if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10


def test_no_card_no_result(monkeypatch, capsys):
    """Without the cards a cell asks for, the command exits non-zero and
    prints no result."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""

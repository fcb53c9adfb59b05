"""Each cell for a few seconds on the card, as the benchmark's command runs
it: exit 0, a result line with the cell's metrics, and correct. Skips
without a CUDA card; on the card:

    python3 -m pytest -m cuda h100bench/tests/test_h100bench_card.py -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "h100bench", "--workload", cell,
                          "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-2000:]
    assert "setup_s" in res["metrics"] and res["device"]["platform"] == "gpu"


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    import torch

    from h100bench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""

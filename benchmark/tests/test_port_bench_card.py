"""One short run of every cell on the card, as a check makes them: the
last line is the result, correct, on the card, with its metrics. Skips
where there is no card; on the card run
``python -m pytest benchmark/tests/test_port_bench_card.py -q``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures only on one")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("cell", ["train.basic_3d", "correct.basic_3d.z400", "train.conf_2d",
                                  "correct.conf_2d.z400"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 101),
                           "--seconds", "4", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                          timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["kind"] == card and result["device"]["count"] == 1
    assert "setup_s" in result["metrics"] if trace == 0 else "breakdown" in result
    assert all(0 <= m["value"] <= 100 for name, m in result["metrics"].items() if m["unit"] == "%")

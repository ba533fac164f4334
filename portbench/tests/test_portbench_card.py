"""The harness on the card: a short run of every cell, correct, and its
control not.  Skips without a CUDA card (decided inside the test):

    python -m pytest -q -m cuda portbench/tests/test_portbench_card.py
"""
import json
import subprocess
import sys

import pytest

from portbench import cells


def _cells():
    with open(cells.ROOT + "/BENCHMARK.json") as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]


def _line(module, workload, seed):
    p = subprocess.run(
        [sys.executable, "-m", module, "--workload", workload, "--seed",
         str(seed), "--seconds", "5", "--trace", "0"], cwd=cells.ROOT,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_cell_correct_and_control_not(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = _line("portbench.run", workload, 2 ** 31 + 101)
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert _line("portbench.control", workload, 2 ** 31 + 102)[
        "correct"] is False

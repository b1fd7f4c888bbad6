"""On the card, at each cell's own size: the bfloat16 control comes out not
correct on three seeds, and a sound run comes out correct.  Run with
`python -m pytest ptbench/tests/test_ptbench_card.py -m cuda` on a machine
with an H100; without a card every test skips."""

import json
import subprocess
import sys

import pytest
import torch

from tiny import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
         if w["chips"] == 1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(workload, seed, *extra):
    got = subprocess.run([sys.executable, "-m", "ptbench", "--workload", workload, "--seed",
                          str(seed), "--seconds", "8", "--trace", "0", *extra], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_control_is_not_correct(card, workload, seed):
    result = _run(workload, seed, "--control", "bfloat16")
    assert result["correct"] is False, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(card, workload):
    result = _run(workload, 2**31 + 21)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1

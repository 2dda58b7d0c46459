"""A run of each mix on the card, short: it builds, measures, checks and
prints a result line that says correct. Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cifar10.sample", "cifar10.train"])
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2**31 + 11), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1

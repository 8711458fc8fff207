"""The 8192-bit cell on the card: a short run of ``fl_2nn-8192`` through
the harness is correct (python -m pytest paillier_bench/tests -m cuda, on
a machine with one). Its r^n mod n^2 runs on the limb engine at
L = 1,176 and its decrypt halves on the RNS ladder at k = 624."""

import json
import subprocess
import sys

import pytest

from paillier_bench.tests.conftest import REPO


@pytest.mark.cuda
def test_limb_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    proc = subprocess.run(
        [sys.executable, "paillier_bench/run.py", "--workload",
         "fl_2nn-8192", "--seed", str(2**31 + 5), "--seconds", "2",
         "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]

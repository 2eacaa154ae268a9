"""The control on the card at each cell's own size: the reference one
precision below the configuration (fp8 for its bfloat16 parts, TF32 for
its float32 parts) in the program's place must come out not correct.
Run on a machine with an NVIDIA GPU: python -m pytest portbench/tests -q"""

import json
import subprocess
import sys

import pytest

from harness.spec import REPO, benchmark

CELLS = [w["name"] for w in benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                          "--seed", "3141592653", "--seconds", "30", "--control", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=900, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["control"] and not result["correct"], result

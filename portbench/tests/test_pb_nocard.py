"""A measurement path that finds no card fails: it prints no result and
does not fall back to the CPU; nor does a checkout without the program."""

import shutil
import subprocess
import sys

import pytest

from harness import device
from harness.spec import REPO


def test_require_cards_refuses_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.NoCard):
        device.require_cards(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(device.NoCard):
        device.require_cards(4)


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "fs2v1.batch",
                           "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_the_command_without_a_card_prints_no_result():
    out = _run(REPO)
    assert out.returncode == 2, out.stderr
    assert '"correct"' not in out.stdout


def test_a_checkout_of_only_the_benchmark_fails(tmp_path, monkeypatch):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    import torch

    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout

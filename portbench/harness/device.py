"""The card, the process, and what a run may load.

A measurement path that finds no card fails: nothing here falls back to
the CPU.  The JAX package and JAX itself may not be loaded by a run; the
check compares each module's top-level name whole (``emotts_torch`` is the
port, ``emotts`` the JAX package)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from harness.spec import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "emotts")


class NoCard(RuntimeError):
    pass


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start / ticks


def pin_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    so that only a checkout's first run builds.  The port's own kernels
    build into ``emotts_torch/build/`` there already; these cover PyTorch's
    extension and Triton caches should anything use them."""
    cache = REPO / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def require_cards(n: int):
    """The torch module, once ``n`` CUDA cards are visible; raises otherwise."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the card and does not run on the CPU")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} card(s), {torch.cuda.device_count()} visible")
    return torch


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unreadable: {e}"


def device_record(count: int) -> dict:
    import torch

    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".")[0] in FORBIDDEN})

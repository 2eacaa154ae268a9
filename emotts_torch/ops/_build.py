"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  The
libraries are built at first use into ``emotts_torch/build/`` (git-ignored),
named after a hash of the sources so that an edited source is rebuilt and a
finished build is reused.  Nothing here runs at import time, and nothing
falls back: a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
KERNEL_SOURCES = ("attention", "attention_bwd", "resblock", "mrf")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# what the last build of each library ran: {"cmd": [...], "seconds": s,
# "cached": bool} — read by chip_smoke.py for its build report
build_log: Dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    candidates = [
        os.path.join(os.environ.get(var, ""), "bin", "nvcc")
        for var in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(var)
    ]
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked at $CUDA_HOME, $CUDA_PATH, PATH and "
        "/usr/local/cuda): the CUDA kernels of emotts_torch are compiled "
        "from source at first use and need the CUDA toolkit"
    )


def _source_digest(name: str) -> str:
    h = hashlib.sha1()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"libemotts_{name}_{_source_digest(name)}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path,
    command, start time) or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        build_log[name] = {"cmd": None, "seconds": 0.0, "cached": True}
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, cmd, time.perf_counter()


def _finish_build(name: str, started) -> None:
    proc, tmp, out, cmd, t0 = started
    output, _ = proc.communicate()
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise KernelBuildError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{output}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    build_log[name] = {
        "cmd": cmd, "seconds": time.perf_counter() - t0, "cached": False,
    }


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, dict]:
    """Build every named library, all compilers started together."""
    with _lock:
        names = list(names)
        started: List = [(n, _start_build(n)) for n in names]
        errors = []
        for n, s in started:
            if s is None:
                continue
            try:
                _finish_build(n, s)
            except KernelBuildError as e:  # let the other compilers finish
                errors.append(e)
        if errors:
            raise errors[0]
        return {n: build_log[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            started = _start_build(name)
            if started is not None:
                _finish_build(name, started)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero return of a kernel's C entry point."""
    if code == 0:
        return
    names = {1001: "shape or size the kernel does not take",
             1002: "tile does not fit in shared memory",
             1003: "tensor data not 16-byte aligned",
             1004: "TMA tensor map could not be made"}
    if code in names:
        raise RuntimeError(f"{what}: {names[code]} (code {code})")
    raise RuntimeError(f"{what}: CUDA error {code} at launch")

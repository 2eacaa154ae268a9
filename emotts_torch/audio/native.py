"""ctypes bindings for the native (C++) preprocessing components.

Own copy of ``emotts/audio/native.py``: it loads the same
``native/libemotts_native.so`` (built from ``native/`` with ``make -C
native``), found by path from this file's location.  The library provides:
* WORLD-style DIO+StoneMask F0 — the production path for the reference's
  pyworld dependency (rank_model/audio_util.py:16-20);
* a fast TextGrid interval-tier parser;
* the DTW path of the evaluation metrics.

All three have numpy mirrors (``emotts_torch.audio.f0``,
``emotts_torch.audio.textgrid``, ``emotts_torch.eval.metrics``);
``have_native()`` / ``have_native_dtw()`` say whether the library loaded,
and the callers take the mirrors where it did not.  These are host
routines: nothing here runs on the GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libemotts_native.so"
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.emotts_f0_num_frames.restype = ctypes.c_int64
    lib.emotts_f0_num_frames.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_double]
    lib.emotts_dio_stonemask.restype = ctypes.c_int64
    lib.emotts_dio_stonemask.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # x
        ctypes.c_int64,  # n
        ctypes.c_int,  # fs
        ctypes.c_double,  # frame_period
        ctypes.c_double,  # f0_floor
        ctypes.c_double,  # f0_ceil
        ctypes.c_double,  # channels_in_octave
        ctypes.c_double,  # allowed_range
        ctypes.POINTER(ctypes.c_double),  # f0_out
        ctypes.c_int64,  # max_frames
    ]
    lib.emotts_parse_textgrid.restype = ctypes.c_int64
    lib.emotts_parse_textgrid.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    if hasattr(lib, "emotts_dtw_path"):  # absent in pre-round-2 builds
        lib.emotts_dtw_path.restype = ctypes.c_int64
        lib.emotts_dtw_path.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # cost (t1*t2 row-major)
            ctypes.c_int64,  # t1
            ctypes.c_int64,  # t2
            ctypes.POINTER(ctypes.c_int32),  # path_i out
            ctypes.POINTER(ctypes.c_int32),  # path_j out
            ctypes.c_int64,  # max_path
        ]
    _lib = lib
    return lib


def have_native_dtw() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "emotts_dtw_path")


def dtw_path_native(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal-cost monotonic DTW path via the C++ extension.

    Same contract as emotts_torch.eval.metrics.dtw_path: (idx_ref, idx_syn)."""
    lib = _load()
    if lib is None or not hasattr(lib, "emotts_dtw_path"):
        raise RuntimeError("native DTW not built (run `make -C native`)")
    c = np.ascontiguousarray(cost, dtype=np.float64)
    t1, t2 = c.shape
    max_path = t1 + t2
    pi = np.empty(max_path, dtype=np.int32)
    pj = np.empty(max_path, dtype=np.int32)
    n = lib.emotts_dtw_path(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        t1,
        t2,
        pi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pj.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_path,
    )
    if n < 0:
        raise RuntimeError("native DTW failed")
    return pi[:n].astype(np.int64), pj[:n].astype(np.int64)


def build_native(verbose: bool = False) -> bool:
    """Invoke make to build the shared library; returns success."""
    native_dir = _LIB_PATH.parent
    try:
        result = subprocess.run(
            ["make", "-C", str(native_dir)], capture_output=True, text=True
        )
        if verbose and result.stdout:
            print(result.stdout)
        if result.returncode != 0 and verbose:
            print(result.stderr)
        return result.returncode == 0 and _LIB_PATH.exists()
    except OSError:
        return False


def have_native() -> bool:
    return _load() is not None


def extract_f0_native(
    y: np.ndarray,
    hop_length: int,
    sampling_rate: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    channels_in_octave: float = 2.0,
    allowed_range: float = 0.1,
) -> np.ndarray:
    """Hop-aligned DIO+StoneMask F0 via the C++ extension."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (run `make -C native`)")
    x = np.ascontiguousarray(y, dtype=np.float64)
    frame_period = hop_length / sampling_rate * 1000.0
    max_frames = int(len(x) / sampling_rate * 1000.0 / frame_period) + 2
    out = np.zeros(max_frames, dtype=np.float64)
    n = lib.emotts_dio_stonemask(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(x),
        sampling_rate,
        frame_period,
        f0_floor,
        f0_ceil,
        channels_in_octave,
        allowed_range,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_frames,
    )
    if n < 0:
        raise RuntimeError("native F0 extraction failed")
    return out[:n]


def parse_textgrid_native(
    path: str, tier_name: str = "phones", max_intervals: int = 4096
) -> Optional[List[Tuple[float, float, str]]]:
    """Parse one interval tier; returns [(start, end, label)] or None."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (run `make -C native`)")
    starts = np.zeros(max_intervals, dtype=np.float64)
    ends = np.zeros(max_intervals, dtype=np.float64)
    labels_buf = ctypes.create_string_buffer(max_intervals * 64)
    n = lib.emotts_parse_textgrid(
        path.encode(),
        tier_name.encode(),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        labels_buf,
        len(labels_buf),
        max_intervals,
    )
    if n < 0:
        return None
    labels = labels_buf.value.decode(errors="replace").split("\n")[:n]
    return [(float(starts[i]), float(ends[i]), labels[i]) for i in range(n)]

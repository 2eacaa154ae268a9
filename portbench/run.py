#!/usr/bin/env python3
"""The benchmark of ``emotts_torch`` on NVIDIA GPUs.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card: builds the program from
its configuration with weights made from the seed, warms the cell's
shapes, measures ``--seconds`` of its traffic, then compares a sample of
what the window produced with the plain reference.  The last line of
standard output is the result as one JSON object: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics read
from a profiled stretch of the window.  The numbers compared are printed
last on standard error and last in the result, each beside its limit.
An earlier line names the card and its power limit.

``--control 1`` runs no window: the reference one precision below the
configuration answers in the program's place, and the comparison's
readings are printed (it must come out not correct).

Exit codes: 0 with a result; 2 with no card, or fewer than the cell asks
for; 3 when a forbidden module was loaded (JAX, or the JAX package).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]  # the harness, and the checkout's program

from harness import device as dev  # noqa: E402
from harness import spec  # noqa: E402
from harness.trace import Stretch  # noqa: E402

PROCESS_AGE = dev.process_age_s()
CLOCK_AT_START = time.perf_counter()
CELL_START = [CLOCK_AT_START]  # when the cell's own set-up began (after the build)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def checks(readings: dict, limits: dict) -> dict:
    """Every number compared, with its limit: limits the cell's file sets
    for each reading it knows; a reading without one is reported only."""
    out = {}
    for name, value in readings.items():
        if name in limits:
            out[name] = {"value": value, "limit": limits[name]}
    missing = set(limits) - set(readings)
    if missing:
        raise KeyError(f"the comparison gave no reading for {sorted(missing)}")
    return out


def refuse_forbidden() -> None:
    """Raises where JAX or the JAX package has been loaded into this process."""
    found = dev.forbidden_modules()
    if found:
        raise ImportError(f"modules loaded that a run may not load: {found}")


def layer_metrics(cell, ctx) -> dict:
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(args, cell, torch, device="cuda"):
    """One run of the cell: the window, then the comparison.  ``device``
    is the card; the tests drive the rest of a run on the CPU."""
    CELL_START[0] = time.perf_counter()
    kind, model = cell.kind(), cell.model()
    stretch = Stretch() if args.trace else None
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = kind.run(cell, args.seed, args.seconds, stretch, device)
    setup_s = PROCESS_AGE + (out["t0"] - CLOCK_AT_START)
    record = dev.device_record(cell.chips) if device == "cuda" else {"platform": "cpu"}
    system = out["system"]
    counters = {**system.counters(), **out.get("counters", {})}
    bounds = system.kernel_bounds() if args.trace else {}
    trace = stretch.read() if args.trace else None
    system.release()
    t_ref = time.perf_counter()
    readings = model.check(cell, out)
    t_ref = time.perf_counter() - t_ref
    readings["failed"] = out["failed"]
    compared = checks(readings, {**cell.params["limits"], "failed": 0})
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if args.trace:
        traced = (stretch.end - stretch.begin) if stretch.done else 0.0
        ctx = SimpleNamespace(trace=trace, counters=counters, bounds=bounds,
                              window={"wall_s": out["wall_s"], "untraced_s": out["wall_s"] - traced})
        result["metrics"] = layer_metrics(cell, ctx)
        if trace is not None:
            record["busy_s"], record["window_s"] = trace.busy_s, trace.window_s
    else:
        result["metrics"] = {
            m["name"]: {"value": setup_s if m["name"] == "setup_s" else out["metrics"][m["name"]],
                        "unit": m["unit"]} for m in cell.end_to_end}
    result["device"] = record
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = compared
    refuse_forbidden()  # the comparison and the readers have run since the window closed
    info = {"window": {k: v for k, v in out.items() if k in ("wall_s", "notes")},
            "setup_s": setup_s, "before_cell_s": PROCESS_AGE + (CELL_START[0] - CLOCK_AT_START),
            "reference_s": t_ref, "readings": readings}
    if trace is not None:
        info["trace"] = {"kernels": trace.kernel_count(), "launch_links": trace.launched_share,
                         "bounds": bounds}
    return result, info


def control(args, cell) -> int:
    readings = cell.model().control_check(cell, args.seed, args.seconds, "cuda")
    limits = cell.params["limits"]
    compared = checks(readings, limits)
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    refuse_forbidden()
    print(json.dumps({"control": True, "correct": correct, "readings": readings,
                      "checks": compared}))
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = spec.Cell(args.workload)
        dev.pin_caches()
        torch = dev.require_cards(cell.chips)
    except (dev.NoCard, ImportError, KeyError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"card": dev.card_line(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    from emotts_torch.ops import _build

    build = _build.build_all()
    print(json.dumps({"build": {k: v["seconds"] for k, v in build.items()}}), flush=True)
    try:
        if args.control:
            return control(args, cell)
        result, info = measure(args, cell, torch)
    except ImportError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    print(json.dumps(info), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

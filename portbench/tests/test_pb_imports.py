"""What a run and the reference may load: no module whose top-level name
is jax, jaxlib, flax or emotts (compared whole: emotts_torch is the port);
the reference loads nothing of emotts_torch either."""

import json
import subprocess
import sys

from harness.device import FORBIDDEN, forbidden_modules
from harness.spec import REPO, ROOT


def test_names_are_compared_whole():
    assert forbidden_modules({"emotts_torch": 0, "emotts_torch.nn": 0, "emottsx": 0}) == []
    assert forbidden_modules({"emotts.nn": 0, "jax": 0, "flax.linen": 0, "jaxlib": 0}) == [
        "emotts.nn", "flax.linen", "jax", "jaxlib"]


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_on_the_cpu_loads_none_of_them():
    code = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}, {str(REPO)!r}, {str(ROOT / 'tests')!r}]\n"
            "import torch, run, tiny\n"
            "args = run.parse(['--workload', 'fs2v1.batch', '--seed', '5', '--seconds', '0.5'])\n"
            "run.measure(args, tiny.cell('fs2v1.batch'), torch, device='cpu')\n"
            "print(json.dumps(sorted(sys.modules)))")
    loaded = _modules_after(code)
    assert "emotts_torch" in loaded
    assert not {m.split(".")[0] for m in loaded} & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n"
            "import reference.fs2, reference.hifigan, reference.rank, reference.g2p, reference.philox\n"
            "print(json.dumps(sorted(sys.modules)))")
    top = {m.split(".")[0] for m in _modules_after(code)}
    assert not top & (set(FORBIDDEN) | {"emotts_torch", "harness"})


def test_a_reader_that_loads_the_jax_package_stops_the_result(tmp_path):
    """A per-layer reader runs after the window has closed; what it loads
    is caught before the result is made (a fake ``emotts.x`` stands in)."""
    fake = tmp_path / "fake" / "emotts"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text("")
    (fake / "x.py").write_text("")
    (tmp_path / "leaky.py").write_text("import emotts.x\n\n\ndef read(ctx):\n    return 1.0\n")
    code = (f"import sys; sys.path[:0] = [{str(tmp_path / 'fake')!r}, {str(tmp_path)!r}, "
            f"{str(ROOT)!r}, {str(REPO)!r}, {str(ROOT / 'tests')!r}]\n"
            "import importlib, torch, run, tiny\n"
            "from harness import spec\n"
            "cell = tiny.cell('fs2v1.batch')\n"
            "cell.per_layer = cell.per_layer + [{'name': 'leaky', 'unit': '%'}]\n"
            "found = spec.reader\n"
            "spec.reader = lambda m: importlib.import_module(m) if m == 'leaky' else found(m)\n"
            "args = run.parse(['--workload', 'fs2v1.batch', '--seed', '6', '--seconds', '0.5', "
            "'--trace', '1'])\n"
            "try:\n"
            "    run.measure(args, cell, torch, device='cpu')\n"
            "except ImportError as e:\n"
            "    print('refused', e)\n"
            "else:\n"
            "    print('result')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1].startswith("refused"), out.stdout + out.stderr
    assert "emotts.x" in out.stdout

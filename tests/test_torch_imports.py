"""The port stands on its own: no module under emotts_torch/, and not
chip_smoke.py, imports jax, flax, optax, orbax or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "emotts"}
SOURCES = sorted((ROOT / "emotts_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_there_are_sources_to_check():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert len(SOURCES) > 40
    for needed in ("chip_smoke.py", "emotts_torch/ops/attention.py",
                   "emotts_torch/infer/server.py", "emotts_torch/text/g2p.py",
                   "emotts_torch/train/rank_trainer.py", "emotts_torch/train/state.py",
                   "emotts_torch/train/checkpoint.py", "emotts_torch/data/loader.py",
                   "emotts_torch/data/datasets.py", "emotts_torch/losses/rank.py",
                   "emotts_torch/infer/bucketize.py", "emotts_torch/nn/intensity.py",
                   "emotts_torch/losses/fs2.py", "emotts_torch/data/splits.py",
                   "emotts_torch/train/fs2_trainer.py",
                   "emotts_torch/infer/streaming.py", "emotts_torch/audio/mel.py",
                   "emotts_torch/audio/f0.py", "emotts_torch/audio/native.py",
                   "emotts_torch/data/preprocess.py", "emotts_torch/cli/prepare_corpus.py",
                   "emotts_torch/eval/evaluate.py", "emotts_torch/eval/intensity_eval.py",
                   "emotts_torch/eval/metrics.py", "emotts_torch/nn/hifigan_disc.py",
                   "emotts_torch/losses/gan.py", "emotts_torch/train/vocoder_trainer.py"):
        assert needed in names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_source_imports_nothing_of_jax(path):
    bad = [(name, line) for name, line in _imported_roots(path) if name in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"


def test_importing_the_package_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import emotts_torch\n"
        "for m in pkgutil.walk_packages(emotts_torch.__path__, 'emotts_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'emotts'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean', len([m for m in sys.modules if m.startswith('emotts_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=300,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_eval_and_preprocess_import_without_sklearn_or_matplotlib(monkeypatch):
    """The GPU machine has neither: the silhouette's scikit-learn stays
    behind a lazy import, and the report reads None there."""
    import importlib

    import numpy as np

    for name in list(sys.modules):
        if name.startswith(("emotts_torch.eval", "emotts_torch.data.preprocess")):
            monkeypatch.delitem(sys.modules, name)
    for name in ("sklearn", "matplotlib"):
        monkeypatch.setitem(sys.modules, name, None)  # import → ImportError
    importlib.import_module("emotts_torch.data.preprocess")
    ie = importlib.import_module("emotts_torch.eval.intensity_eval")
    importlib.import_module("emotts_torch.eval")
    from emotts_torch.utils.config import Config

    cfg = Config()
    cfg.data.speakers, cfg.data.emotions = ["a"], ["neutral", "amused", "angry"]
    ev = object.__new__(ie.IntensityEfficacyEvaluator)
    ev.cfg = cfg
    rows = [dict(text_i=0, spk=0, emo=e, level=float(lv), score=float(e + lv))
            for e in (1, 2) for lv in (0, 1, 2)]
    report = ev._metrics(rows, np.eye(6, 3, dtype=np.float32), [0.0, 1.0, 2.0])
    assert report["emotion_silhouette_h"] is None
    assert report["monotonic_fraction_strict"] == 1.0


def test_kernel_sources_are_hand_written_cuda():
    csrc = ROOT / "emotts_torch" / "csrc"
    names = {p.name for p in csrc.iterdir()}
    assert {"attention.cu", "attention_bwd.cu", "resblock.cu", "mrf.cu"} <= names
    for path in csrc.glob("*.cu*"):
        text = path.read_text()
        for library in ("cublas", "cudnn", "cutlass", "<torch", "ATen"):
            assert library not in text, f"{path.name} mentions {library}"
    for name, entry in (("attention", "emotts_attention_fwd"),
                        ("attention_bwd", "emotts_attention_bwd"),
                        ("resblock", "emotts_resblock1"),
                        ("mrf", "emotts_mrf_stage")):
        text = (csrc / f"{name}.cu").read_text()
        assert "__global__" in text and f'extern "C" int {entry}' in text

"""The port's command (emotts_torch/cli/main.py) on the CPU with
``--device cpu``, and its plotting helpers (emotts_torch/utils/plotting.py).

* Against the JAX package's command: the same reference checkpoints (the
  SpeechBrain-layout FastSpeech2 and the rank model of
  tests/test_reference_import.py, a weight-normed HiFi-GAN .pt, an
  intensity.npy) through both CLIs' import-reference, convert-vocoder and
  synthesize --text-file in fp32 give wavs within tests/test_torch_synthesize.py's
  PCM_STEPS; g2p prints the same lines.
* The port's chain at toy widths (as tests/test_cli_pipeline.py sets them):
  every other command, each artifact read back, and one ``serve`` as a
  subprocess.
* Exit code 2 on bad arguments, and without a GPU unless --device cpu.
"""

import contextlib
import io
import json
import select
import subprocess
import sys
import time
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from emotts.cli.main import main as jax_main
from emotts.utils import plotting as jax_plotting
from emotts.utils.config import Config as JaxConfig
from emotts.utils.config import save_config as jax_save_config
from emotts_torch.cli.main import DEVICE_COMMANDS, main
from emotts_torch.utils import plotting
from emotts_torch.utils.config import Config, save_config
from tests import test_reference_import as ref
from tests.synthetic_corpus import make_corpus
from tests.test_cli_prepare_convert import _make_emovdb
from tests.torch_port_util import (single_torch_thread,  # noqa: F401
                                   weight_normed_hifigan)

ROOT = Path(__file__).resolve().parents[1]
PCM_STEPS = 1  # tests/test_torch_synthesize.py: int16 steps between the packages
STORY = "The ship was quiet tonight. Nobody had slept for two days!"


def _pcm(path):
    with wave.open(str(path), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


def _run(argv):
    """(exit code, standard output) of the port's command."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


# ---------------------------------------------------------------------------
# the same reference checkpoints through both commands
# ---------------------------------------------------------------------------


def _reference_config(root: Path) -> JaxConfig:
    """The compat FastSpeech2 at tests/test_reference_import.py's toy width,
    8 mel bins and a hop of 4 samples (the toy vocoder's upsampling), fp32."""
    cfg = JaxConfig()
    cfg.data.speakers = ["a", "b"][:ref.N_SPK]
    cfg.data.emotions = ["neutral", "amused", "angry"][:ref.N_EMO]
    cfg.data.experiment_path = str(root / "experiments")
    cfg.audio.n_mels = ref.N_MELS
    cfg.audio.hop_length = 4
    r = cfg.rank_model
    r.n_encoder_layers, r.hidden_dim, r.ffn_mult, r.n_heads = 1, 16, 2, 2
    f = cfg.fastspeech2
    f.n_char = 95  # the phone vocabulary (89 tokens) with its headroom
    f.n_mels = ref.N_MELS
    f.enc_num_layers = f.dec_num_layers = ref.LAYERS
    f.enc_num_head = f.dec_num_head = ref.HEADS
    f.enc_d_model = f.dec_d_model = ref.D
    f.enc_ffn_dim = f.dec_ffn_dim = ref.FFN
    f.postnet_embedding_dim = ref.PN_DIM
    f.postnet_n_convolutions = ref.PN_CONVS
    f.max_mel_len = 64
    f.intensity_dim = ref.N_EMO
    f.prenet_style, f.postnet_style = "embedding", "speechbrain"
    cfg.bucketing.phone_buckets = [32, 64]
    cfg.mesh.data_parallel = 1
    cfg.train_fs2.compute_dtype = "float32"
    cfg.inference.rank_exp = cfg.inference.fs2_exp = "imported"
    cfg.inference.bucket_size = 3
    cfg.inference.neural_g2p = False
    cfg.inference.vocoder_checkpoint = str(root / "vocoder.npz")
    return cfg


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_reference")
    cfg = _reference_config(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "N_CHAR", cfg.fastspeech2.n_char)
        torch.manual_seed(2)
        fs2 = ref.SBFS2().state_dict()
    with torch.no_grad():  # about four frames a phone: a choice of weights
        fs2["durPred.linear.w.bias"].fill_(float(np.log1p(4.0)))
    files = dict(fs2=root / "fs2.pth", rank=root / "rank.pth",
                 bank=root / "intensity.npy", voc=root / "generator.pt",
                 text=root / "story.txt", cfg=root / "cfg.yaml")
    torch.save(fs2, files["fs2"])
    torch.save(ref._rank_reference_state_dict(cfg), files["rank"])
    np.save(files["bank"], np.random.default_rng(3).standard_normal(
        (ref.N_SPK, ref.N_EMO, 3, ref.N_EMO)).astype(np.float32))
    torch.save(weight_normed_hifigan(seed=4), files["voc"])
    files["text"].write_text(STORY)
    jax_save_config(cfg, str(files["cfg"]))

    wavs = {}
    for name, run, extra in (("jax", jax_main, []), ("port", main, ["--device", "cpu"])):
        out = root / name
        common = ["--config", str(files["cfg"]), *extra,
                  f"data.experiment_path={out / 'experiments'}",
                  f"inference.output_path={out / 'wavs'}",
                  f"inference.vocoder_checkpoint={out / 'vocoder.npz'}"]
        assert run(["import-reference", *common,
                    "--rank-checkpoint", str(files["rank"]),
                    "--fs2-checkpoint", str(files["fs2"]),
                    "--intensity", str(files["bank"])]) == 0
        assert run(["convert-vocoder", *common, "--checkpoint", str(files["voc"]),
                    "--output", str(out / "vocoder.npz")]) == 0
        assert run(["synthesize", *common, "--text-file", str(files["text"]),
                    "--speaker", "b", "--emotion", "amused", "--level", "1.5"]) == 0
        wavs[name] = out / "wavs" / "longform_b_amused_1.5.wav"
    return root, files, wavs


def test_reference_checkpoints_synthesize_as_in_jax(reference):
    _, _, wavs = reference
    a, b = _pcm(wavs["jax"]), _pcm(wavs["port"])
    assert a.shape == b.shape and len(a) > 4 * 10  # frames of speech, not silence
    assert np.abs(a).max() > 0
    assert np.abs(a - b).max() <= PCM_STEPS


def test_imported_experiments_match(reference):
    """import-reference wrote the port's best/ exports and the bank."""
    root, files, _ = reference
    from emotts_torch.train.checkpoint import load_best_params

    exp = root / "port" / "experiments"
    fs2 = load_best_params(str(exp / "fastspeech2" / "imported"))
    rank = load_best_params(str(exp / "rank_model" / "imported"))
    assert "prenet.embed.weight" in fs2 and "projector.weight" in rank
    assert "projector.bias" not in rank
    np.testing.assert_array_equal(
        np.load(exp / "rank_model" / "imported" / "intensity.npy"),
        np.load(files["bank"]))
    with np.load(root / "jax" / "vocoder.npz") as a, \
            np.load(root / "port" / "vocoder.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_g2p_prints_the_same_lines(reference, capsys):
    _, files, _ = reference
    text = "Dr. Smith read 3 books on 12 May, didn't he?"
    assert jax_main(["g2p", "--config", str(files["cfg"]), "--text", text]) == 0
    want = capsys.readouterr().out
    assert main(["g2p", "--config", str(files["cfg"]), "--text", text]) == 0
    got = capsys.readouterr().out
    assert got == want and got.rstrip().splitlines()[-1].startswith("[g2p] ")


# ---------------------------------------------------------------------------
# the port's chain at toy widths
# ---------------------------------------------------------------------------


def _tiny(cfg, root: Path):
    """tests/test_cli_pipeline.py's toy widths, and the vocoder of the
    port's verify notes, on a Config of either package."""
    cfg.rank_model.n_encoder_layers = 1
    cfg.rank_model.hidden_dim = 32
    cfg.rank_model.ffn_mult = 2
    f = cfg.fastspeech2
    f.enc_num_layers = f.dec_num_layers = 1
    f.enc_d_model = f.dec_d_model = 32
    f.enc_ffn_dim = f.dec_ffn_dim = 64
    f.postnet_embedding_dim = 32
    f.postnet_n_convolutions = 3
    f.max_mel_len = 128
    cfg.train_rank.batch_size = cfg.train_fs2.batch_size = 4
    cfg.train_rank.n_epochs = cfg.train_fs2.n_epochs = 1
    cfg.train_rank.compute_dtype = cfg.train_fs2.compute_dtype = "float32"
    v = cfg.train_vocoder
    v.batch_size, v.segment_frames, v.upsample_initial_channel = 2, 8, 16
    v.resblock_kernel_sizes, v.resblock_dilations = [3], [[1, 3]]
    v.disc_channel_mult, v.mpd_periods, v.msd_scales = 0.05, [2], 1
    v.compute_dtype = "float32"
    cfg.inference.rank_exp = cfg.inference.fs2_exp = "exp_1"
    cfg.inference.bucket_size = 2
    cfg.inference.neural_g2p = False
    cfg.inference.output_path = str(root / "demo")
    cfg.inference.text = "hello world"
    cfg.inference.vocoder_checkpoint = str(
        Path(cfg.data.experiment_path) / "vocoder" / "exp_1" / "vocoder.npz")
    return cfg


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Every command of the chain once, in order: their exit codes and
    printed lines, by name."""
    root = tmp_path_factory.mktemp("torch_cli_chain")
    cfg = _tiny(make_corpus(str(root / "corpus"), utts_per_emotion=6), root)
    cfg_path = str(root / "cfg.yaml")
    jax_save_config(cfg, cfg_path)

    prep = Config()  # prepare-corpus over EmoV-DB's layout
    prep.data.data_path = str(_make_emovdb(root / "raw"))
    prep.data.corpus_path = str(root / "prepared")
    prep.data.speakers = ["bea", "josh"]
    prep_path = str(root / "prepare.yaml")
    save_config(prep, prep_path)

    (root / "story.txt").write_text(STORY)
    (root / "story.ssml").write_text(
        '<speak>Hello there. <emotion name="angry" level="2">Go away now.'
        '</emotion><break time="200ms"/>Goodbye.</speak>')
    dev = ["--config", cfg_path, "--device", "cpu"]
    steps = [
        ("prepare-corpus", ["prepare-corpus", "--config", prep_path]),
        ("preprocess", ["preprocess", *dev]),
        ("fs2-splits", ["fs2-splits", *dev]),
        ("train-rank", ["train-rank", *dev, "train_rank.profile_epoch=0"]),
        ("bucketize", ["bucketize", *dev]),
        ("train-vocoder", ["train-vocoder", *dev, "train_vocoder.n_steps=2"]),
        ("train-fs2", ["train-fs2", *dev]),
        ("sweep", ["synthesize", *dev]),
        ("stream", ["synthesize", *dev, "--text-file", str(root / "story.txt"),
                    "--stream", "--speaker", "spk_a", "--emotion", "amused",
                    "--level", "1.5"]),
        ("ssml", ["synthesize", *dev, "--ssml-file", str(root / "story.ssml"),
                  "--speaker", "spk_b"]),
        ("evaluate", ["evaluate", *dev, "--conditioning", "prototype",
                      "--contrast", "1.5"]),
        ("eval-intensity", ["eval-intensity", *dev, "--plot",
                            str(root / "sweep.png")]),
    ]
    runs = {}
    for name, argv in steps:
        runs[name] = _run(argv)
        assert runs[name][0] == 0, (name, runs[name][1])
    exp = Path(cfg.data.experiment_path)
    return dict(root=root, cfg=cfg, cfg_path=cfg_path, runs=runs,
                rank=exp / "rank_model" / "exp_1", fs2=exp / "fastspeech2" / "exp_1",
                vocoder=exp / "vocoder" / "exp_1")


def test_prepare_and_preprocess(chain):
    root, runs = chain["root"], chain["runs"]
    assert "[prepare] wrote 6 corpus utterances" in runs["prepare-corpus"][1]
    assert len(list((root / "prepared").glob("*/*.lab"))) == 6
    assert runs["preprocess"][1].startswith("[preprocess] ")
    assert list(Path(chain["cfg"].data.preprocessed_path).glob("*/*.npz"))
    assert "[fs2-splits]" in runs["fs2-splits"][1]


def test_rank_training_artifacts(chain):
    rank = chain["rank"]
    assert (rank / "best").is_dir() and (rank / "intensity.npy").exists()
    bank = np.load(rank / "intensity.npy")
    assert bank.shape == (2, 3, 2, 3) and np.isfinite(bank).all()
    # train_rank.profile_epoch=0: epoch 0 under torch.profiler
    trace = json.loads((rank / "profile" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
    assert (rank / "tsne_epoch_0.png").stat().st_size > 0


def test_fs2_and_vocoder_training_artifacts(chain):
    fs2, voc = chain["fs2"], chain["vocoder"]
    assert (fs2 / "best").is_dir()
    assert (fs2 / "mels" / "valid_epoch_0.png").stat().st_size > 0
    assert list((fs2 / "wavs").glob("epoch_0_sample_1_*.wav"))  # vocoded samples
    with np.load(voc / "vocoder.npz") as z:
        assert "conv_pre_kernel" in z.files


def test_synthesis_modes(chain):
    cfg, runs = chain["cfg"], chain["runs"]
    out = Path(cfg.inference.output_path)
    assert "wrote 12 items" in runs["sweep"][1]
    assert "time-to-first-audio" in runs["stream"][1]
    for name in ("longform_spk_a_amused_1.5.wav", "ssml.wav"):
        pcm = _pcm(out / name)
        assert len(pcm) > 0


def test_evaluation_reports(chain, tmp_path):
    fs2, root = chain["fs2"], chain["root"]
    report = json.loads((fs2 / "eval.json").read_text())
    assert report["conditioning"] == "prototype" and report["contrast"] == 1.5
    assert report["n_utterances"] > 0
    assert "mcd_teacher_forced" in report["overall"]
    assert "pairwise_order_accuracy" in report["intensity_efficacy"]
    assert (fs2 / "intensity_eval.json").exists()
    assert (root / "sweep.png").stat().st_size > 0


def test_serve_as_a_subprocess(chain, tmp_path):
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "emotts_torch.cli.main", "serve", "--config",
         chain["cfg_path"], "--device", "cpu", "--port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=log, text=True)
    try:
        deadline = time.monotonic() + 120
        line = ""
        while "[serve] listening on" not in line:
            ready, _, _ = select.select([proc.stdout], [], [], 1.0)
            assert time.monotonic() < deadline and proc.poll() is None, \
                (tmp_path / "serve.log").read_text()
            if ready:
                line = proc.stdout.readline()
        base = line.split("listening on ")[1].split()[0]
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        req = urllib.request.Request(
            base + "/synthesize",
            data=json.dumps({"text": "hello world", "speaker": "spk_b",
                             "emotion": "angry"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
        assert body[:4] == b"RIFF" and len(body) > 44
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    assert proc.returncode is not None


# ---------------------------------------------------------------------------
# exit code 2
# ---------------------------------------------------------------------------


def test_overrides_on_either_side_of_the_options():
    """a.b=c overrides after the command, between and after its options
    (argparse's intermixed parsing: a plain parse takes them only in one
    place, and on some Python 3.12 releases in none after an option)."""
    from emotts_torch.cli.main import _parse

    args = _parse(["train-rank", "a.b=1", "--device", "cpu", "c.d=2",
                   "--config", "cfg.yaml", "e.f=3"])
    assert args.command == "train-rank" and args.device == "cpu"
    assert args.config == "cfg.yaml" and args.overrides == ["a.b=1", "c.d=2", "e.f=3"]


def test_convert_vocoder_without_arguments(tmp_path):
    save_config(Config(), str(tmp_path / "cfg.yaml"))
    assert main(["convert-vocoder", "--config", str(tmp_path / "cfg.yaml")]) == 2


def test_import_reference_refuses_the_default_architecture(tmp_path):
    cfg = Config()
    cfg.data.experiment_path = str(tmp_path / "experiments")
    save_config(cfg, str(tmp_path / "cfg.yaml"))
    torch.save({}, tmp_path / "fs2.pth")
    assert main(["import-reference", "--config", str(tmp_path / "cfg.yaml"),
                 "--fs2-checkpoint", str(tmp_path / "fs2.pth")]) == 2
    assert not (tmp_path / "experiments").exists()


def test_text_file_needs_a_speaker(chain, capsys):
    rc = main(["synthesize", "--config", chain["cfg_path"], "--device", "cpu",
               "--text-file", str(chain["root"] / "story.txt"),
               "--emotion", "amused"])
    assert rc == 2 and "requires --speaker" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    *([c] for c in sorted(DEVICE_COMMANDS)),
    ["preprocess", "data.device_mel=true"],
], ids=" ".join)
def test_no_gpu_needs_device_cpu(argv, tmp_path, capsys, monkeypatch):
    """Without a GPU (here monkeypatched away on any machine), a command
    that computes refuses to run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    save_config(Config(), str(tmp_path / "cfg.yaml"))
    rc = main([argv[0], "--config", str(tmp_path / "cfg.yaml"), *argv[1:]])
    assert rc == 2 and "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("device,device_mel,want", [
    ("cuda", False, True), ("cpu", False, False), ("cpu", True, True),
])
def test_preprocess_takes_the_device_mel_on_the_card(device, device_mel, want,
                                                     tmp_path, monkeypatch):
    """``preprocess`` computes the mel on the card whenever ``--device`` is
    cuda; on the CPU ``data.device_mel`` decides (GPU faked, work stubbed)."""
    import emotts_torch.data.preprocess as P
    import emotts_torch.data.splits as S

    asked = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(P, "preprocess_all",
                        lambda cfg, device_mel, device: asked.update(
                            device_mel=device_mel, device=device) or {})
    monkeypatch.setattr(S, "build_rank_pair_lists", lambda cfg: ([], []))
    save_config(Config(), str(tmp_path / "cfg.yaml"))
    rc, _ = _run(["preprocess", "--config", str(tmp_path / "cfg.yaml"),
                  "--device", device, f"data.device_mel={str(device_mel).lower()}"])
    assert rc == 0 and asked == dict(device_mel=want, device=device)


# ---------------------------------------------------------------------------
# plotting
# ---------------------------------------------------------------------------


def _plot_cases():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((24, 6)).astype(np.float32)
    emotions, speakers = np.arange(24) % 3, np.arange(24) % 2
    mel = rng.standard_normal((8, 40)).astype(np.float32)
    report = {"levels": [0, 1, 2], "pairwise_order_accuracy": 0.75,
              "verdict": "works", "by_cell": {
                  "a/amused": {"score_mean_per_level": [0.1, 0.4, 0.9]},
                  "b/angry": {"score_mean_per_level": [0.3, 0.2, 0.6],
                              "monotone_strict": False}}}
    stats = {"pitch": [-2.0, 2.0, 150.0, 30.0], "energy": [-2.0, 2.0, 1.0, 0.5]}
    return {
        "plot_melspectrogram": lambda m, p: m.plot_melspectrogram(mel, p),
        "plot_mel_grid": lambda m, p: m.plot_mel_grid(
            rng.standard_normal((3, 40, 8)), rng.standard_normal((3, 40, 8)), p),
        "plot_tsne": lambda m, p: m.plot_tsne(
            feats, emotions, speakers, None, ["n", "a", "b"], ["s0", "s1"],
            m.DEFAULT_COLORS, m.DEFAULT_MARKERS, p),
        "plot_features": lambda m, p: m.plot_features(
            mel, rng.standard_normal(40), rng.standard_normal(40), stats, p),
        "plot_intensity_sweep": lambda m, p: m.plot_intensity_sweep(report, p),
    }


@pytest.mark.parametrize("name", sorted(_plot_cases()))
def test_plot_writes_a_png_where_jax_does(name, tmp_path):
    draw = _plot_cases()[name]
    draw(jax_plotting, str(tmp_path / "jax.png"))
    assert (tmp_path / "jax.png").stat().st_size > 0
    assert draw(plotting, str(tmp_path / "port.png")) is True
    png = (tmp_path / "port.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 1000


@pytest.mark.parametrize("name", sorted(_plot_cases()))
def test_plot_returns_false_without_matplotlib(name, tmp_path, monkeypatch, capsys):
    for mod in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, mod, None)
    assert _plot_cases()[name](plotting, str(tmp_path / "x.png")) is False
    assert not (tmp_path / "x.png").exists()
    assert not plotting.have_matplotlib()
    if name != "plot_tsne":
        assert capsys.readouterr().err.count("\n") == 1


def test_tsne_returns_false_without_scikit_learn(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    assert _plot_cases()["plot_tsne"](plotting, str(tmp_path / "x.png")) is False


def test_eval_intensity_plot_needs_matplotlib(chain, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = chain["root"] / "no_plot"
    rc = main(["eval-intensity", "--config", chain["cfg_path"], "--device", "cpu",
               "--plot", str(out / "sweep.png"),
               f"inference.output_path={out}"])
    assert rc == 2 and "matplotlib" in capsys.readouterr().err

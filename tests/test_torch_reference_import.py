"""The port's reference-checkpoint importers (emotts_torch/nn/convert.py::
rank_params_from_torch, fs2_params_from_reference_torch, torch_state_dict;
emotts_torch/nn/hifigan.py::convert_torch_state_dict; .pt vocoders in
load_vocoder_checkpoint) held against the JAX package's on the CPU.

The reference-layout state_dicts come from tests/test_reference_import.py's
stand-ins (SBFS2: SpeechBrain's module names; _rank_reference_state_dict),
weight-normed HiFi-GAN generators from tests/torch_port_util.py.  The trees
must equal the JAX package's exactly (same keys, np.array_equal); the
imported models run at the tolerances of their own parity tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emotts.cli.main import main as jax_main
from emotts.infer.synthesize import load_vocoder_checkpoint as jax_load_vocoder
from emotts.nn import convert as jax_convert
from emotts.nn.fastspeech2 import FastSpeech2 as JaxFastSpeech2
from emotts.nn.hifigan import HiFiGANGenerator as JaxGenerator
from emotts.nn.hifigan import convert_torch_state_dict as jax_convert_hifigan
from emotts.utils.config import Config as JaxConfig
from emotts.utils.config import save_config as jax_save_config
from emotts_torch.cli.main import main
from emotts_torch.nn import convert
from emotts_torch.nn.fastspeech2 import FastSpeech2
from emotts_torch.nn.hifigan import HiFiGANGenerator, convert_torch_state_dict
from emotts_torch.nn.intensity import RankModel
from emotts_torch.utils.config import Config, FastSpeech2Config
from tests import test_reference_import as ref
from tests.torch_port_util import (jit, single_torch_thread,  # noqa: F401
                                   weight_normed_hifigan)

# tests/test_torch_fastspeech2.py's tolerance for this architecture in fp32
TOL = dict(rtol=1e-4, atol=1e-4)
VOCODER_TOL = dict(rtol=1e-5, atol=1e-5)
# the plain-torch spellings every tolerant lookup also accepts
# (tests/test_reference_import.py::test_key_tolerance_plain_layout)
PLAIN_KEYS = {
    ".w.weight": ".weight", ".w.bias": ".bias",
    ".conv.weight": ".weight", ".conv.bias": ".bias",
    ".Embedding.weight": ".weight",
    ".norm.weight": ".weight", ".norm.bias": ".bias",
    ".self_att.att.": ".self_attn.",
}


def assert_same_tree(a, b, path=""):
    """Same keys at every level and equal arrays (dtype and shape too)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert np.array_equal(a, b), path


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def sb_fs2():
    torch.manual_seed(0)
    return _numpy(ref.SBFS2().state_dict())


def _plain_layout(sd):
    out = {}
    for k, v in sd.items():
        for old, new in PLAIN_KEYS.items():
            k = k.replace(old, new)
        out[k] = v
    return out


@pytest.mark.parametrize("layout", ["speechbrain", "plain"])
def test_fs2_import_tree_equals_jax(sb_fs2, layout):
    sd = sb_fs2 if layout == "speechbrain" else _plain_layout(sb_fs2)
    jcfg = ref.compat_config()
    want = jax_convert.fs2_params_from_reference_torch(sd, jcfg)
    got = convert.fs2_params_from_reference_torch(
        sd, FastSpeech2Config(**dataclasses.asdict(jcfg)))
    assert got["batch_stats"] == {}
    assert_same_tree(want, got)


def test_fs2_import_names_the_missing_key(sb_fs2):
    sd = {k: v for k, v in sb_fs2.items() if not k.startswith("speaker_emb")}
    cfg = FastSpeech2Config(**dataclasses.asdict(ref.compat_config()))
    with pytest.raises(KeyError, match="speaker_emb"):
        convert.fs2_params_from_reference_torch(sd, cfg)


def test_imported_fs2_forward_matches_jax(sb_fs2):
    """The imported compat FastSpeech2 in fp32 on both sides, teacher-forced
    on the same ids (tests/test_reference_import.py's batch)."""
    jcfg = ref.compat_config()
    tree = convert.fs2_params_from_reference_torch(
        sb_fs2, FastSpeech2Config(**dataclasses.asdict(jcfg)))
    tmodel = FastSpeech2(FastSpeech2Config(**dataclasses.asdict(jcfg)),
                         n_speakers=ref.N_SPK, dtype=torch.float32)
    tmodel.load_state_dict(convert.fs2_from_flax(tree))
    tmodel.eval()

    rng = np.random.default_rng(0)
    b, p, t = ref.B, ref.P, ref.T_MAX
    tokens = rng.integers(1, ref.N_CHAR, (b, p)).astype(np.int32)
    tokens[1, -2:] = 0
    durations = (rng.integers(1, 5, (b, p)) * (tokens != 0)).astype(np.int32)
    pitch = rng.standard_normal((b, t)).astype(np.float32)
    energy = rng.standard_normal((b, t)).astype(np.float32)
    speakers = rng.integers(0, ref.N_SPK, b).astype(np.int32)
    intensity = rng.standard_normal((b, p, ref.N_EMO)).astype(np.float32)

    jmodel = JaxFastSpeech2(jcfg, n_speakers=ref.N_SPK)
    want = jit(lambda v, *a: jmodel.apply(
        v, a[0], a[1], durations=a[2], pitch=a[3], energy=a[4], intensity=a[5],
        max_mel_len=t))(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree["params"])},
        *(jnp.asarray(x) for x in (tokens, speakers, durations, pitch, energy,
                                   intensity)))

    def tt(a):
        x = torch.from_numpy(a)
        return x.long() if x.dtype == torch.int32 else x

    with torch.no_grad():
        got = tmodel(tt(tokens), tt(speakers), durations=tt(durations),
                     pitch=tt(pitch), energy=tt(energy), intensity=tt(intensity),
                     max_mel_len=t)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[7]))
    for i, name in ((0, "mel"), (1, "mel after the PostNet"), (2, "log durations")):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   err_msg=name, **TOL)


def test_rank_import_tree_equals_jax_and_loads():
    cfg = Config()
    cfg.rank_model.n_encoder_layers = 2
    cfg.rank_model.hidden_dim = 16
    cfg.rank_model.n_heads = 2
    sd = _numpy(ref._rank_reference_state_dict(cfg))
    rm = cfg.rank_model
    want = jax_convert.rank_params_from_torch(sd, rm.n_encoder_layers, rm.n_heads)
    got = convert.rank_params_from_torch(sd, rm.n_encoder_layers, rm.n_heads)
    assert_same_tree(want, got)
    # the projector has a kernel and no bias; the port's model takes it strictly
    assert sorted(got["params"]["projector"]) == ["kernel"]
    model = RankModel(n_mels=cfg.audio.n_mels, n_heads=rm.n_heads,
                      n_emotions=cfg.n_emotions, n_layers=rm.n_encoder_layers,
                      hidden_dim=rm.hidden_dim, kernel_size=rm.kernel_size,
                      ffn_mult=rm.ffn_mult)
    model.load_state_dict(convert.rank_from_flax(got))


def test_torch_state_dict_unwraps_and_reads_numpy(tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "a.bias": torch.ones(2)}
    for name, obj in (("bare.pth", sd), ("wrapped.pth", {"state_dict": sd})):
        torch.save(obj, tmp_path / name)
        got = convert.torch_state_dict(str(tmp_path / name))
        assert sorted(got) == ["a.bias", "a.weight"]
        assert isinstance(got["a.weight"], np.ndarray)
        np.testing.assert_array_equal(got["a.weight"], sd["a.weight"].numpy())


@pytest.mark.parametrize("layout", ["weight_norm", "parametrizations", "plain"])
def test_hifigan_conversion_equals_jax(layout):
    sd = _numpy(weight_normed_hifigan(seed=3, layout=layout))
    assert_same_tree(jax_convert_hifigan(sd), convert_torch_state_dict(sd))


@pytest.fixture(scope="module")
def vocoder_pt(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_vocoder_import")
    path = root / "generator.pt"
    # a training checkpoint's {"generator": sd} wrapping, unwrapped on load
    torch.save({"generator": weight_normed_hifigan(seed=0)}, str(path))
    cfg_path = root / "cfg.yaml"
    jax_save_config(JaxConfig(), str(cfg_path))
    return root, path, cfg_path


def test_convert_vocoder_cli_matches_jax(vocoder_pt):
    """Both CLIs' convert-vocoder write identical arrays; the port reads the
    .pt as it reads the .npz."""
    root, pt, cfg_path = vocoder_pt
    for run, out in ((jax_main, "jax.npz"), (main, "port.npz")):
        assert run(["convert-vocoder", "--config", str(cfg_path),
                    "--checkpoint", str(pt), "--output", str(root / out)]) == 0
    with np.load(root / "jax.npz") as a, np.load(root / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert_same_tree(convert.load_vocoder_checkpoint(str(root / "port.npz")),
                     convert.load_vocoder_checkpoint(str(pt)))
    assert_same_tree(jax_load_vocoder(str(pt), JaxConfig()),
                     convert.load_vocoder_checkpoint(str(pt)))


def test_converted_vocoder_runs_as_jax(vocoder_pt):
    _, pt, _ = vocoder_pt
    params = convert.load_vocoder_checkpoint(str(pt))
    structure = dict(in_channels=8, upsample_initial_channel=32,
                     upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4))
    gen = HiFiGANGenerator(**structure)
    gen.load_state_dict(convert.hifigan_from_flax(params))
    mel = np.random.default_rng(1).standard_normal((2, 16, 8)).astype(np.float32)
    want = jit(JaxGenerator(**structure).apply)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(mel))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 16 * 4)
    np.testing.assert_allclose(got, np.asarray(want), **VOCODER_TOL)

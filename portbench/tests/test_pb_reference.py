"""The plain references against emotts_torch's plain CPU path at tiny
widths on seeded weights (the port's kernels take these plain versions on
the CPU).  The reference itself imports nothing of the port; these tests
may."""

import numpy as np
import pytest
import torch

import tiny
from harness.sentences import Sentences
from reference.fs2 import FastSpeech2 as RefFS2
from reference.g2p import phone_ids, pronunciations
from reference.hifigan import Generator, pcm16

SEED = 2147483901


@pytest.fixture(scope="module")
def fs2_cell():
    return tiny.cell("fs2v1.batch")


def test_phone_ids_are_the_port_g2p(fs2_cell):
    from emotts_torch.text.g2p import G2P

    g2p, prons = G2P(), pronunciations()
    mix = {"sentence": dict(median_words=9, sigma=0.5, min_words=3, max_words=40, max_phones=192)}
    for q in Sentences(mix, np.random.default_rng(SEED), {}, (4, 5, 3)).requests(300):
        assert g2p.text_to_sequence(q.text) == phone_ids(q.text, prons)


def _port_fs2(cell, weights):
    from emotts_torch.train.fs2_trainer import build_fastspeech2

    model = build_fastspeech2(cell.model().port_config(cell.config))
    model.load_state_dict(weights["fs2"])
    return model.eval()


def test_fastspeech2_matches_the_port(fs2_cell):
    m = fs2_cell.model()
    weights = m.make_weights(fs2_cell.config, SEED, "cpu")
    port = _port_fs2(fs2_cell, weights)
    f = fs2_cell.config["fastspeech2"]
    ref = RefFS2(weights["fs2"], dict(layers=f["enc_num_layers"], heads=f["heads"], ln_eps=f["ln_eps"]))
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(1, 89, (3, 16), generator=g)
    tokens[1, 9:] = 0
    tokens[2, 4:] = 0
    spk = torch.tensor([0, 2, 3])
    inten = torch.randn(3, 16, 5, generator=g) * (tokens != 0)[..., None]
    with torch.no_grad():
        out = port(tokens, spk, intensity=inten, max_mel_len=f["max_mel_len"])
    mel, log_dur, lens = ref(tokens, spk, inten, None, f["max_mel_len"])
    assert torch.equal(lens, out[7].long())
    torch.testing.assert_close(log_dur, out[2], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mel, out[0], rtol=1e-4, atol=1e-5)
    dur = torch.full((3, 16), 2) * (tokens != 0)
    with torch.no_grad():
        forced = port(tokens, spk, durations=dur, intensity=inten, max_mel_len=f["max_mel_len"])
    mel, _, lens = ref(tokens, spk, inten, dur, f["max_mel_len"])
    assert lens.tolist() == [32, 18, 8]
    torch.testing.assert_close(mel, forced[0], rtol=1e-4, atol=1e-5)


def test_generator_matches_the_port(fs2_cell):
    from emotts_torch.nn.hifigan import HiFiGANGenerator

    m = fs2_cell.model()
    weights = m.make_weights(fs2_cell.config, SEED, "cpu")
    port = HiFiGANGenerator(**m.vocoder_structure(fs2_cell.config, kernels=False))
    port.load_state_dict(weights["vocoder"])
    mel = torch.randn(2, 20, 80, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = port(mel)
    got = Generator(weights["vocoder"], fs2_cell.config["hifigan"])(mel)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert (pcm16(got).int() - pcm16(want).int()).abs().max() <= 1


def test_rank_step_matches_the_trainer(tmp_path):
    cell = tiny.cell("rank.train")
    model, kind = cell.model(), cell.kind()
    utterances, _ = kind.make_corpus(cell.mix, cell.config, SEED, str(tmp_path))
    trained = model.Trained(cell.config, SEED, "cpu", str(tmp_path), cell.mix)
    stream = trained.batches()
    trained.first_steps([next(stream) for _ in range(model.FIRST_STEPS)])
    batches, differ = model.reference_batches(trained.first_batches, utterances,
                                              cell.config["frame_buckets"])
    assert differ == 0
    ref = model.reference_readings(cell.config, trained.p0, batches, SEED)
    got = model.compare(trained.readings, ref)
    assert got["loss_gap"] < 1e-5 and got["change_gap"] < 1e-3
    # the optimizer's first moment is stored in bf16: its norm to about 2⁻⁸
    assert got["grad_gap"] < 1e-2

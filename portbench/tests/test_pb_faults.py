"""The whole run but the card, at tiny sizes on the CPU, with the timed
path broken underneath: ``correct`` has to come out false for every fault
the cell can have, and true with nothing broken.  The limits are the
cells' own (set for the full size on the card)."""

import pytest
import torch

import run
import tiny

SEED = 2147483917


def measure(name, seconds=1.0):
    args = run.parse(["--workload", name, "--seed", str(SEED), "--seconds", str(seconds)])
    return run.measure(args, tiny.cell(name), torch, device="cpu")[0]


SERVING = ["fs2v1.batch", "fs2v1.serve"]


@pytest.mark.parametrize("name", SERVING + ["rank.train"])
def test_nothing_broken_is_correct(name):
    assert measure(name)["correct"]


def _token_altered(monkeypatch):
    from emotts_torch.infer.synthesize import Synthesizer

    orig = Synthesizer.text_to_phoneme_ids

    def altered(self, text):
        ids = orig(self, text).copy()
        ids[0] = ids[0] % 80 + 1
        return ids
    monkeypatch.setattr(Synthesizer, "text_to_phoneme_ids", altered)


def _answer_altered(monkeypatch):
    from emotts_torch.infer.synthesize import Synthesizer

    orig = Synthesizer._vocode_on

    def altered(self, replica, mel):
        pcm = orig(self, replica, mel)
        pcm[:, ::7] = pcm[:, ::7] // 2
        return pcm
    monkeypatch.setattr(Synthesizer, "_vocode_on", altered)


def _half_the_rows_left_out(monkeypatch):
    from emotts_torch.infer.synthesize import Synthesizer

    orig = Synthesizer._mel_forward_on

    def half(self, replica, phonemes, *rest):
        mel, lens = orig(self, replica, phonemes, *rest)
        keep = (torch.arange(mel.shape[0]) < mel.shape[0] // 2).to(mel.device)
        return mel * keep[:, None, None], lens
    monkeypatch.setattr(Synthesizer, "_mel_forward_on", half)


@pytest.mark.parametrize("name", SERVING)
@pytest.mark.parametrize("fault", [_token_altered, _answer_altered, _half_the_rows_left_out])
def test_a_serving_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    assert not measure(name)["correct"]


def _state_unchanged(monkeypatch):
    from emotts_torch.train.state import AdamW

    monkeypatch.setattr(AdamW, "step", lambda self, closure=None: None)


def _half_the_batch(monkeypatch):
    from emotts_torch.train import rank_trainer

    orig = rank_trainer.rank_loss

    def half(preds, y, *args, **kwargs):
        n = y.shape[0] // 2
        return orig(tuple(p[:n] for p in preds), y[:n], *args, **kwargs)
    monkeypatch.setattr(rank_trainer, "rank_loss", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch])
def test_a_training_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not measure("rank.train")["correct"]

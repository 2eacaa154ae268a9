"""The port's own copies of the text front end and the configuration tree
(emotts_torch/text, emotts_torch/utils/config.py) give what the JAX
package's originals give."""

import dataclasses

import numpy as np
import pytest

import emotts.text as jt
import emotts.utils.config as jc
import emotts_torch.text as tt
import emotts_torch.utils.config as tc
from emotts.text.ssml import parse_ssml as jax_parse_ssml
from emotts_torch.text.ssml import parse_ssml

SENTENCES = [
    "gregson was asleep when he re-entered the cabin.",
    "Dr. Smith paid $3.50 for 12 apples on May 3rd, 1999!",
    "I read the book yesterday; I will read it again.",
    "The wind was too strong to wind the sail.",
    "Hello there... how's it going?",
    "Zyxgrawl frobnicated the quuxes.",  # out-of-lexicon words
]


@pytest.fixture(scope="module")
def g2ps():
    return jt.G2P(None, neural=True), tt.G2P(None, neural=True)


@pytest.mark.parametrize("text", SENTENCES)
def test_phoneme_ids_equal(g2ps, text):
    a, b = g2ps
    assert b.text_to_sequence(text) == a.text_to_sequence(text)
    assert len(b.text_to_sequence(text)) > 0


def test_rule_fallback_equal_without_neural_model():
    a, b = jt.G2P(None, neural=False), tt.G2P(None, neural=False)
    for text in SENTENCES:
        assert b.text_to_sequence(text) == a.text_to_sequence(text)


def test_vocab_cleaners_segmenter_equal():
    assert tt.VALID_TOKENS == jt.VALID_TOKENS and tt.vocab_size() == jt.vocab_size()
    assert tt.PAD_ID == jt.PAD_ID and tt.SIL_PHONES == jt.SIL_PHONES
    from emotts.text.segment import split_sentences as js
    from emotts_torch.text.segment import split_sentences as ts

    for text in SENTENCES:
        assert tt.clean_text(text) == jt.clean_text(text)
    long_text = " ".join(SENTENCES)
    assert ts(long_text) == js(long_text)


def test_ssml_parser_equal():
    markup = ('<speak>One. <emotion name="amused" level="1.5" scale="1.2">Two'
              '</emotion><break time="250ms"/><prosody rate="1.5">'
              '<voice name="bea">Three</voice></prosody>'
              '<phoneme ph="HH AH0 L OW1">hello</phoneme></speak>')
    a, b = jax_parse_ssml(markup), parse_ssml(markup)
    assert len(a) == len(b) > 3
    for x, y in zip(a, b):
        assert dataclasses.asdict(x) == dataclasses.asdict(y)


def test_data_files_are_shared_not_duplicated():
    from emotts.text.g2p import BUNDLED_LEXICON as jl
    from emotts.text.neural_g2p import BUNDLED_WEIGHTS as jw
    from emotts_torch.text.g2p import BUNDLED_LEXICON as tl
    from emotts_torch.text.neural_g2p import BUNDLED_WEIGHTS as tw
    import os

    assert os.path.samefile(jl, tl) and os.path.samefile(jw, tw)


def test_config_defaults_equal_field_by_field():
    a, b = jc.Config(), tc.Config()
    assert jc.config_to_dict(a) == tc.config_to_dict(b)
    for section in dataclasses.fields(a):
        ja, tb = getattr(a, section.name), getattr(b, section.name)
        assert [f.name for f in dataclasses.fields(ja)] == [
            f.name for f in dataclasses.fields(tb)], section.name
    assert (a.n_speakers, a.n_emotions) == (b.n_speakers, b.n_emotions)
    assert jc.config_fingerprint(a) == tc.config_fingerprint(b)


def test_config_yaml_and_overrides(tmp_path):
    path = tmp_path / "cfg.yaml"
    cfg = tc.Config()
    cfg.fastspeech2.fused_attention = True
    tc.save_config(cfg, str(path))
    loaded = tc.load_config(str(path), ["inference.vocode_row_frames=4096",
                                        "--train_fs2.compute_dtype=float32"])
    assert loaded.fastspeech2.fused_attention is True
    assert loaded.inference.vocode_row_frames == 4096
    assert loaded.train_fs2.compute_dtype == "float32"
    assert jc.config_to_dict(jc.load_config(str(path))) == tc.config_to_dict(
        tc.load_config(str(path)))
    with pytest.raises(KeyError):
        tc.load_config(None, ["fastspeech2.no_such_field=1"])

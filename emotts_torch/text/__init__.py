from emotts_torch.text.cleaners import clean_text, english_cleaners
from emotts_torch.text.g2p import G2P, letter_to_sound
from emotts_torch.text.vocab import (
    PAD_ID,
    SIL_PHONES,
    VALID_SYMBOLS,
    VALID_TOKENS,
    filter_to_vocab,
    phoneme_to_sequence,
    sequence_to_phoneme,
    vocab_size,
)

__all__ = [
    "clean_text",
    "english_cleaners",
    "G2P",
    "letter_to_sound",
    "PAD_ID",
    "SIL_PHONES",
    "VALID_SYMBOLS",
    "VALID_TOKENS",
    "filter_to_vocab",
    "phoneme_to_sequence",
    "sequence_to_phoneme",
    "vocab_size",
]

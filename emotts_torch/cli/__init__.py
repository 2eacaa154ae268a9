"""Command-line stages of the port.  So far only corpus preparation
(``prepare_corpus``); the ``emotts`` command itself (``emotts/cli/main.py``)
is still to be ported."""

from emotts_torch.cli.prepare_corpus import parse_transcript_index, prepare_corpus

__all__ = ["parse_transcript_index", "prepare_corpus"]

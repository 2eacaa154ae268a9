"""The ``emotts-torch`` command (``emotts_torch.cli.main``, run as
``python -m emotts_torch.cli.main``) and corpus preparation
(``prepare_corpus``)."""

from emotts_torch.cli.prepare_corpus import parse_transcript_index, prepare_corpus

__all__ = ["parse_transcript_index", "prepare_corpus"]

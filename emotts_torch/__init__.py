"""emotts_torch — the PyTorch/CUDA port of emotts (fine-grained emotional TTS).

The JAX package ``emotts`` beside it is the reference.  This package imports
``torch`` and nothing of JAX or of ``emotts``; directory and file names match
the reference so that a module's counterpart is found by its path
(``emotts_torch/nn/blocks.py`` ↔ ``emotts/nn/blocks.py``).

Ported so far — the path that serves synthesis requests:

* ``emotts_torch.utils.config`` — the configuration tree (own copy).
* ``emotts_torch.text``   — cleaners, ARPABET vocabulary, G2P, SSML-lite.
* ``emotts_torch.audio``  — WAV output.
* ``emotts_torch.ops``    — hand-written CUDA kernels (``csrc/*.cu``) for
  fused attention, the HiFi-GAN ResBlock and the fused MRF stage, each with
  its wrapper, its plain PyTorch version and a launch counter.
* ``emotts_torch.nn``     — FFT blocks, length regulator, FastSpeech2,
  HiFi-GAN generator, conversion of the reference's weights.
* ``emotts_torch.infer``  — ``Synthesizer`` and the HTTP server.
"""

__version__ = "0.1.0"

"""emotts_torch — the PyTorch/CUDA port of emotts (fine-grained emotional TTS).

The JAX package ``emotts`` beside it is the reference.  This package imports
``torch`` and nothing of JAX or of ``emotts``; directory and file names match
the reference so that a module's counterpart is found by its path
(``emotts_torch/nn/blocks.py`` ↔ ``emotts/nn/blocks.py``).

Ported so far — the path that serves synthesis requests, rank-model,
FastSpeech2 and vocoder training (data-parallel over processes),
bucketization, preprocessing and evaluation:

* ``emotts_torch.utils``  — the configuration tree and experiment
  directories (own copies).
* ``emotts_torch.text``   — cleaners, ARPABET vocabulary, G2P, SSML-lite.
* ``emotts_torch.audio``  — WAV IO and resampling, TextGrids, DIO/StoneMask
  F0 (numpy, or the ``native/`` library), the mel + energy front end (numpy
  golden, and tensors on the GPU).
* ``emotts_torch.ops``    — hand-written CUDA kernels (``csrc/*.cu``) for
  fused attention (forward with dropout, and backward), the HiFi-GAN ResBlock
  and the fused MRF stage, each with its wrapper, its plain PyTorch version
  and a launch counter.
* ``emotts_torch.nn``     — FFT blocks, length regulator, FastSpeech2,
  HiFi-GAN generator and discriminators, the rank model, conversion of the
  reference's weights.
* ``emotts_torch.losses`` — the rank, FastSpeech2 and GAN losses.
* ``emotts_torch.data``   — preprocessing into per-utterance ``.npz``, the
  split lists, the rank-pair and FS2 datasets and the bucketed loader.
* ``emotts_torch.cli``    — corpus preparation (``prepare_corpus``).
* ``emotts_torch.eval``   — MCD/DTW/F0/duration metrics, ``Evaluator``, the
  intensity-efficacy report.
* ``emotts_torch.train``  — AdamW with stored-dtype moments, train state,
  checkpoints, metrics, ``RankTrainer``, ``FS2Trainer``, ``VocoderTrainer``.
* ``emotts_torch.infer``  — ``Synthesizer``, the HTTP server, ``bucketize``.
* ``emotts_torch.parallel`` — the (data, model) grid on
  ``torch.distributed``: ``make_mesh``, the loader's process rows, draws at
  the global batch shape, global sums, DDP and the gradient all-reduce on
  the data axis; the FFT blocks' tensor-parallel shards, Megatron's ``f``
  and ``g`` and full-tensor checkpoints on the model axis.
"""

__version__ = "0.1.0"

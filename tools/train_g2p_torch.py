#!/usr/bin/env python3
"""Train the port's neural G2P on the bundled lexicon, on the GPU
(emotts_torch/text/g2p_train.py); the counterpart of tools/train_g2p.py.

    python tools/train_g2p_torch.py --out g2p_weights.npz
    python tools/train_g2p_torch.py --eval-ensemble a.npz,b.npz

The flags and defaults are tools/train_g2p.py's, plus ``--device`` (default
``cuda``; without a GPU the tool exits with code 2 unless given ``--device
cpu``).  ``--out`` defaults to ``g2p_weights.npz`` in the working directory
and may not lie inside the ``emotts/`` package.  The weight file it writes is
read by both packages' ``NeuralG2P``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from emotts_torch.text.g2p_train import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())

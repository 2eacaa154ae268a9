#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 24 (``g2p``) alone, on one GPU.

    python3 tools/chip_g2p.py

The neural G2P's training mirror and batched decode at the bundled
architecture: (a) the bundled weights against the numpy forward, (b) the
held-out sweep, (c) one full epoch with its step readings, (d) resume bit
for bit and the tool as a subprocess.  Builds no kernel: none runs on this
path.  Prints the card line, one JSON line a part and the phase's line;
exits non-zero where a part fails.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    with tempfile.TemporaryDirectory(prefix="emotts_g2p_") as root:
        cs.emit("g2p", card=card, **cs.g2p_phase(root, dev))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 23 (``tensor_parallel``) alone, on one GPU.

    python3 tools/chip_tensor_parallel.py

Builds the kernels, holds the attention kernels at a tensor-parallel rank's
shape (H = 1, phase 3's ``fused_attention_tp_rank`` cases), makes the rank
corpus of phase 8 from the seed with seeded rank weights as its ``best/``
export (the FS2 trainer's extractor) instead of a training run, then runs
the phase: (a) two processes on the card over gloo as a 1 x 2 grid against
one process, (b) the rank and FS2 steps with and without remat.  Prints the
card line, the kernel cases, the phase's JSON line and the launches; exits
non-zero where a part fails.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from emotts_torch.ops import _build
    from emotts_torch.train.checkpoint import save_best_export
    from emotts_torch.train.rank_trainer import build_rank_model, init_rank_model

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    cs.emit("build", seconds=time.perf_counter() - t0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fwd, bwd = cs.check_attention_tp(torch.Generator().manual_seed(cs.SEED), dev)
    for case in fwd + bwd:
        cs.with_ratios(case)
    cs.emit("kernels", card=card, fused_attention_tp_rank=fwd,
            fused_attention_bwd_tp_rank=bwd)
    with tempfile.TemporaryDirectory(prefix="emotts_tp_") as root:
        rank_cfg = cs.rank_config(root)
        cs.make_rank_corpus(rank_cfg.data.preprocessed_path, rank_cfg, cs.SEED)
        exp = os.path.join(root, "rank_exp")
        save_best_export(exp, init_rank_model(
            build_rank_model(rank_cfg, device="cpu")).state_dict())
        launches, report = cs.tp_phase(root, exp, dev)
        cs.emit("tensor_parallel", card=card, **report)
    print(json.dumps(launches), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

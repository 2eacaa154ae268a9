#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 22 (``data_parallel``) alone, on one GPU.

    python3 tools/chip_data_parallel.py

Builds the kernels, makes what the phase reads from the seed — the rank
corpus of phase 8 (with seeded rank weights as its ``best/`` export instead
of a training run) and the raw corpus of phase 15 — then runs the phase:
(a) the three train steps under the DP path (NCCL, world size 1) against
the plain step, (b) two processes on the card over gloo, (c) sharded serving
and bucketize over a two-entry mesh, (d) ``train-rank`` under
``torch.distributed.run``.  Prints the card line, the phase's JSON line and
the kernels' launch counts of its in-process parts; exits non-zero where a
part fails.  About four minutes on an H100, one of them the build.
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
    weights = cs.seeded_weights(cs.full_width_config())
    with tempfile.TemporaryDirectory(prefix="emotts_dp_") as root:
        rank_cfg = cs.rank_config(root)
        cs.make_rank_corpus(rank_cfg.data.preprocessed_path, rank_cfg, cs.SEED)
        exp = os.path.join(root, "rank_exp")
        save_best_export(exp, cs.seeded_build(
            lambda: init_rank_model(build_rank_model(rank_cfg, device="cpu"))).state_dict())
        cs.preprocess_phase(root, dev)  # the raw corpus the vocoder steps read
        launches, report = cs.dp_phase(root, exp, weights, dev)
        cs.emit("data_parallel", card=card, **report)
    print(json.dumps(launches), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

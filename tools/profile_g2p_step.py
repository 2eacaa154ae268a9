#!/usr/bin/env python3
"""Where a full-size G2P train step's time goes, on one GPU, by how its
embeddings and LayerNorms are computed.

    python3 tools/profile_g2p_step.py

At the bundled architecture (d 256, 3 + 3 layers, 8 heads), batch 512,
dropout 0.2, one step of ``emotts_torch/text/g2p_train.py::train_step`` with
each of: the embedding as indexing (``table[ids]``), as ``F.embedding`` and
as the one-hot product the port uses, and the LayerNorm written out or as
``F.layer_norm`` (the port's).  Two rounds, in turns: per variant the median
wall of 20 synchronised steps, and from a ``torch.profiler`` trace of three
steps the device ms, the launches and the GEMMs' ms; then each variant's
logits against indexing's, and whether two backward passes give the same
bits.  Prints one JSON line per reading.  Needs one GPU; builds no kernel.
"""

import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from emotts_torch.text import g2p_train as gt  # noqa: E402
from emotts_torch.text import neural_g2p as ng  # noqa: E402


def _written_ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + ng._EPS) * g + b


VARIANTS = {
    "index": (lambda t, i: t[i], _written_ln),
    "F.embedding": (lambda t, i: F.embedding(i, t), _written_ln),
    "one_hot": (ng._embed, _written_ln),
    "one_hot+F.layer_norm": (ng._embed, ng._ln_t),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    train_pairs, _ = gt.build_pairs(seed=0, holdout_frac=0.1)
    p, heads = gt.load_weights(ng.BUNDLED_WEIGHTS)
    arch = ng.arch_of(p, heads)
    args = cs.g2p_args(dev, os.devnull, d_model=arch["d_model"], d_ff=arch["d_ff"],
                       layers=arch["n_enc"], heads=heads, **cs.G2P_TRAIN)
    batch = tuple(torch.from_numpy(a).long().to(dev)
                  for a in gt.vectorize(train_pairs[:args.batch]))
    kept = ng._embed, ng._ln_t
    try:
        for rnd in range(2):
            for name, (embed, ln) in VARIANTS.items():
                ng._embed, ng._ln_t = embed, ln
                stepper = cs.G2PStepper(args, dev)
                walls = []
                for i in range(23):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    stepper.train_step(batch)
                    torch.cuda.synchronize()
                    if i >= 3:
                        walls.append(1e3 * (time.perf_counter() - t0))
                r = cs.profile_steps(stepper, {args.batch: batch}, rows=lambda b: len(b[0]),
                                     timed=5, traced=3, host_ops=False,
                                     groups=(("gemm", "gemm"),))[str(args.batch)]
                print(json.dumps(dict(round=rnd, variant=name, wall_ms_median=float(np.median(walls)),
                                      device_ms=r["device_ms_per_step"],
                                      launches=r["kernel_launches_per_step"],
                                      gemm_ms=r["gemm_ms"],
                                      largest_other=r["largest_other_kernels"][:2])), flush=True)
        model = ng.G2PTransformer.from_flat(p, heads, dev)
        logits, same_bits = {}, {}
        for name, (embed, ln) in VARIANTS.items():
            ng._embed, ng._ln_t = embed, ln
            with torch.inference_mode():
                logits[name] = model(batch[0], batch[1]).cpu().numpy()
            grads = []
            for _ in range(2):
                model.zero_grad()
                gt.g2p_loss(model(batch[0], batch[1]), batch[2], args.label_smoothing).backward()
                grads.append({k: v.grad.clone() for k, v in model.params.items()})
            same_bits[name] = all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
        print(json.dumps(dict(
            logits_max_abs_vs_index={k: float(np.abs(v - logits["index"]).max())
                                     for k, v in logits.items()},
            backward_bit_identical_twice=same_bits)), flush=True)
    finally:
        ng._embed, ng._ln_t = kept
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

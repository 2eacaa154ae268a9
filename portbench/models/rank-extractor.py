"""The rank model's training as ``configs/rank-extractor.json`` states it:
``emotts_torch``'s ``RankTrainer`` (mixup, the intensity extractor in
bfloat16 with dropout 0.1 through the attention kernels forward and
backward, the rank loss, AdamW with bfloat16 moments) on seeded weights
made on the card, fed by the trainer's own ``BucketLoader``.

Set-up drives the one trainer through its first three steps on the
loader's first three batches; the window then continues with the same
object.  The comparison follows those three steps with the plain
reference from the same weights, batches and seed:

* ``loss_gap``: the widest relative gap between the program's loss and
  the reference's over the three steps.
* ``grad_gap``: the worst leaf's gap between the norm of the first
  gradient as the optimizer got it (its first moment after one step over
  1 − β₁) and the reference's, over the larger of that leaf's reference
  norm and the median leaf's.
* ``change_gap``: the same for the norm of each leaf's change over the
  three steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from harness.weights import card_generator, seeded_state
from reference.precision import FP8, FP32
from reference.rank import RankStep, collate
from roofline import attention_bwd, attention_fwd, model_flops, peaks

FIRST_STEPS = 3
TINY_GRADIENT = 1e-3


def port_config(c: dict, corpus: str, speakers: int, batch_pairs: int, seed: int):
    from emotts_torch.utils.config import Config

    cfg = Config()
    e, rm, t = c["extractor"], cfg.rank_model, cfg.train_rank
    cfg.audio.n_mels = c["n_mels"]
    rm.n_encoder_layers, rm.n_heads, rm.hidden_dim = e["layers"], e["heads"], e["hidden"]
    rm.kernel_size, rm.ffn_mult, rm.dropout = e["kernel_size"], e["ffn_dim"] // e["hidden"], e["dropout"]
    rm.alpha, rm.beta, rm.fused_attention = c["loss"]["alpha"], c["loss"]["beta"], c["fused_attention"]
    o = c["optimizer"]
    t.learning_rate, t.weight_decay, t.moment_dtype = o["learning_rate"], o["weight_decay"], o["moment_dtype"]
    t.compute_dtype, t.batch_size, t.seed = c["compute_dtype"], batch_pairs, seed
    cfg.bucketing.frame_buckets = list(c["frame_buckets"])
    cfg.data.preprocessed_path = corpus
    cfg.data.split_seed = seed
    cfg.data.speakers = [f"speaker{i}" for i in range(speakers)]
    cfg.data.emotions = ["neutral"] + [f"emotion{i}" for i in range(1, c["n_emotions"])]
    return cfg


def _rule(name, shape):
    if len(shape) >= 2:
        return "normal", int(np.prod(shape[1:]))
    return ("ones", 0) if "norm" in name and name.endswith(".weight") else ("zeros", 0)


def reference_config(c: dict) -> dict:
    e, o = c["extractor"], c["optimizer"]
    return dict(layers=e["layers"], heads=e["heads"], dropout=e["dropout"],
                alpha=c["loss"]["alpha"], beta=c["loss"]["beta"],
                learning_rate=o["learning_rate"], weight_decay=o["weight_decay"],
                moment_dtype=o["moment_dtype"])


class Trained:
    """The program under test: one ``RankTrainer`` and its loader."""

    def __init__(self, config: dict, seed: int, device, corpus: str, mix: dict):
        from emotts_torch.train.rank_trainer import RankTrainer

        self.c, self.seed, self.device = config, seed, torch.device(device)
        self.trainer = RankTrainer(port_config(config, corpus, mix["corpus"]["speakers"],
                                               mix["batch_pairs"], seed), device=device)
        shapes = {k: v.shape for k, v in self.trainer.model.state_dict().items()}
        self.p0 = seeded_state(shapes, _rule, card_generator(seed, device), device)
        self.trainer.model.load_state_dict(self.p0)
        self.loader = self.trainer._loader("train", shuffle=True)
        self.first_batches: List[dict] = []
        self.readings: Dict = {}
        self.tracing = False
        self.traced_lengths: List[np.ndarray] = []
        self.window_lengths: List[np.ndarray] = []

    def batches(self):
        epoch = 0
        while True:
            yield from self.loader.epoch(epoch)
            epoch += 1

    def first_steps(self, batches) -> None:
        """The first three steps, as the window takes them, with what the
        comparison reads of each."""
        t = self.trainer
        names = dict(t.model.named_parameters())
        losses = []
        for i, batch in enumerate(batches):
            losses.append(t.train_step(batch)["loss"])
            if i == 0:
                b1 = t.state.optimizer.param_groups[0]["betas"][0]
                state = t.state.optimizer.state
                grads = {k: float(state[p]["mu"].float().norm()) / (1 - b1) if "mu" in state[p]
                         else 0.0 for k, p in names.items()}
        change = {k: float((p.detach() - self.p0[k]).norm()) for k, p in names.items()}
        self.first_batches = list(batches)
        self.readings = {"losses": losses, "grads": grads, "change": change}

    def step(self, batch) -> None:
        self.trainer.train_step(batch)
        self.window_lengths.append(batch["lengths"])
        if self.tracing:
            self.traced_lengths.append(batch["lengths"])

    def trace(self, on: bool) -> None:
        self.tracing = on
        if on:
            self.traced_span = [len(self.window_lengths), None]
        else:
            self.traced_span[1] = len(self.window_lengths)

    def counters(self) -> dict:
        """The least time of the window's steps outside the traced stretch:
        three forwards' FLOPs on the content frames of both mixes."""
        c, e = self.c, self.c["extractor"]
        span = getattr(self, "traced_span", None)
        skip = range(*span) if span else range(0)
        flops = sum(3 * 2 * sum(model_flops.extractor(e, c["n_mels"] + 2, c["n_emotions"], int(n))
                                for n in lengths)
                    for i, lengths in enumerate(self.window_lengths) if i not in skip)
        return {"least_time_s": flops / peaks.PEAK_FLOPS[c["compute_dtype"]],
                "steps": len(self.window_lengths)}

    def kernel_bounds(self) -> dict:
        e, dt = self.c["extractor"], self.c["compute_dtype"]
        fwd = bwd = 0.0
        for lengths in self.traced_lengths:
            rows, both = 2 * len(lengths), np.concatenate([lengths, lengths])
            t = next(b for b in self.c["frame_buckets"] if b >= lengths.max())
            fwd += e["layers"] * attention_fwd.bound(rows, t, e["heads"], e["head_dim"], both, dt)
            bwd += e["layers"] * attention_bwd.bound(rows, t, e["heads"], e["head_dim"], both, dt)
        return {"attention_fwd": fwd, "attention_bwd": bwd, "steps": len(self.traced_lengths)}

    def release(self) -> None:
        self.trainer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _readings(step: RankStep, p0, batches) -> dict:
    losses = []
    for i, batch in enumerate(batches):
        loss, grads = step.step(batch)
        losses.append(loss)
        if i == 0:
            first = {k: float(g.norm()) for k, g in grads.items()}
    change = {k: float((step.p[k].detach() - p0[k]).norm()) for k in p0}
    return {"losses": losses, "grads": first, "change": change}


def reference_readings(config: dict, p0, batches, seed: int, precision=FP32) -> dict:
    return _readings(RankStep(p0, reference_config(config), seed, precision), p0, batches)


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers compared (see the module's notes), with the leaf
    that sets each of the two by leaf."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["grads"].values())
    grad = {k: abs(prog["grads"][k] - g) / max(g, med_g) for k, g in ref["grads"].items()}
    moved = [k for k, g in ref["grads"].items() if g >= TINY_GRADIENT * med_g]
    med_c = statistics.median(ref["change"][k] for k in moved)
    change = {k: abs(prog["change"][k] - ref["change"][k]) / max(ref["change"][k], med_c)
              for k in moved}
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss_gap": loss, "grad_gap": grad[worst_g], "change_gap": change[worst_c],
            "grad_gap_leaf": worst_g, "change_gap_leaf": worst_c,
            "leaves_left_out": len(ref["grads"]) - len(moved)}


def reference_batches(batches, utterances, buckets):
    """The reference's own batches: each row of the program's batch found
    in the corpus by its first frames, then collated from the corpus.
    Returns them and the rows where the program's batch differs."""
    index = {u[0].tobytes(): (key, u) for key, u in utterances.items()}
    out, differ = [], 0
    for b in batches:
        found = [(index.get(b["emo_x"][r, 0].tobytes()), index.get(b["neu_x"][r, 0].tobytes()))
                 for r in range(len(b["lengths"]))]
        if any(e is None or n is None for e, n in found):
            differ += len(found)
            out.append(b)
            continue
        ref = collate([(e[1], n[1], e[0][1]) for e, n in found], buckets)
        rows = np.zeros(len(found), bool)
        for k, v in ref.items():
            same = np.asarray(b[k]) == v
            rows |= ~same.reshape(len(found), -1).all(axis=1)
        differ += int(rows.sum())
        out.append(ref)
    return out, differ


def check(cell, out) -> dict:
    trained = out["system"]
    batches, differ = reference_batches(trained.first_batches, out["utterances"],
                                        cell.config["frame_buckets"])
    ref = reference_readings(cell.config, trained.p0, batches, trained.seed)
    return {"batch_mismatch": differ, **compare(trained.readings, ref)}


def control_check(cell, seed: int, seconds: float, device) -> dict:
    """The reference in fp8 in the program's place, on the batches the
    program's loader would give its first three steps."""
    import os
    import shutil
    import tempfile

    kind = cell.kind()
    root = tempfile.mkdtemp(prefix="portbench-corpus-", dir=os.environ.get("TMPDIR"))
    try:
        utterances, _ = kind.make_corpus(cell.mix, cell.config, seed, root)
        trained = Trained(cell.config, seed, device, root, cell.mix)
        stream = trained.batches()
        first = [next(stream) for _ in range(FIRST_STEPS)]
        p0 = trained.p0
        trained.release()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    batches, differ = reference_batches(first, utterances, cell.config["frame_buckets"])
    ref = reference_readings(cell.config, p0, batches, seed)
    ctrl = reference_readings(cell.config, p0, batches, seed, FP8)
    return {"batch_mismatch": differ, **compare(ctrl, ref)}

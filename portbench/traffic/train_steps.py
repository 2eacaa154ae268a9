"""Training steps back to back over the trainer's own loader, on a corpus
made from the seed in ``RankPairDataset``'s format under ``TMPDIR`` and
removed at the end.

Corpus: ``speakers`` × ``emotions`` × ``utterances`` feature files
(``<speaker>/<emotion>_<id>.npz``: ``mel`` (n_mels, T), ``pitch`` (T,),
``energy`` (T,)), lengths log-uniform over ``seconds`` at ``frames_per_s``
(the distribution's quantiles, one an utterance, in the seed's order);
an emotional utterance is a smoothed normal draw plus its emotion's
offset at a strength of its own, a neutral one the draw alone.  Pairs as
the repository's rank corpora make them: each emotional utterance i < U−1
with the neutral i and (i+1) mod (U−1) (``train.txt``).

Set-up: the first three steps (recorded for the comparison), then steps
until every frame bucket of the corpus has run ``warm_per_bucket`` times.
The window runs steps until ``seconds`` have passed: its rate is the
content frames of both rows of every pair of every step over the time
from the first step's start to the last step's end (every step reads its
loss back, so the host waits for the card).  ``traced_steps`` [first,
end) steps run under the profiler; ``batch_pairs`` is the batch."""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from collections import Counter

import numpy as np

from harness.trace import Range


def make_corpus(mix: dict, config: dict, seed: int, root: str):
    """Write the corpus; returns each utterance's (T, n_mels + 2) features
    by (speaker, emotion, id) and the frame length of every pair."""
    cm = mix["corpus"]
    rng = np.random.default_rng([seed, 6])
    n_spk, n_emo, n_utt = cm["speakers"], config["n_emotions"], cm["utterances"]
    n_ch = config["n_mels"] + 2
    lo, hi = (np.log(s * cm["frames_per_s"]) for s in cm["seconds"])
    n = n_spk * n_emo * n_utt
    grid = np.exp(lo + (hi - lo) * (np.arange(n) + 0.5) / n)
    lengths = np.rint(rng.permutation(grid)).astype(int).reshape(n_spk, n_emo, n_utt)
    offsets = rng.standard_normal((n_emo, n_ch)).astype(np.float32)
    emotions = ["neutral"] + [f"emotion{i}" for i in range(1, n_emo)]
    utterances = {}
    for s in range(n_spk):
        os.makedirs(os.path.join(root, f"speaker{s}"))
        for e, emo in enumerate(emotions):
            for i in range(n_utt):
                t = int(lengths[s, e, i])
                x = rng.standard_normal((n_ch, t + 2)).astype(np.float32)
                x = (x[:, 2:] + x[:, 1:-1] + x[:, :-2]) / np.float32(np.sqrt(3.0))
                if e:
                    x += np.float32(rng.uniform(0.3, 1.0)) * offsets[e][:, None]
                np.savez(os.path.join(root, f"speaker{s}", f"{emo}_{i:04d}.npz"),
                         mel=x[:-2], pitch=x[-2], energy=x[-1])
                utterances[s, e, i] = np.ascontiguousarray(x.T)
    pairs, lines = [], []
    for s in range(n_spk):
        for e in range(1, n_emo):
            for i in range(n_utt - 1):
                for j in (i, (i + 1) % (n_utt - 1)):
                    lines.append(f"speaker{s}|{emotions[e]}|{i:04d}|{j:04d}")
                    pairs.append(min(lengths[s, e, i], lengths[s, 0, j]))
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return utterances, np.asarray(pairs)


def run(cell, seed: int, seconds: float, stretch, device):
    mix, c = cell.mix, cell.config
    model = cell.model()
    root = tempfile.mkdtemp(prefix="portbench-corpus-", dir=os.environ.get("TMPDIR"))
    try:
        t_corpus = time.perf_counter()
        utterances, pair_frames = make_corpus(mix, c, seed, root)
        t_build = time.perf_counter()
        trained = model.Trained(c, seed, device, root, mix)
        t_warm = time.perf_counter()
        stream = trained.batches()
        trained.first_steps([next(stream) for _ in range(model.FIRST_STEPS)])
        buckets = {next(b for b in c["frame_buckets"] if b >= n) for n in pair_frames}
        seen = Counter(b["emo_x"].shape[1] for b in trained.first_batches)
        while any(seen[b] < mix["warm_per_bucket"] for b in buckets):
            batch = next(stream)
            trained.trainer.train_step(batch)
            seen[batch["emo_x"].shape[1]] += 1
        first, end = mix["traced_steps"]
        steps, frames, wait = 0, 0, 0.0
        t0 = time.perf_counter()
        while True:
            if stretch is not None and steps == first:
                stretch.start()
                trained.trace(True)
            t = time.perf_counter()
            with Range("loader_wait"):
                batch = next(stream)
            wait += time.perf_counter() - t
            trained.step(batch)
            steps += 1
            frames += 2 * int(batch["lengths"].sum())
            if stretch is not None and stretch.active and steps >= end:
                trained.trace(False)
                stretch.stop()
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        if stretch is not None and stretch.active:
            trained.trace(False)
            stretch.stop()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"system": trained, "t0": t0, "wall_s": wall, "utterances": utterances, "attempted": steps, "failed": 0,
            "metrics": {"train_frames_per_s": frames / wall},
            "counters": {"loader_wait_s": wait, "steps": steps},
            "notes": {"steps": steps, "frames": frames, "pairs": len(pair_frames),
                      "corpus_s": t_build - t_corpus, "build_s": t_warm - t_build,
                      "warm_s": t0 - t_warm}}

"""Intensity-prototype bucketization.

Counterpart of ``emotts/infer/bucketize.py``.  Produces the conditioning bank
that synthesis reads: the trained rank model scores every training utterance
with λ ≡ 1 (pure emotional input); per (speaker, emotion) the utterances are
sorted by rank score, their frame-level intensity vectors concatenated, split
into ``bucket_size`` contiguous chunks and averaged — prototypes of shape
(n_speakers, n_emotions, bucket_size, n_emotions), saved as ``intensity.npy``.
The rank model runs in fp32 without dropout here.  With a mesh over several
devices of one process the weights are replicated once per device and every
scoring batch is zero-padded to a multiple of the data-axis size and split
over the devices; the padded rows never reach the bank, which equals the
unsharded one.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from emotts_torch.data.datasets import RankPairDataset, collate_rank_pairs
from emotts_torch.data.loader import BucketLoader
from emotts_torch.parallel.mesh import (Mesh, local_mesh, replicate,
                                        round_up_to_multiple, serving_mesh,
                                        shard_batch)
from emotts_torch.train.checkpoint import load_best_params
from emotts_torch.train.rank_trainer import (
    batch_to_device,
    build_rank_model,
    resolve_device,
)
from emotts_torch.utils.config import Config

Storage = Dict[Tuple[int, int], List[Tuple[float, np.ndarray]]]


@torch.no_grad()
def compute_intensity_prototypes(
    cfg: Config,
    params: Dict[str, torch.Tensor],
    device="cuda",
    split: str = "train",
    return_storage: bool = False,
    mesh: Optional[Mesh] = None,
):
    """Run the rank model (``params``: its state_dict) over the split and
    build the prototype bank.  ``mesh`` (default: every GPU where there
    are several, ``parallel.mesh.serving_mesh``) splits the scoring batches
    over its devices; ``device`` is the one device without one."""
    device = resolve_device(device)
    mesh = local_mesh(mesh if mesh is not None else serving_mesh(cfg.mesh, device),
                      "compute_intensity_prototypes")
    model = build_rank_model(cfg, dtype=torch.float32, device=device)
    model.load_state_dict(params)
    model.eval()
    if mesh is None:
        replicas, devices = [model.to(device)], [device]
    else:
        replicas, devices = replicate(mesh, model), list(mesh.devices)

    loader = BucketLoader(
        RankPairDataset(cfg, split),
        buckets=cfg.bucketing.frame_buckets,
        batch_size=cfg.train_rank.batch_size,
        collate=collate_rank_pairs,
        shuffle=False,
        drop_last=False,
    )
    storage: Storage = {}
    for batch in loader.epoch(0):
        n = len(batch["lengths"])
        # zero-pad the rows so that the batch splits evenly; the padded rows
        # are sliced off below (never duplicated into the bank)
        n_pad = round_up_to_multiple(n, len(replicas))
        padded = {k: np.concatenate([v, np.zeros((n_pad - n, *v.shape[1:]), v.dtype)])
                  for k, v in batch.items() if isinstance(v, np.ndarray)}
        shards = shard_batch(mesh, padded) if mesh is not None else [padded]
        outs = []
        for replica, dev, shard in zip(replicas, devices, shards):
            b = batch_to_device(shard, dev)
            rows = b["emo_x"].shape[0]
            preds = replica(b["emo_x"], b["neu_x"], b["emotions"], b["lengths"],
                            torch.ones((2, rows), device=dev))
            outs.append((preds[2], preds[6]))  # I_i (B, T, n_emo), r_i (B,)
        intensity = np.concatenate([i.cpu().numpy() for i, _ in outs])[:n]
        scores = np.concatenate([r.cpu().numpy() for _, r in outs])[:n]
        for i in range(n):
            t = int(batch["lengths"][i])
            key = (int(batch["speakers"][i]), int(batch["emotions"][i]))
            storage.setdefault(key, []).append(
                (float(scores[i]), intensity[i, :t, :]))

    bank = _bank_from_storage(storage, cfg.n_speakers, cfg.n_emotions,
                              cfg.inference.bucket_size)
    return (bank, storage) if return_storage else bank


def prototype_spread(bank) -> Optional[Dict]:
    """How distinguishable the level prototypes are: mean pairwise L2
    distance between a cell's level prototypes, as a fraction of the cell's
    mean prototype norm, averaged over all non-neutral (speaker, emotion)
    cells.  (Own copy of ``emotts/eval/intensity_eval.py::prototype_spread``.)"""
    if bank is None:
        return None
    bank = np.asarray(bank, np.float64)  # (n_spk, n_emo, n_lv, dim)
    fracs = []
    for s in range(bank.shape[0]):
        for e in range(1, bank.shape[1]):
            protos = bank[s, e]  # (n_lv, dim)
            if protos.shape[0] < 2:
                continue  # single level: no pairwise distances to take
            norms = np.linalg.norm(protos, axis=-1)
            if norms.mean() < 1e-12:
                continue
            d = [np.linalg.norm(protos[i] - protos[j])
                 for i in range(len(protos))
                 for j in range(i + 1, len(protos))]
            fracs.append(float(np.mean(d) / norms.mean()))
    if not fracs:
        return None
    return {
        "mean_pairwise_over_norm": round(float(np.mean(fracs)), 5),
        "min": round(float(np.min(fracs)), 5),
        "max": round(float(np.max(fracs)), 5),
    }


def spread_significance(
    storage: Storage,
    n_spk: int,
    n_emo: int,
    bucket_size: int,
    n_perm: int = 20,
    seed: int = 0,
    bank: Optional[np.ndarray] = None,
) -> Dict:
    """Observed level-prototype spread vs its random-bucketing null.

    The absolute spread is scale-dependent (few utterances per cell give a
    large incidental spread even with a random sort), so the question is
    whether sorting by rank score separates levels MORE than a random
    utterance order does.  Returns the observed spread, the null mean and
    95th percentile over ``n_perm`` permutations, and their ratio."""
    observed = prototype_spread(
        _bank_from_storage(storage, n_spk, n_emo, bucket_size)
        if bank is None else bank  # caller may pass the bank it just built
    )
    rng = np.random.default_rng(seed)
    null = []
    for _ in range(n_perm):
        sp = prototype_spread(
            _bank_from_storage(storage, n_spk, n_emo, bucket_size, order=rng))
        if sp is not None:
            null.append(sp["mean_pairwise_over_norm"])
    out = {
        "observed": None if observed is None
        else observed["mean_pairwise_over_norm"],
        "null_mean": round(float(np.mean(null)), 5) if null else None,
        "null_p95": round(float(np.percentile(null, 95)), 5) if null else None,
        "n_perm": n_perm,
    }
    if out["observed"] is not None and out["null_mean"]:
        out["ratio_over_null_mean"] = round(out["observed"] / out["null_mean"], 4)
    return out


def _bank_from_storage(
    storage: Storage,
    n_spk: int,
    n_emo: int,
    bucket_size: int,
    order: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Prototype bank from per-cell (score, frames) entries.  The default
    order is sort-by-rank-score; passing a Generator shuffles the utterances
    instead — the permutation null of :func:`spread_significance`."""
    prototypes = np.zeros((n_spk, n_emo, bucket_size, n_emo), dtype=np.float32)
    for (si, ei), entries in storage.items():
        if order is None:
            entries = sorted(entries, key=lambda x: x[0])
        else:
            entries = [entries[i] for i in order.permutation(len(entries))]
        all_feats = np.concatenate([fr for _, fr in entries], axis=0)
        for bi, idxs in enumerate(np.array_split(np.arange(len(all_feats)), bucket_size)):
            if len(idxs):
                prototypes[si, ei, bi] = all_feats[idxs].mean(axis=0)
    return prototypes


def bucketize(cfg: Config, exp_path: Optional[str] = None, device="cuda",
              mesh: Optional[Mesh] = None) -> str:
    """Load the best rank parameters of an experiment and save
    ``intensity.npy`` and ``intensity_meta.json`` beside them."""
    if exp_path is None:
        exp_path = os.path.join(
            cfg.data.experiment_path, "rank_model", cfg.inference.rank_exp)
    params = load_best_params(exp_path)
    prototypes, storage = compute_intensity_prototypes(
        cfg, params, device=device, return_storage=True, mesh=mesh)
    out_path = os.path.join(exp_path, "intensity.npy")
    np.save(out_path, prototypes)
    # sidecar: is the sorted bank's level spread more than random bucketing
    # produces?
    meta = spread_significance(
        storage, cfg.n_speakers, cfg.n_emotions, cfg.inference.bucket_size,
        bank=prototypes)
    with open(os.path.join(exp_path, "intensity_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return out_path

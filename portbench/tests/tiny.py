"""Cells of the benchmark shrunk to sizes the CPU runs in seconds: the
same files, with widths, depths, lengths and windows cut down.  The
harness runs them through its whole path but the card."""

from __future__ import annotations

import copy
from pathlib import Path

from harness import spec


def bench() -> dict:
    """``BENCHMARK.json`` with the entries of ``unadmitted.json`` that it
    does not hold by name: the cells built but not admitted stay tested."""
    out = spec.benchmark()
    extra = spec.load_json(Path(__file__).with_name("unadmitted.json"))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {e["name"] for e in out[key]}
        out[key] = out[key] + [e for e in extra[key] if e["name"] not in have]
    return out


def fs2_config(cell):
    c = copy.deepcopy(cell.config)
    f, h = c["fastspeech2"], c["hifigan"]
    f.update(enc_num_layers=1, dec_num_layers=1, d_model=32, heads=2, head_dim=16, ffn_dim=64,
             postnet_embedding_dim=16, max_mel_len=96, phone_buckets=[8, 16, 24],
             compute_dtype="float32")
    h.update(upsample_initial_channel=16, upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4],
             vocode_row_frames=384)
    c["audio"]["hop_length"] = 4
    return c


def rank_config(cell):
    c = copy.deepcopy(cell.config)
    c["extractor"].update(layers=1, hidden=32, heads=2, head_dim=16, ffn_dim=64, kernel_size=3)
    c["compute_dtype"] = "float32"
    c["frame_buckets"] = [16, 24, 32]
    return c


def cell(name: str, seconds: float = 1.0):
    cl = spec.Cell(name, bench())
    if cl.config_name == "fs2-hifigan-v1":
        cl.config = fs2_config(cl)
        cl.mix = copy.deepcopy(cl.mix)
        cl.mix["sentence"].update(median_words=2, sigma=0.3, min_words=1, max_words=4, max_phones=20)
        cl.mix.update(vocode_max_rows=2, fs2_rows=[1, 2], sample=3)
        if cl.mix["kind"] == "closed_batch":
            cl.mix.update(warm_calls=1, traced_calls=[0, 1])
        else:
            cl.mix.update(rate_per_s=20.0, warm_s=0.3, traced=[0.1, 0.4], wait_s=30.0)
    else:
        cl.config = rank_config(cl)
        cl.mix = copy.deepcopy(cl.mix)
        cl.mix["corpus"].update(speakers=2, utterances=6, seconds=[0.2, 0.5])
        cl.mix.update(batch_pairs=4, warm_per_bucket=1, traced_steps=[0, 2])
    return cl

"""One process of the port's multi-process tests (tests/test_torch_multiprocess.py).

Launched W times, it joins a ``gloo`` process group through a file store,
builds the port's trainers on the CPU exactly as one process would (seeded
weights, the same config) and runs train steps on its rows of the global
batches.  It writes, per job, the step losses, a digest of the parameters
after every step (bit-identity across ranks), and for step 1 the gradients
and the batch it drew.  Imports nothing of the JAX package.

    python tests/torch_mp_worker.py --init file:///tmp/store --world 2 --rank 0 \
        --config cfg.yaml --out out_0.pt --jobs rank,fs2 --steps 3
"""

import argparse
import hashlib


def _digest(model) -> str:
    h = hashlib.sha1()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def seeded(build):
    """``build()`` with the global generator seeded.  The seeded init
    (``nn.init.seeded_init_``) alone decides a trainer's starting weights
    (tests/test_torch_tensor_parallel.py builds without this); these tests
    keep the seed as they were written."""
    import torch

    torch.manual_seed(0)
    return build()


def _loader_steps(trainer, steps):
    it = iter(trainer._loader("train", shuffle=True).epoch(0))
    return [next(it) for _ in range(steps)]


def run_rank(cfg, steps):
    from emotts_torch.train.rank_trainer import RankTrainer

    trainer = seeded(lambda: RankTrainer(cfg, device="cpu"))
    out = {"losses": [], "digests": []}
    for i, batch in enumerate(_loader_steps(trainer, steps)):
        out["losses"].append(trainer.train_step(batch))
        out["digests"].append(_digest(trainer.model))
        if i == 0:
            out["grads"] = _grads(trainer.model)
    return out


def run_fs2(cfg, steps, weights=None):
    import torch

    from emotts_torch.nn.init import seeded_init_
    from emotts_torch.train.fs2_trainer import (FS2Trainer,
                                                build_intensity_extractor)

    if weights is None:
        extractor = seeded(lambda: seeded_init_(
            build_intensity_extractor(cfg, device="cpu"),
            torch.Generator().manual_seed(5))).state_dict()
        fs2 = None
    else:
        extractor, fs2 = (torch.load(w, weights_only=True) for w in weights)
    trainer = seeded(lambda: FS2Trainer(cfg, extractor, device="cpu"))
    if fs2 is not None:
        trainer.model.load_state_dict(fs2)
    out = {"losses": [], "digests": []}
    for i, batch in enumerate(_loader_steps(trainer, steps)):
        out["losses"].append(trainer.train_step(batch))
        out["digests"].append(_digest(trainer.model))
        if i == 0:
            out["grads"] = _grads(trainer.model)
    return out


def run_vocoder(cfg, steps, wav_paths):
    from emotts_torch.train.vocoder_trainer import SegmentSampler, VocoderTrainer

    trainer = seeded(lambda: VocoderTrainer(cfg, device="cpu"))
    mesh = trainer.mesh
    vc = cfg.train_vocoder
    # the sampler fit() builds: this rank's share of the wavs, its own seed
    sampler = SegmentSampler(wav_paths[mesh.rank::mesh.data], cfg.audio.sampling_rate,
                             trainer.segment_samples, seed=vc.seed + mesh.rank)
    out = {"losses": [], "digests": []}
    for i in range(steps):
        y = sampler.batch(vc.batch_size)
        out["losses"].append(trainer.train_step({"y": y}))
        out["digests"].append(_digest(trainer.gen) + _digest(trainer.disc))
        if i == 0:
            out["y"] = y
            out["grads"] = {"gen": _grads(trainer.gen), "disc": _grads(trainer.disc)}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--jobs", default="rank,fs2,vocoder")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fs2-config", default=None,
                    help="config of the extra fs2_weights job")
    ap.add_argument("--fs2-weights", nargs=2, default=None,
                    metavar=("EXTRACTOR_PT", "FS2_PT"))
    ap.add_argument("--wavs", default=None, help="file listing the vocoder's wavs")
    a = ap.parse_args()

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=a.init, world_size=a.world,
                            rank=a.rank)
    from emotts_torch.utils.config import load_config

    cfg = load_config(a.config)
    result = {}
    for job in a.jobs.split(","):
        if job == "rank":
            result[job] = run_rank(cfg, a.steps)
        elif job == "fs2":
            result[job] = run_fs2(cfg, a.steps)
        elif job == "fs2_weights":
            result[job] = run_fs2(load_config(a.fs2_config), a.steps, a.fs2_weights)
        elif job == "vocoder":
            with open(a.wavs) as f:
                wavs = [ln.strip() for ln in f if ln.strip()]
            result[job] = run_vocoder(cfg, 2, wavs)
        else:
            raise ValueError(f"unknown job {job}")
    torch.save(result, a.out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"[torch_mp_worker rank={a.rank}] ok", flush=True)


if __name__ == "__main__":
    main()

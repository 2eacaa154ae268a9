"""One process of the port's tensor-parallel tests (tests/test_torch_tensor_parallel.py).

Launched W times, it joins a ``gloo`` process group through a file store and
builds the (data, model) grid of ``--model`` M (``make_mesh``), then runs the
jobs it is given on the CPU at toy width: a sharded ``FFTStack`` on weights
carried over from the JAX package, the rank and FS2 trainers (their losses,
digests of the replicated and of the local parameters after every step, the
step-1 gradients gathered to full tensors), a checkpoint written on the grid
and one restored from a single process, ``RankTrainer.fit``, ``remat``
against no ``remat``, and the vocoder trainer.  Builds no trainer under a seeded global generator:
the seeded init alone decides the starting weights.  Imports nothing of the
JAX package.

    python tests/torch_tp_worker.py --init file:///tmp/store --world 2 --rank 0 \\
        --model 2 --config cfg.yaml --data-dir d --out out_0.pt --jobs rank,fs2
"""

import argparse
import copy
import hashlib


def _digest(tensors) -> str:
    h = hashlib.sha1()
    for name, t in sorted(tensors.items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _digests(model) -> dict:
    """Digests of the replicated entries (equal on every rank) and of all
    local entries (equal across a data group)."""
    from emotts_torch.parallel.tp import shard_dim

    sd = model.state_dict()
    return {"replicated": _digest({n: t for n, t in sd.items() if shard_dim(n) is None}),
            "local": _digest(sd)}


def _full_grads(model, mesh) -> dict:
    from emotts_torch.parallel.tp import gather_state_dict

    return gather_state_dict({n: p.grad.detach().clone() for n, p in model.named_parameters()
                              if p.grad is not None}, mesh)


def _batches(trainer, n, skip=0):
    it = iter(trainer._loader("train", shuffle=True).epoch(0))
    out = [next(it) for _ in range(skip + n)]
    return out[skip:]


def _steps(trainer, steps):
    out = {"losses": [], "digests": []}
    for i, batch in enumerate(_batches(trainer, steps)):
        out["losses"].append(trainer.train_step(batch))
        out["digests"].append(_digests(trainer.model))
        if i == 0:
            out["grads"] = _full_grads(trainer.model, trainer.mesh)
    return out


def _extractor(cfg):
    import torch

    from emotts_torch.nn.init import seeded_init_
    from emotts_torch.train.fs2_trainer import build_intensity_extractor

    return seeded_init_(build_intensity_extractor(cfg, device="cpu"),
                        torch.Generator().manual_seed(5)).state_dict()


def run_mesh(mesh):
    return {k: getattr(mesh, k) for k in ("data", "rank", "model", "model_rank", "primary")}


def run_fft(mesh, path):
    """The toy stack of tests/test_tensor_parallel.py, sharded: its forward
    on this rank's rows and the full gradients of mean(y²) over the global
    batch."""
    import torch
    import torch.distributed as dist

    from emotts_torch.nn.blocks import FFTStack
    from emotts_torch.parallel.mesh import global_sum
    from emotts_torch.parallel.tp import gather_state_dict, shard_module_

    data = torch.load(path, weights_only=True)
    stack = FFTStack(num_layers=2, d_model=32, n_heads=2, ffn_dim=64,
                     kernel_sizes=(9, 1), final_norm=True)
    stack.load_state_dict(data["state_dict"])
    shard_module_(stack, mesh)
    x = data["x"]
    per = x.shape[0] // mesh.data
    x = x[mesh.rank * per:(mesh.rank + 1) * per]
    y = stack(x)
    loss = global_sum((y ** 2).sum(), mesh) / (y.numel() * mesh.data)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in stack.named_parameters()}
    if mesh.data > 1:  # every data rank holds its rows' share of each gradient
        for g in grads.values():
            dist.all_reduce(g, group=mesh.group)
            g /= mesh.data
    return {"y": y.detach(), "grads": gather_state_dict(grads, mesh)}


def run_rank(cfg, steps, ckpt_dir=None):
    """``steps`` steps; with ``ckpt_dir``, then a checkpoint written on the
    grid and two steps more (the second moves by the restored moments)."""
    from emotts_torch.train.checkpoint import CheckpointManager
    from emotts_torch.train.rank_trainer import RankTrainer, save_checkpoint

    trainer = RankTrainer(cfg, device="cpu")
    out = _steps(trainer, steps)
    if ckpt_dir is not None:
        ckpt = CheckpointManager(ckpt_dir) if trainer.mesh.primary else None
        save_checkpoint(trainer.state, ckpt)
        out["next_losses"] = [trainer.train_step(b)
                              for b in _batches(trainer, 2, skip=steps)]
    return out


def run_average(mesh):
    """Gradients that differ by rank on a sharded toy stack, then
    ``average_replicated_gradients``."""
    import torch

    from emotts_torch.nn.blocks import FFTStack
    from emotts_torch.parallel.tp import average_replicated_gradients, shard_module_

    stack = shard_module_(FFTStack(1, 32, 2, 64), mesh)
    for i, p in enumerate(stack.parameters()):
        p.grad = torch.full_like(p, float(i + 10 * mesh.model_rank))
    average_replicated_gradients(stack, mesh)
    return {n: p.grad.clone() for n, p in stack.named_parameters()}


def run_fit(cfg, exp_root):
    """``RankTrainer.fit`` on the grid, as the command runs it under
    ``torch.distributed.run``: one epoch, validation, checkpoint, best/."""
    from emotts_torch.train.rank_trainer import RankTrainer

    cfg = copy.deepcopy(cfg)
    cfg.data.experiment_path = exp_root
    cfg.train_rank.n_epochs = 1
    trainer = RankTrainer(cfg, device="cpu")
    return {"exp": trainer.fit(verbose=False), "step": trainer.state.step}


def run_fs2(cfg, steps, weights=None):
    import torch

    from emotts_torch.train.fs2_trainer import FS2Trainer

    if weights is None:
        trainer = FS2Trainer(cfg, _extractor(cfg), device="cpu")
    else:
        from emotts_torch.parallel.tp import shard_state_dict

        extractor, fs2 = (torch.load(w, weights_only=True) for w in weights)
        trainer = FS2Trainer(cfg, extractor, device="cpu")
        trainer.model.load_state_dict(shard_state_dict(fs2, trainer.mesh))
    return _steps(trainer, steps)


def run_restore(cfg, exp):
    """A single process's checkpoint after one step restored on the grid,
    then the steps on the second and third batches."""
    from emotts_torch.train.rank_trainer import RankTrainer

    trainer = RankTrainer(cfg, device="cpu")
    assert trainer.restore(exp)
    return {"losses": [trainer.train_step(b) for b in _batches(trainer, 2, skip=1)]}


def run_remat(cfg):
    """The rank and FS2 steps with and without ``remat``, from the same
    seed on the same batch: whether losses, local gradients and the
    generators' states after the step are bit-identical."""
    import torch

    from emotts_torch.train.fs2_trainer import FS2Trainer
    from emotts_torch.train.rank_trainer import RankTrainer

    out = {}
    for name, build in (("rank", lambda c: RankTrainer(c, device="cpu")),
                        ("fs2", lambda c: FS2Trainer(c, _extractor(c), device="cpu"))):
        runs = []
        for remat in (False, True):
            c = copy.deepcopy(cfg)
            c.rank_model.remat = c.fastspeech2.remat = remat
            trainer = build(c)
            (batch,) = _batches(trainer, 1)
            loss = trainer.train_step(batch)
            runs.append((loss, {n: p.grad.clone() for n, p in trainer.model.named_parameters()},
                         {k: g.get_state() for k, g in trainer.state.generators.items()}))
        (la, ga, sa), (lb, gb, sb) = runs
        out[name] = {"losses": la == lb,
                     "grads": set(ga) == set(gb) and all(torch.equal(ga[n], gb[n]) for n in ga),
                     "generators": all(torch.equal(sa[k], sb[k]) for k in sa),
                     "checked": len(ga)}
    return out


def run_vocoder(cfg, wav_paths):
    from emotts_torch.train.vocoder_trainer import SegmentSampler, VocoderTrainer

    trainer = VocoderTrainer(cfg, device="cpu")
    mesh, vc = trainer.mesh, cfg.train_vocoder
    sampler = SegmentSampler(wav_paths[mesh.rank::mesh.data], cfg.audio.sampling_rate,
                             trainer.segment_samples, seed=vc.seed + mesh.rank)
    y = sampler.batch(vc.batch_size)
    loss = trainer.train_step({"y": y})
    return {"y": y, "loss": loss,
            "digest": _digest(trainer.gen.state_dict()) + _digest(trainer.disc.state_dict())}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--init", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--model", type=int, required=True)
    ap.add_argument("--config", required=True, help="dropout on")
    ap.add_argument("--det-config", default=None, help="every dropout off")
    ap.add_argument("--unfused-config", default=None, help="dropout on, unfused attention")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--jobs", required=True)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()

    import os

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=a.init, world_size=a.world,
                            rank=a.rank)
    from emotts_torch.parallel.mesh import make_mesh
    from emotts_torch.utils.config import load_config

    d = a.data_dir
    cfg = load_config(a.config, [f"mesh.model_parallel={a.model}"])

    def grid(path):
        return load_config(path, [f"mesh.model_parallel={a.model}"])

    result = {}
    for job in a.jobs.split(","):
        if job == "mesh":
            result[job] = run_mesh(make_mesh(cfg.mesh))
        elif job == "fft":
            result[job] = run_fft(make_mesh(cfg.mesh), os.path.join(d, "fft.pt"))
        elif job == "rank":
            result[job] = run_rank(cfg, a.steps, os.path.join(d, f"grid_ckpt_{a.world}"))
        elif job == "rank_unfused":
            result[job] = run_rank(grid(a.unfused_config), 2)
        elif job == "fs2":
            result[job] = run_fs2(cfg, a.steps)
        elif job == "fs2_weights":
            result[job] = run_fs2(grid(a.det_config), a.steps,
                                  (os.path.join(d, "extractor.pt"), os.path.join(d, "fs2.pt")))
        elif job == "average":
            result[job] = run_average(make_mesh(cfg.mesh))
        elif job == "fit":
            result[job] = run_fit(cfg, os.path.join(d, f"fit_{a.world}"))
        elif job == "restore":
            result[job] = run_restore(cfg, os.path.join(d, "one_exp"))
        elif job == "remat":
            result[job] = run_remat(cfg)
        elif job == "vocoder":
            with open(os.path.join(d, "wavs.txt")) as f:
                wavs = [ln.strip() for ln in f if ln.strip()]
            result[job] = run_vocoder(cfg, wavs)
        else:
            raise ValueError(f"unknown job {job}")
    torch.save(result, a.out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"[torch_tp_worker rank={a.rank}] ok", flush=True)


if __name__ == "__main__":
    main()

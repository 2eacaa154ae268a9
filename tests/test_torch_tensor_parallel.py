"""The port's tensor parallelism and block rematerialisation
(emotts_torch/parallel/tp.py, the model axis of parallel/mesh.py, the
sharded FFT blocks of nn/blocks.py, full-tensor checkpoints, the trainers on
a data × model grid, ``FFTStack(remat=True)``) on the CPU at toy width,
fp32, against one process and against the JAX package.

Two worker runs of tests/torch_tp_worker.py (``gloo`` through a file store
under the test's temporary directory) start when the module does and run
while the in-process tests below take their turn: ``model2`` on a 1 × 2 grid
(two processes) and ``grid22`` on a 2 × 2 grid (four processes)."""

import copy
import os
import subprocess
import sys
import uuid
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emotts.data import build_fs2_splits, build_rank_pair_lists, preprocess_all
from emotts.nn import FFTStack as JaxFFTStack
from emotts.parallel.mesh import make_mesh as jax_make_mesh
from emotts.parallel.mesh import shard_batch as jax_shard_batch
from emotts.parallel.tp import shard_params_tp, state_shardings, tp_param_shardings
from emotts.train.fs2_trainer import FS2Trainer as JaxFS2Trainer
from emotts.train.rank_trainer import build_rank_model as jax_build_rank_model
from emotts.train.rank_trainer import init_rank_params
from emotts.utils.config import MeshConfig as JaxMeshConfig
from emotts.utils.config import load_config as jax_load_config
from emotts.utils.config import save_config
from emotts_torch.infer.bucketize import compute_intensity_prototypes
from emotts_torch.infer.synthesize import Synthesizer
from emotts_torch.nn.blocks import FFTStack
from emotts_torch.nn.convert import _params_to_state_dict, fs2_from_flax, rank_from_flax
from emotts_torch.ops.attention import philox_keep_mask
from emotts_torch.parallel import Mesh, make_mesh, shard_dim, shard_module_
from emotts_torch.parallel.mesh import RowDraws
from emotts_torch.parallel.tp import HEAD_MIX, offset_seeds
from emotts_torch.train.checkpoint import CheckpointManager
from emotts_torch.train.fs2_trainer import FS2Trainer, extractor_params_from_rank
from emotts_torch.train.rank_trainer import (RankTrainer, build_rank_model,
                                             init_rank_model)
from emotts_torch.train.vocoder_trainer import VocoderTrainer
from emotts_torch.utils.config import Config, MeshConfig, load_config
from tests.synthetic_corpus import make_corpus
from tests.test_torch_multiprocess import (_assert_close_grads,
                                           _assert_close_losses, _one_process,
                                           _tiny, dataclass_unfused)
from tests.torch_mp_worker import _grads
from tests.torch_tp_worker import _extractor
from tests.torch_port_util import (SMALL_VOCODER, fs2_variables, jit,
                                   rank_variables, shrink,
                                   single_torch_thread,  # noqa: F401
                                   vocoder_params)

REPO = Path(__file__).resolve().parent.parent
STEPS = 3
RTOL = 1e-5  # a step on the grid against one process on the global batch
GRIDS = {"model2": (2, 2), "grid22": (4, 2)}  # name: (processes, model axis)
JOBS = {"model2": "mesh,average,fft,rank,rank_unfused,fs2,restore,fit,remat,vocoder",
        "grid22": "mesh,fft,rank,fs2,fs2_weights,remat"}


def _jax_stack():
    """tests/test_tensor_parallel.py's stack, its weights and input."""
    stack = JaxFFTStack(num_layers=2, d_model=32, n_heads=2, ffn_dim=64,
                        kernel_sizes=(9, 1), final_norm=True)
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 12, 32))
    params = stack.init(jax.random.PRNGKey(1), x)
    return stack, params, x


class Grid:
    """The worker runs, started at once and read when a test needs them."""

    def __init__(self, root, paths):
        self.procs, self.results = {}, {}
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        for name, (world, model) in GRIDS.items():
            store = f"file://{root / f'store_{uuid.uuid4().hex}'}"
            runs = []
            for rank in range(world):
                out = root / f"{name}_{rank}.pt"
                log = open(root / f"{name}_{rank}.log", "w")
                proc = subprocess.Popen(
                    [sys.executable, str(REPO / "tests" / "torch_tp_worker.py"),
                     "--init", store, "--world", str(world), "--rank", str(rank),
                     "--model", str(model), "--config", paths["cfg"],
                     "--det-config", paths["det"], "--unfused-config", paths["unfused"],
                     "--data-dir", str(root), "--out", str(out), "--jobs", JOBS[name],
                     "--steps", str(STEPS)],
                    cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT)
                runs.append((proc, out, log))
            self.procs[name] = runs

    def __call__(self, name):
        """Every rank's result dict of run ``name``."""
        if name not in self.results:
            runs = self.procs[name]
            try:
                for proc, _, _ in runs:
                    proc.wait(timeout=600)
            finally:
                for proc, _, log in runs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    log.close()
            for rank, (proc, out, log) in enumerate(runs):
                assert proc.returncode == 0, (
                    f"{name} rank {rank} failed:\n{Path(log.name).read_text()[-4000:]}")
            self.results[name] = [torch.load(out, weights_only=False) for _, out, _ in runs]
        return self.results[name]

    def close(self):
        for runs in self.procs.values():
            for proc, _, log in runs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus preprocessed by the JAX package; configs with
    dropout on (fused attention: ``cfg``; unfused: ``unfused``) and off
    (``det``); what the workers read: the vocoder's wavs, the toy stack's
    weights, the JAX weights of the FS2 comparison, and a one-process
    checkpoint after one rank step (``one_exp``)."""
    root = tmp_path_factory.mktemp("torch_tp")
    jcfg = make_corpus(str(root), utts_per_emotion=5)
    preprocess_all(jcfg, verbose=False)
    build_rank_pair_lists(jcfg)
    build_fs2_splits(jcfg)
    paths = {}
    for name, dropout in (("cfg", True), ("det", False), ("unfused", True)):
        cfg = _tiny(copy.deepcopy(jcfg), dropout)
        if name == "unfused":
            cfg.rank_model.fused_attention = cfg.fastspeech2.fused_attention = False
        paths[name] = str(root / f"{name}.yaml")
        save_config(cfg, paths[name])
    wavs = sorted(str(p) for p in (root / "corpus").glob("*/*.wav"))
    Path(root / "wavs.txt").write_text("\n".join(wavs))

    _, params, x = _jax_stack()
    torch.save({"x": torch.from_numpy(np.array(x)),
                "state_dict": _params_to_state_dict(params["params"])},
               root / "fft.pt")

    det = jax_load_config(paths["det"])
    _, fs2_vars = fs2_variables(dataclass_unfused(det), seed=31)
    rm = det.rank_model
    _, rank_vars = rank_variables(seed=32, n_mels=det.audio.n_mels, n_layers=1,
                                  n_emotions=det.n_emotions,
                                  kernel_size=rm.kernel_size, dropout=0.0)
    torch.save(extractor_params_from_rank(rank_from_flax(rank_vars)), root / "extractor.pt")
    torch.save(fs2_from_flax(fs2_vars), root / "fs2.pt")

    one = RankTrainer(load_config(paths["cfg"]), device="cpu")
    it = iter(one._loader("train", shuffle=True).epoch(0))
    one.train_step(next(it))
    CheckpointManager(str(root / "one_exp")).save(one.state)
    restored_ref = [one.train_step(next(it)) for _ in range(2)]
    return root, paths, fs2_vars, rank_vars, restored_ref


@pytest.fixture(scope="module")
def grid(corpus):
    root, paths = corpus[:2]
    runs = Grid(root, paths)
    yield runs
    runs.close()


@pytest.fixture(scope="module", autouse=True)
def _start_workers(grid):
    """The worker runs start before the first test of the module."""


# -- the rules, the draws and remat in one process -----------------------------


def _coordinate_tree(params, axis_of):
    """``params`` with every leaf replaced by its coordinate along the axis
    ``axis_of(path)`` gives (zeros where None)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.zeros(np.shape(node), np.float32)
        axis = axis_of(path)
        if axis is not None:
            shape = [1] * a.ndim
            shape[axis] = a.shape[axis]
            a = a + np.arange(a.shape[axis], dtype=np.float32).reshape(shape)
        return a

    return walk(params, ())


def test_shard_rules_match_the_jax_package():
    """The names the port shards and the dim of each are the JAX package's
    ``tp_param_shardings`` carried through nn/convert.py: each sharded JAX
    leaf is filled with its coordinate along the model axis, converted, and
    the one port dim along which the values move is the sharded dim."""
    _, params, _ = _jax_stack()
    mesh = jax_make_mesh(JaxMeshConfig(data_parallel=4, model_parallel=2))
    flat = jax.tree_util.tree_flatten_with_path(tp_param_shardings(params["params"], mesh))[0]
    spec_axis = {}
    for path, s in flat:
        keys = tuple(getattr(p, "key", str(p)) for p in path)
        axes = [i for i, a in enumerate(s.spec) if a == "model"]
        spec_axis[keys] = axes[0] if axes else None
    coords = _params_to_state_dict(_coordinate_tree(params["params"],
                                                    lambda p: spec_axis[p]))
    want = {}
    for name, t in coords.items():
        moving = [d for d in range(t.dim()) if t.shape[d] > 1
                  and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        assert len(moving) <= 1, name
        want[name] = moving[0] if moving else None
    got = {name: shard_dim(name) for name in FFTStack(
        2, 32, 2, 64, (9, 1), final_norm=True).state_dict()}
    assert got == want
    assert sum(d is not None for d in got.values()) == 2 * 10  # 10 a block


def test_offset_seeds_give_the_local_heads_of_the_full_mask():
    """The fused kernels' mask on a rank's heads h0… with seeds offset by
    h0·HEAD_MIX is those heads of the unsharded mask, bit for bit (int32
    wrap-around included)."""
    seeds = torch.tensor([2 ** 31 - 5, -2 ** 31 + 3, 0, 123456789], dtype=torch.int32)
    full = philox_keep_mask(seeds, 4, 9, 0.3)
    for h0, h in ((0, 2), (2, 2), (1, 1), (3, 1)):
        local = philox_keep_mask(offset_seeds(seeds, h0), h, 9, 0.3)
        assert torch.equal(local, full[:, h0:h0 + h])
    wrapped = offset_seeds(seeds, 3).to(torch.int64)
    want = ((seeds.to(torch.int64) + 3 * HEAD_MIX + 2 ** 31) % 2 ** 32) - 2 ** 31
    assert torch.equal(wrapped, want)


def test_shard_module_refuses_an_indivisible_model_axis():
    stack = FFTStack(1, 32, 2, 64)
    fake = Mesh(1, (torch.device("cpu"),), model=4, model_rank=0, model_group=object())
    with pytest.raises(ValueError, match="does not divide n_heads=2"):
        shard_module_(stack, fake)
    odd_ffn = FFTStack(1, 32, 4, 66)
    with pytest.raises(ValueError, match="does not divide ffn_dim=66"):
        shard_module_(odd_ffn, fake)


def test_trainers_start_from_their_seed_alone(corpus):
    """Two builds of each trainer with one seed give equal weights whatever
    the global generator's state, and every bias starts at zero as flax's
    do (the JAX package's ``init_rank_params``)."""
    _, paths = corpus[:2]
    cfg = load_config(paths["cfg"])
    builds = {"rank": lambda: RankTrainer(cfg, device="cpu"),
              "fs2": lambda: FS2Trainer(cfg, _extractor(cfg), device="cpu")}
    for name, build in builds.items():
        sds = []
        for seed in (1, 2):
            torch.manual_seed(seed)
            sds.append(build().model.state_dict())
        assert sds[0].keys() == sds[1].keys()
        for k in sds[0]:
            assert torch.equal(sds[0][k], sds[1][k]), (name, k)
    jcfg = dataclass_unfused(jax_load_config(paths["cfg"]))
    jparams = rank_from_flax(init_rank_params(jcfg, jax_build_rank_model(jcfg)))
    port = RankTrainer(cfg, device="cpu").model.state_dict()
    assert set(jparams) == set(port)
    for name, t in port.items():
        if name.endswith("bias") or t.dim() == 1:
            assert torch.equal(t, torch.from_numpy(np.asarray(jparams[name]))), name
    assert sum(name.endswith("bias") for name in port) > 0


def _remat_step(build, cfg, remat):
    c = copy.deepcopy(cfg)
    c.rank_model.remat = c.fastspeech2.remat = remat
    trainer = build(c)
    batch = next(iter(trainer._loader("train", shuffle=True).epoch(0)))
    loss = trainer.train_step(batch)
    return (loss, _grads(trainer.model),
            {k: g.get_state() for k, g in trainer.state.generators.items()})


def _assert_remat_bit_identical(cfg):
    extractor = _extractor(cfg)
    for build in (lambda c: RankTrainer(c, device="cpu"),
                  lambda c: FS2Trainer(c, extractor, device="cpu")):
        (la, ga, sa), (lb, gb, sb) = (_remat_step(build, cfg, r) for r in (False, True))
        assert la == lb
        assert ga.keys() == gb.keys() and all(torch.equal(ga[n], gb[n]) for n in ga)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("attention", ["fused", "unfused"])
def test_remat_step_is_bit_identical(corpus, attention):
    """Dropout on: the rank and FS2 train steps with ``remat`` give the
    same losses, gradients and generator states as without, bit for bit."""
    _, paths = corpus[:2]
    cfg = load_config(paths["cfg" if attention == "fused" else "unfused"])
    assert cfg.rank_model.dropout > 0 and cfg.fastspeech2.enc_dropout > 0
    _assert_remat_bit_identical(cfg)


def test_remat_replays_row_draws():
    """Under a ``RowDraws`` (this rank's rows of the global draws, data 2)
    the stack's remat forward and backward equal the plain ones, and the
    generator ends where the plain step leaves it."""
    torch.manual_seed(0)
    stack = FFTStack(2, 32, 2, 64, (9, 9), dropout=0.2, ffn_internal_dropout=True)
    x = torch.randn(3, 10, 32)
    outs = []
    for remat in (False, True):
        stack.remat = remat
        gen = torch.Generator().manual_seed(7)
        xi = x.clone().requires_grad_()
        y = stack(xi, None, False, RowDraws(gen, 1, 2))
        grads = torch.autograd.grad((y ** 2).sum(), [xi] + list(stack.parameters()))
        outs.append((y.detach(), grads, gen.get_state()))
    (ya, ga, sa), (yb, gb, sb) = outs
    assert torch.equal(ya, yb) and torch.equal(sa, sb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


# -- serving over a model_parallel mesh ------------------------------------------

CPU4 = ["cpu"] * 4
VOCODER = dict(SMALL_VOCODER, in_channels=80, upsample_rates=(8, 8, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4), upsample_initial_channel=32)


def test_serving_mesh_takes_devices_over_model_parallel(corpus):
    """``mesh.model_parallel=2`` over four devices of one process: a data
    axis of 2 with replicated weights, as the JAX package's
    ``load_synthesizer`` takes it; the requests and the bank equal the
    unsharded ones."""
    mesh = make_mesh(MeshConfig(model_parallel=2), devices=CPU4)
    assert (mesh.data, mesh.model, len(mesh.devices)) == (2, 1, 2)
    with pytest.raises(ValueError, match="mesh 3x2 needs 6 devices, have 4"):
        make_mesh(MeshConfig(data_parallel=3, model_parallel=2), devices=CPU4)

    jcfg = shrink(Config(), fused=False)
    _, variables = fs2_variables(jcfg, seed=41)
    _, voc_tree = vocoder_params(VOCODER, seed=42, scale=0.05)
    bank = np.random.default_rng(43).standard_normal((3, 3, 3, 3)).astype(np.float32)
    one, two = (Synthesizer(shrink(Config()), variables, voc_tree, bank,
                            vocoder_structure=VOCODER, device="cpu", mesh=m)
                for m in (None, mesh))
    assert len(two._replicas) == 2
    requests = [{"text": "Quite well. Thank you.", "speaker": 1, "emotion": 2},
                {"text": "Blended voice.", "speaker": 0, "emotion": 1, "level": 1.5}]
    for a, b in zip(two.synthesize_requests(requests), one.synthesize_requests(requests)):
        assert len(a) == len(b) > 0
        assert np.abs(np.round(np.asarray(a, np.float64) * 32767)
                      - np.round(np.asarray(b, np.float64) * 32767)).max() <= 1

    _, paths = corpus[:2]
    cfg = load_config(paths["det"])
    params = init_rank_model(build_rank_model(cfg, dtype=torch.float32, device="cpu"),
                             3).state_dict()
    want = compute_intensity_prototypes(cfg, params, device="cpu")
    got = compute_intensity_prototypes(cfg, params, device="cpu", mesh=mesh)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- the grid runs -----------------------------------------------------------------


def _assert_replicated_in_lockstep(runs, job, model):
    """The replicated parameters bit-identical on every rank after every
    step; all local ones across each data group; equal losses."""
    digests = [r[job]["digests"] for r in runs]
    for step in range(len(digests[0])):
        assert len({d[step]["replicated"] for d in digests}) == 1, (job, step)
        for m in range(model):
            assert len({d[step]["local"] for d in digests[m::model]}) == 1, (job, step)
    assert all(r[job]["losses"] == runs[0][job]["losses"] for r in runs)


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_is_made_from_the_world(grid, name):
    world, model = GRIDS[name]
    meshes = [r["mesh"] for r in grid(name)]
    for rank, mesh in enumerate(meshes):
        assert mesh == dict(data=world // model, rank=rank // model, model=model,
                            model_rank=rank % model, primary=rank == 0)


def test_replicated_gradients_are_averaged_over_the_model_group(grid):
    """Rank r's gradient of its i-th parameter set to i + 10·r: every
    replicated one becomes the mean over the two ranks (i + 5), every
    shard keeps its own."""
    runs = [r["average"] for r in grid("model2")]
    for rank, grads in enumerate(runs):
        for i, (name, g) in enumerate(grads.items()):
            want = i + 5.0 if shard_dim(name) is None else i + 10.0 * rank
            assert torch.equal(g, torch.full_like(g, want)), name


@pytest.mark.parametrize("name", list(GRIDS))
def test_sharded_stack_matches_the_jax_package(grid, name):
    """The toy stack on the grid against the JAX stack unsharded and sharded
    by ``shard_params_tp`` on the 4 × 2 mesh: forward at rtol/atol 2e-5,
    gradients (gathered) at rtol 5e-5 / atol 5e-6."""
    stack, params, x = _jax_stack()

    def loss(p, x):
        return (stack.apply(p, x) ** 2).mean()

    mesh = jax_make_mesh(JaxMeshConfig(data_parallel=4, model_parallel=2))
    params_tp = shard_params_tp(params, mesh)
    x_sh = jax_shard_batch(mesh, {"x": np.asarray(x)})["x"]
    refs = [(np.asarray(jit(stack.apply)(p, xx)),
             rank_from_flax(jax.device_get(jit(jax.grad(loss))(p, xx))))
            for p, xx in ((params, x), (params_tp, x_sh))]
    runs = grid(name)
    y = np.concatenate([r["fft"]["y"].numpy() for r in runs[::GRIDS[name][1]]])
    for want_y, want_g in refs:
        np.testing.assert_allclose(y, want_y, rtol=2e-5, atol=2e-5)
        for r in runs:
            got = r["fft"]["grads"]
            assert set(got) == set(want_g)
            for k, g in got.items():
                np.testing.assert_allclose(g.numpy(), want_g[k].numpy(),
                                           rtol=5e-5, atol=5e-6, err_msg=k)


@pytest.fixture(scope="module")
def one_process(corpus):
    """The rank and FS2 trainers' steps in one process on the global
    batches: (losses, step-1 gradients) per trainer."""
    _, paths = corpus[:2]
    cfg = load_config(paths["cfg"])
    return {"rank": _one_process(RankTrainer(cfg, device="cpu")),
            "fs2": _one_process(FS2Trainer(cfg, _extractor(cfg), device="cpu"))}


@pytest.mark.parametrize("name,job", [("model2", "rank"), ("model2", "fs2"),
                                      ("grid22", "rank"), ("grid22", "fs2")])
def test_trainers_on_the_grid_equal_one_process(grid, one_process, name, job):
    """Dropout (fused-attention seeds offset per rank, the FFN-internal
    masks sliced at the full width) and mixup on: the replicated parameters
    in lockstep, the steps those of one process on the global batches
    (losses at 1e-5, step-1 gradients within 1e-4 of each one's largest
    entry)."""
    runs = grid(name)
    _assert_replicated_in_lockstep(runs, job, GRIDS[name][1])
    losses, grads = one_process[job]
    _assert_close_losses(runs[0][job]["losses"], losses)
    for r in runs:
        _assert_close_grads(r[job]["grads"], grads)


def test_unfused_dropout_on_the_model_axis_equals_one_process(corpus, grid):
    """The unfused attention's probability mask and the FFN-internal mask,
    drawn at the full width and sliced per rank: two steps at M = 2 equal
    one process."""
    _, paths = corpus[:2]
    runs = grid("model2")
    _assert_replicated_in_lockstep(runs, "rank_unfused", 2)
    losses, grads = _one_process(RankTrainer(load_config(paths["unfused"]), device="cpu"),
                                 steps=2)
    _assert_close_losses(runs[0]["rank_unfused"]["losses"], losses)
    _assert_close_grads(runs[1]["rank_unfused"]["grads"], grads)


@pytest.mark.parametrize("name", list(GRIDS))
def test_remat_on_the_grid_is_bit_identical(grid, name):
    for r in grid(name):
        for job, checks in r["remat"].items():
            assert checks["checked"] > 0
            assert checks["losses"] and checks["grads"] and checks["generators"], (job, checks)


def test_grid_checkpoint_holds_full_tensors_and_restores_in_one_process(corpus, grid):
    """Written at M = 2 after three steps: full tensors (parameters and
    AdamW moments); restored in one process, the next two steps (the second
    moved by the restored moments) equal the grid's."""
    root, paths = corpus[:2]
    runs = grid("model2")
    exp = str(root / "grid_ckpt_2")
    ckpt = CheckpointManager(exp)
    assert ckpt.latest_step() == STEPS
    saved = torch.load(Path(exp) / "checkpoints" / f"step_{STEPS}.pt", weights_only=False)
    one = RankTrainer(load_config(paths["cfg"]), device="cpu")
    full = one.model.state_dict()
    assert {k: v.shape for k, v in saved["model"].items()} == {k: v.shape for k, v in full.items()}
    moments = saved["optimizer"]["state"]
    params = list(one.model.parameters())
    assert all(moments[i]["mu"].shape == p.shape for i, p in enumerate(params))
    assert one.restore(exp)
    it = iter(one._loader("train", shuffle=True).epoch(0))
    for _ in range(STEPS):
        next(it)
    losses = [one.train_step(next(it)) for _ in range(2)]
    for r in runs:
        _assert_close_losses(r["rank"]["next_losses"], losses)


def test_one_process_checkpoint_restores_on_the_grid(corpus, grid):
    """A one-process checkpoint (after one step) restored at M = 2: the next
    two steps equal the one process's."""
    for r in grid("model2"):
        _assert_close_losses(r["restore"]["losses"], corpus[4])


def test_fit_on_the_grid_writes_one_experiment_of_full_tensors(corpus, grid):
    """``RankTrainer.fit`` at M = 2 (what ``train-rank`` runs under
    ``torch.distributed.run`` with ``mesh.model_parallel=2``): one
    experiment directory, whose ``best/`` export loads into a whole model."""
    from emotts_torch.train.checkpoint import load_best_params

    root, paths = corpus[:2]
    a, b = (r["fit"] for r in grid("model2"))
    assert a == b and a["step"] > 0
    assert sorted(p.name for p in (root / "fit_2" / "rank_model").iterdir()) == ["exp_1"]
    model = build_rank_model(load_config(paths["cfg"]), dtype=torch.float32, device="cpu")
    model.load_state_dict(load_best_params(a["exp"]))  # strict: every full shape
    assert CheckpointManager(a["exp"]).latest_step() == a["step"]


def test_vocoder_replicates_on_the_model_axis(corpus, grid):
    """Data 1 × model 2: both ranks run the same rows and stay bit-identical,
    and equal one process on those rows."""
    _, paths = corpus[:2]
    a, b = (r["vocoder"] for r in grid("model2"))
    assert a["digest"] == b["digest"] and a["loss"] == b["loss"]
    assert np.array_equal(a["y"], b["y"])
    one = VocoderTrainer(load_config(paths["cfg"]), device="cpu")
    _assert_close_losses([a["loss"]], [one.train_step({"y": a["y"]})])


def test_fs2_on_the_grid_matches_the_jax_trainer_on_eight_devices(corpus, grid):
    """Dropout 0: the 2 × 2 grid's FS2 steps against
    emotts.train.fs2_trainer.FS2Trainer on the 4 × 2 mesh, its state placed
    by ``state_shardings``: losses within 1e-4 relative, step-1 gradients
    within 1e-4 of each one's largest entry."""
    _, paths, fs2_vars, rank_vars, _ = corpus
    runs = grid("grid22")
    _assert_replicated_in_lockstep(runs, "fs2_weights", 2)
    jcfg = dataclass_unfused(jax_load_config(paths["det"]))
    jcfg.mesh.data_parallel, jcfg.mesh.model_parallel = 4, 2
    trainer = JaxFS2Trainer(jcfg, {"params": rank_vars["params"]["intensity_extractor"]})
    assert dict(trainer.mesh.shape) == {"data": 4, "model": 2}

    def stash():
        """Keeps each step's gradients in its state, passes them on."""
        return optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))

    trainer.tx = optax.chain(stash(), trainer.tx)
    params = jax.tree_util.tree_map(jnp.asarray, fs2_vars["params"])
    state = trainer.state.replace(
        params=params, opt_state=trainer.tx.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, fs2_vars["batch_stats"]))
    state = jax.device_put(state, state_shardings(state, trainer.mesh))
    step = jit(trainer._train_step_fn)
    it = iter(trainer._loader("train", shuffle=True).epoch(0))
    losses = []
    for i in range(STEPS):
        db = jax_shard_batch(trainer.mesh, trainer._device_batch(next(it)))
        state, metrics = step(state, trainer.extractor_params, db)
        losses.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            grads = fs2_from_flax({"params": jax.device_get(state.opt_state[0]),
                                   "batch_stats": fs2_vars["batch_stats"]})
    for r in runs:
        _assert_close_losses(r["fs2_weights"]["losses"], losses, rtol=1e-4)
        _assert_close_grads(r["fs2_weights"]["grads"],
                            {k: v for k, v in grads.items() if k in r["fs2_weights"]["grads"]})

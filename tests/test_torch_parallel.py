"""The port's data axis in one process (emotts_torch/parallel, the loader's
process rows, the global-shape draws, sharded bucketization and synthesis),
held against the JAX package where it has a counterpart."""

import numpy as np
import pytest
import torch

from emotts.data import build_rank_pair_lists, preprocess_all
from emotts.data.loader import BucketLoader as JaxLoader
from emotts.infer.synthesize import Synthesizer as JaxSynthesizer
from emotts.parallel import mesh as jax_mesh
from emotts.utils.config import Config as JaxConfig
from emotts.utils.config import MeshConfig as JaxMeshConfig
from emotts.utils.config import save_config
from emotts_torch.data.loader import BucketLoader
from emotts_torch.infer.bucketize import compute_intensity_prototypes
from emotts_torch.infer.synthesize import Synthesizer
from emotts_torch.nn.blocks import draw_attention_seeds, dropout
from emotts_torch.parallel import (Mesh, RowDraws, average_gradients,
                                   data_axis_size, draw_rows, global_sum,
                                   make_mesh, replicate, round_up_to_multiple,
                                   row_draws, shard_batch, shard_module_)
from emotts_torch.parallel.mesh import local_mesh, one_device, serving_mesh
from emotts_torch.train.rank_trainer import (RankTrainer, build_rank_model,
                                             init_rank_model)
from emotts_torch.utils.config import Config, MeshConfig, load_config
from tests.synthetic_corpus import make_corpus
from tests.torch_mp_worker import seeded
from tests.torch_port_util import (SMALL_VOCODER, fs2_variables, shrink,
                                   vocoder_params,
                                   single_torch_thread)  # noqa: F401

CPU2 = ["cpu", "cpu"]


def test_make_mesh_sizes():
    mesh = make_mesh()
    assert (mesh.data, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.devices == (torch.device("cpu"),) and not mesh.distributed
    two = make_mesh(devices=CPU2)
    assert two.data == 2 and len(two.devices) == 2 and two.primary
    assert make_mesh(MeshConfig(data_parallel=1), devices=CPU2).data == 1
    assert make_mesh(MeshConfig(data_parallel=3), devices=["cpu"] * 4).data == 3
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_mesh(MeshConfig(data_parallel=3), devices=CPU2)


@pytest.mark.parametrize("case", ["accepted", "indivisible_heads", "off_the_world"])
def test_model_parallel_grid(case, tmp_path):
    """``mesh.model_parallel``: M = 2 accepted (a data axis of devices / 2
    in one process; the model group of a process group in
    tests/test_torch_tensor_parallel.py); M = 4 refused where it does not
    divide the 2 heads; ``data · model`` other than the world refused."""
    cfg = Config()
    if case == "accepted":
        mesh = make_mesh(MeshConfig(model_parallel=2), devices=["cpu"] * 4)
        assert (mesh.data, mesh.model, mesh.primary) == (2, 1, True)
        model = build_rank_model(cfg, dtype=torch.float32, device="cpu")
        grid = Mesh(1, (torch.device("cpu"),), model=2, model_rank=1, model_group=object())
        shard_module_(model, grid)
        attn = model.intensity_extractor.fft.layers[0].attn
        assert attn.query.weight.shape == (cfg.rank_model.hidden_dim // 2,
                                           cfg.rank_model.hidden_dim)
        assert attn.model_axis.rank == 1
    elif case == "indivisible_heads":
        assert cfg.rank_model.n_heads == 2
        model = build_rank_model(cfg, dtype=torch.float32, device="cpu")
        grid = Mesh(1, (torch.device("cpu"),), model=4, model_rank=0, model_group=object())
        with pytest.raises(ValueError, match="does not divide n_heads=2"):
            shard_module_(model, grid)
        with pytest.raises(ValueError, match="mesh 1x4 needs 4 devices, have 2"):
            make_mesh(MeshConfig(model_parallel=4), devices=CPU2)
    else:
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
        try:
            with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
                make_mesh(MeshConfig(model_parallel=2))
            with pytest.raises(ValueError, match="mesh 3x1 needs 3 devices, have 1"):
                make_mesh(MeshConfig(data_parallel=3))
        finally:
            torch.distributed.destroy_process_group()


def test_round_up_and_data_axis_size_match_the_reference():
    for n in range(0, 20):
        for m in (0, 1, 2, 3, 4, 8):
            assert round_up_to_multiple(n, m) == jax_mesh.round_up_to_multiple(n, m)
    for dp in (-1, 2, 4, 8):
        want = jax_mesh.data_axis_size(jax_mesh.make_mesh(JaxMeshConfig(data_parallel=dp)))
        got = data_axis_size(make_mesh(MeshConfig(data_parallel=dp),
                                       devices=["cpu"] * 8))
        assert got == want
    assert data_axis_size(None) == 1


class _Dataset:
    """Lengths and (index, length, phone count) examples: enough for both
    packages' loaders."""

    def __init__(self, n=23, seed=0):
        rng = np.random.default_rng(seed)
        self.lengths = rng.integers(4, 40, n).tolist()
        self.phones = rng.integers(2, 30, n).tolist()

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        return i

    def length_of(self, i):
        return self.lengths[i]


def _collate(examples, bucket, phone_bucket=None):
    return {"idx": np.asarray(examples, np.int64),
            "bucket": np.full(len(examples), bucket, np.int64),
            "phone_bucket": np.full(len(examples), -1 if phone_bucket is None
                                    else phone_bucket, np.int64)}


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_process_rows_match_the_reference(shuffle):
    """Each of two processes gets the reference loader's example indices
    and row_valid, epoch by epoch."""
    ds = _Dataset()
    kw = dict(buckets=[16, 32, 48], batch_size=4, shuffle=shuffle, seed=3,
              drop_last=shuffle, pad_to_multiple=2, process_count=2)
    for pi in range(2):
        want = JaxLoader(ds, collate=_collate, process_index=pi, **kw)
        got = BucketLoader(ds, collate=_collate, process_index=pi, **kw)
        for epoch in (0, 1):
            assert got.plan_epoch(epoch) == want.plan_epoch(epoch)
            pairs = list(zip(got.epoch(epoch), want.epoch(epoch)))
            assert len(pairs) == want.batches_per_epoch(epoch) > 0
            for a, b in pairs:
                assert len(a["idx"]) == 2
                for key in ("idx", "bucket", "row_valid"):
                    np.testing.assert_array_equal(a[key], b[key])
    # the processes' rows make up the one-process batch
    one = BucketLoader(ds, collate=_collate, **dict(kw, process_count=1))
    parts = [BucketLoader(ds, collate=_collate, process_index=pi, **kw).epoch(0)
             for pi in range(2)]
    full = [b for b in one.epoch(0) if len(b["idx"]) == 4]
    for whole, a, b in zip(full, *parts):
        np.testing.assert_array_equal(whole["idx"], np.concatenate([a["idx"], b["idx"]]))
    with pytest.raises(ValueError):
        BucketLoader(ds, [16], 5, _collate, process_count=2)
    with pytest.raises(ValueError):
        BucketLoader(ds, [16], 4, _collate, process_index=2, process_count=2)


def test_loader_batch_shape_is_decided_on_the_global_batch():
    ds = _Dataset(seed=1)
    shape = lambda idxs: {"phone_bucket": max(ds.phones[i] for i in idxs)}  # noqa: E731
    kw = dict(buckets=[16, 32, 48], batch_size=4, seed=2, process_count=2,
              batch_shape=shape)
    a, b = (list(BucketLoader(ds, collate=_collate, process_index=pi, **kw).epoch(0))
            for pi in range(2))
    assert a
    for x, y in zip(a, b):
        whole = np.concatenate([x["idx"], y["idx"]])
        want = max(ds.phones[i] for i in whole)
        assert set(x["phone_bucket"]) == set(y["phone_bucket"]) == {want}


@pytest.mark.parametrize("groups,dim", [(1, 0), (2, 0), (1, 1)])
def test_row_draws_give_each_row_the_one_process_draw(groups, dim):
    world, b = 3, 2
    local = [4, 5, 6]
    local[dim] = groups * b
    glob = list(local)
    glob[dim] = groups * b * world
    want = torch.rand(glob, generator=torch.Generator().manual_seed(7))
    blocks = want.split(b * world, dim=dim)  # the groups' global blocks
    for rank in range(world):
        gen = RowDraws(torch.Generator().manual_seed(7), rank, world).grouped(groups)
        got = draw_rows(torch.rand, local, gen, dim=dim)
        own = torch.cat([blk.narrow(dim, rank * b, b) for blk in blocks], dim=dim)
        assert torch.equal(got, own)
    # a plain generator draws the local shape itself
    plain = draw_rows(torch.rand, local, torch.Generator().manual_seed(7), dim=dim)
    assert torch.equal(plain, torch.rand(local, generator=torch.Generator().manual_seed(7)))


def test_dropout_and_attention_seeds_follow_the_global_rows():
    x = torch.ones(6, 5, 3)
    want = dropout(x, 0.3, torch.Generator().manual_seed(1))
    seeds = draw_attention_seeds(6, torch.Generator().manual_seed(2), "cpu")
    for rank in range(2):
        rows = slice(3 * rank, 3 * rank + 3)
        got = dropout(x[rows], 0.3, RowDraws(torch.Generator().manual_seed(1), rank, 2))
        assert torch.equal(got, want[rows])
        s = draw_attention_seeds(3, RowDraws(torch.Generator().manual_seed(2), rank, 2),
                                 "cpu")
        assert torch.equal(s, seeds[rows])


def test_one_process_helpers_are_the_identity():
    mesh = make_mesh(devices=CPU2)
    gen = torch.Generator()
    assert row_draws(gen, mesh) is gen and row_draws(gen, None) is gen
    t = torch.arange(3.0)
    assert global_sum(t, mesh) is t
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    average_gradients([p], mesh)
    assert torch.equal(p.grad, torch.full((2,), 3.0))


def test_shard_batch_and_replicate_in_one_process():
    mesh = make_mesh(devices=CPU2)
    batch = {"a": np.arange(8).reshape(4, 2), "b": torch.arange(4), "name": "x"}
    shards = shard_batch(mesh, batch)
    assert len(shards) == 2
    np.testing.assert_array_equal(shards[1]["a"], batch["a"][2:])
    assert torch.equal(shards[0]["b"], torch.arange(2)) and shards[0]["name"] == "x"
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(mesh, {"a": np.zeros(3)})
    lin = torch.nn.Linear(2, 2)
    replicas = replicate(mesh, lin)
    assert len(replicas) == 2 and replicas[0] is lin and replicas[1] is not lin
    assert torch.equal(replicas[1].weight, lin.weight)


def test_meshes_that_do_not_fit_are_refused():
    cfg = Config()
    with pytest.raises(ValueError, match="one device per process"):
        RankTrainer(cfg, device="cpu", mesh=make_mesh(devices=CPU2))
    group_mesh = Mesh(2, (torch.device("cpu"),), 1, object())
    with pytest.raises(ValueError, match="devices of one process"):
        local_mesh(group_mesh, "Synthesizer")
    assert local_mesh(make_mesh(), "Synthesizer") is None
    assert one_device(group_mesh, "x") == torch.device("cpu")
    # serving engages a mesh by itself only over several GPUs
    assert serving_mesh(MeshConfig(), "cpu") is None
    assert serving_mesh(MeshConfig(data_parallel=2), "cpu") is None


@pytest.fixture(scope="module")
def rank_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_parallel")
    jcfg = make_corpus(str(root), utts_per_emotion=3)
    preprocess_all(jcfg, verbose=False)
    build_rank_pair_lists(jcfg)
    rm = jcfg.rank_model
    rm.n_encoder_layers, rm.hidden_dim, rm.ffn_mult = 1, 32, 2
    jcfg.train_rank.batch_size = 5  # odd: every batch pads a row
    jcfg.train_rank.compute_dtype = "float32"
    path = str(root / "cfg.yaml")
    save_config(jcfg, path)
    return load_config(path)


def test_bucketize_over_two_devices_equals_the_unsharded_bank(rank_corpus):
    cfg = rank_corpus
    model = seeded(lambda: init_rank_model(
        build_rank_model(cfg, dtype=torch.float32, device="cpu"), 3))
    params = model.state_dict()
    want, want_storage = compute_intensity_prototypes(cfg, params, device="cpu",
                                                      return_storage=True)
    got, storage = compute_intensity_prototypes(
        cfg, params, device="cpu", return_storage=True, mesh=make_mesh(devices=CPU2))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert {k: len(v) for k, v in storage.items()} == {
        k: len(v) for k, v in want_storage.items()}  # no padded row in the bank
    assert np.abs(want).max() > 0


VOCODER = dict(SMALL_VOCODER, in_channels=80, upsample_rates=(8, 8, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4), upsample_initial_channel=32)


@pytest.fixture(scope="module")
def synths():
    """The port's Synthesizer unsharded and over a two-entry mesh on the
    CPU, on the same weights; and the JAX package's on them."""
    jcfg = shrink(JaxConfig(), fused=False)
    _, variables = fs2_variables(jcfg, seed=41)
    _, voc_tree = vocoder_params(VOCODER, seed=42, scale=0.05)
    bank = np.random.default_rng(43).standard_normal((3, 3, 3, 3)).astype(np.float32)
    structure = dict(VOCODER, fused_mrf=True, use_pallas_resblocks=True)
    one, two = (Synthesizer(shrink(Config()), variables, voc_tree, bank,
                            vocoder_structure=structure, device="cpu", mesh=mesh)
                for mesh in (None, make_mesh(devices=CPU2)))
    jsynth = JaxSynthesizer(jcfg, variables, voc_tree, bank, vocoder_structure=VOCODER)
    return one, two, jsynth


def _pcm(wav):
    return np.round(np.asarray(wav, np.float64) * 32767.0).astype(np.int64)


def test_sweep_over_two_devices_equals_the_unsharded_sweep(synths):
    one, two, _ = synths
    assert two.mesh.data == 2 and len(two._replicas) == 2
    assert two._replicas[1][0] is not two.model
    text = "Hello there, how are you?"
    want, got = one.intensity_sweep(text), two.intensity_sweep(text)
    assert len(want) == 27  # odd: the mesh pads a row
    assert set(got) == set(want)
    for key, wav in want.items():
        assert len(got[key]) == len(wav) > 0
        assert np.abs(_pcm(got[key]) - _pcm(wav)).max() <= 1, key


def test_requests_over_two_devices_equal_the_reference(synths):
    one, two, jsynth = synths
    requests = [{"text": "Quite well. Thank you.", "speaker": 1, "emotion": 2,
                 "level": 1.0},
                {"text": "Blended voice.", "speaker": 0, "emotion": 1,
                 "speaker_mix": [(0, 0.5), (2, 0.5)]}]
    got = two.synthesize_requests(requests)
    for ref in (one.synthesize_requests(requests),
                jsynth.synthesize_requests(requests)):
        for a, b in zip(got, ref):
            assert len(a) == len(b) > 0
            assert np.abs(_pcm(a) - _pcm(b)).max() <= 1

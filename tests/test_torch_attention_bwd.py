"""The port's attention backward and dropout (emotts_torch/ops/attention.py)
held against the JAX package and against themselves on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
that covers rate 0 only (its dropout draws from the TPU's generator).  At
rate > 0 the port's plain versions use the Philox mask of the CUDA kernels,
which is checked here against published Philox vectors.  The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emotts.ops.attention as fa
from emotts_torch.ops import attention as ta
from tests.torch_port_util import (KERNEL_TOL, einsum_3xtf32, jit,  # noqa: F401
                                   single_torch_thread, tf32_round)


@pytest.fixture(autouse=True)
def _interpret():
    fa._INTERPRET = True
    yield
    fa._INTERPRET = False


def _inputs(b=3, t=48, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                  for _ in range(4))
    valid = np.ones((b, t), np.float32)
    valid[1, t // 2:] = 0.0  # half-padded row
    valid[2, :] = 0.0  # fully padded row
    return q, k, v, ((1.0 - valid) * -1e9).astype(np.float32), g


# fp32: the two sides differ in summation order only.  bf16: both round P and
# dS·scale to bf16 at the same points, but an fp32 softmax that differs in
# the last bit can land a probability on the neighbouring bf16 value (one
# step is 2^-8 relative), and the outputs are rounded to bf16 themselves.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("t", [48, 33])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_pallas_interpret_vjp(dtype, t):
    q, k, v, bias, g = _inputs(t=t)
    jd = jnp.dtype(dtype)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jd) for a in (q, k, v, g))
    @jit  # one compilation instead of one per primitive
    def reference(q_, k_, v_, g_):
        _, vjp = jax.vjp(
            lambda a, b, c: fa.fused_attention(
                a, b, c, jnp.asarray(bias), jnp.zeros((3,), jnp.int32), 0.0),
            q_, k_, v_)
        return vjp(g_)

    want = reference(jq, jk, jv, jg)
    td = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(td) for a in (q, k, v, g))
    got = ta.fused_attention_bwd_plain(tq, tk, tv, torch.from_numpy(bias), tg)
    for a, w in zip(got, want):
        assert a.dtype == td
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)), **TOL[dtype])


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_backward_matches_autograd_of_plain_forward(rate):
    q, k, v, bias, g = (torch.from_numpy(a) for a in _inputs())
    seeds = torch.tensor([11, -5, 2 ** 31 - 1], dtype=torch.int32)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = ta.fused_attention_plain(q, k, v, bias, seeds, rate)
    want = torch.autograd.grad(out, (q, k, v), g)
    got = ta.fused_attention_bwd_plain(q.detach(), k.detach(), v.detach(), bias,
                                       g, seeds, rate)
    for a, w in zip(got, want):  # fp32 both, another order of the same sums
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_function_backward_is_the_plain_backward_on_cpu_and_counts_no_launch():
    q, k, v, bias, g = (torch.from_numpy(a) for a in _inputs())
    seeds = torch.tensor([1, 2, 3], dtype=torch.int32)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    counts = lambda: (ta.launch_count, ta.bwd_launch_count,  # noqa: E731
                      ta.fp32_launch_count, ta.fp32_bwd_launch_count)
    before = counts()
    out = ta.fused_attention(q, k, v, bias, seeds, 0.1)
    # autograd hands a strided gradient over: the Function makes it contiguous
    got = torch.autograd.grad(out.transpose(1, 2), (q, k, v), g.transpose(1, 2))
    assert counts() == before
    want = ta.fused_attention_bwd_plain(q.detach(), k.detach(), v.detach(), bias,
                                        g, seeds, 0.1)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_gradcheck_of_the_function_with_dropout_in_float64():
    rng = np.random.default_rng(5)
    b, t, h, d = 2, 9, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d))).requires_grad_()
               for _ in range(3))
    bias = torch.zeros(b, t)
    bias[1, 6:] = -1e9  # padded keys; a row with every key at -1e9 has no
    # usable finite difference in float64 and is covered by the tests above
    seeds = torch.tensor([5, -7], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: ta.fused_attention(q_, k_, v_, bias, seeds, 0.1),
        (q, k, v))


# Random123's known-answer vectors for philox4x32_10: counter, key, output
PHILOX_VECTORS = [
    ((0x00000000,) * 4, (0x00000000,) * 2,
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_VECTORS)
def test_philox_known_answers(counter, key, want):
    as_tensor = lambda words: [torch.tensor(w, dtype=torch.int64) for w in words]  # noqa: E731
    got = ta.philox4x32_10(as_tensor(counter), as_tensor(key))
    assert tuple(int(w) for w in got) == want


def test_keep_mask_fraction_heads_and_examples():
    rate = 0.1
    seeds = torch.tensor([7, -7, 7, 123456789], dtype=torch.int32)
    keep = ta.philox_keep_mask(seeds, 2, 96, rate)
    assert keep.shape == (4, 2, 96, 96) and keep.dtype == torch.bool
    # 73728 draws: the standard error of the fraction is 1.1e-3
    assert abs(keep.float().mean().item() - (1.0 - rate)) < 5e-3
    assert not torch.equal(keep[0, 0], keep[0, 1])  # heads differ
    assert not torch.equal(keep[0], keep[1])  # examples differ
    assert torch.equal(keep[0], keep[2])  # equal seeds, equal masks
    assert ta.dropout_threshold(rate) == int(rate * 2 ** 32)
    assert ta.dropout_threshold(0.9999999999) == 2 ** 32 - 1
    assert ta.philox_keep_mask(seeds, 2, 7, rate).shape == (4, 2, 7, 7)  # T % 4 != 0


def test_dropout_mask_is_independent_of_batch_composition():
    """Row i of a batch of 4 equals the same example alone with its seed."""
    q, k, v, bias, _ = (torch.from_numpy(a) for a in _inputs(b=4, t=24))
    seeds = torch.tensor([3, 1000, -42, 77], dtype=torch.int32)
    whole = ta.fused_attention(q, k, v, bias, seeds, 0.25)
    for i in range(4):
        alone = ta.fused_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                   bias[i:i + 1], seeds[i:i + 1], 0.25)
        # one example against four: the same sums, batched differently
        np.testing.assert_allclose(alone[0].numpy(), whole[i].numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert not torch.allclose(whole, ta.fused_attention(q, k, v, bias))


def test_fully_padded_row_has_a_finite_gradient():
    q, k, v, bias, g = (torch.from_numpy(a) for a in _inputs())
    dq, dk, dv = ta.fused_attention_bwd_plain(q, k, v, bias, g)
    assert all(torch.isfinite(x).all() for x in (dq, dk, dv))
    # uniform attention: every key's dV is the mean of the row's dO
    want = g[2].mean(dim=0, keepdim=True).expand_as(dv[2])
    np.testing.assert_allclose(dv[2].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    # padded keys of the half-padded row get no probability, hence no dV
    assert torch.equal(dv[1, 24:], torch.zeros_like(dv[1, 24:]))


# --------------------------------------------------------------------------
# The kernels' schedule (csrc/attention_bwd.cu), emulated at toy size
# --------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _pack_keep_words(keep):
    """(B, H, T, T) keep mask -> the delta pass's words (B, H, ⌈T/32⌉, T):
    bit key % 32 of word key // 32 of query q."""
    b, h, t, _ = keep.shape
    kw = (t + 31) // 32
    padded = torch.zeros(b, h, t, 32 * kw, dtype=torch.int64)
    padded[..., :t] = keep.long()
    bits = padded.reshape(b, h, t, kw, 32) << torch.arange(32)
    return bits.sum(-1).transpose(2, 3)  # disjoint bits: the sum is the OR


def _emulated_schedule(q, k, v, bias, dout, seeds, rate, bq=16, bk=32,
                       dtype=torch.bfloat16, mm=torch.matmul, rotate=False):
    """The backward as the kernels schedule it, in fp32, with the bf16
    kernels' roundings for ``dtype`` bf16 and none for fp32: a delta pass
    over the key tiles (rowsum(dP * P) from the (rounded) P, and at rate > 0
    the keep bits packed into words), then one block per key tile that forms
    S^T, P^T, dP^T and dS^T once per query tile, accumulates dV and dK, and
    hands each query tile's dQ partial on in a fixed order of key tiles: the
    key-tile order, or with ``rotate`` the fp32 pass's rotated order (query
    tile i first from key tile i // (bk // bq), then the key tiles before
    it, wrapping round).  P comes from the forward's row statistics (maximum
    m and sum l), as the kernels form it.  ``mm`` does every product (the
    fp32 kernels' 3xTF32 arithmetic: ``_matmul_3xtf32``)."""
    rnd = _bf16 if dtype == torch.bfloat16 else (lambda x: x)
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    inv_keep = 1.0 / (1.0 - rate)
    qf, kf, vf, gf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, dout))
    s_all = qf @ kf.transpose(-1, -2) * scale + bias[:, None, None, :]
    m = s_all.max(-1).values
    inv_l = 1.0 / torch.exp(s_all - m[..., None]).sum(-1)
    nkt, nqt = -(-t // bk), -(-t // bq)

    # delta pass: a sweep over the key tiles; the keep words
    words = _pack_keep_words(ta.philox_keep_mask(seeds, h, t, rate)) if rate else None
    delta = torch.zeros(b, h, t)
    for j in range(nkt):
        ks = slice(j * bk, min((j + 1) * bk, t))
        p = rnd(torch.exp(mm(qf, kf[:, :, ks].transpose(-1, -2)) * scale
                          + bias[:, None, None, ks] - m[..., None]) * inv_l[..., None])
        dp = mm(gf, vf[:, :, ks].transpose(-1, -2))
        if rate:
            keys = torch.arange(ks.start, ks.stop)
            kept = ((words[:, :, keys // 32, :].transpose(-1, -2) >> (keys % 32)) & 1).bool()
            dp = torch.where(kept, dp * inv_keep, torch.zeros(()))
        delta += (dp * p).sum(-1)

    # fused pass: one block per key tile, a sweep over the query tiles
    dk, dv = torch.zeros(b, h, t, d), torch.zeros(b, h, t, d)
    partials = [[None] * nqt for _ in range(nkt)]
    for j in range(nkt):
        ks = slice(j * bk, min((j + 1) * bk, t))
        keys = torch.arange(ks.start, ks.stop)
        for i in range(nqt):
            qs = slice(i * bq, min((i + 1) * bq, t))
            st = mm(kf[:, :, ks], qf[:, :, qs].transpose(-1, -2)) * scale  # keys x queries
            st = st + bias[:, None, ks, None]
            pt = rnd(torch.exp(st - m[:, :, None, qs]) * inv_l[:, :, None, qs])
            dpt = mm(vf[:, :, ks], gf[:, :, qs].transpose(-1, -2))
            pdt = pt
            if rate:
                kept = ((words[:, :, keys // 32, qs] >> (keys % 32)[:, None]) & 1).bool()
                pdt = torch.where(kept, rnd(pt * inv_keep), torch.zeros(()))
                dpt = torch.where(kept, dpt * inv_keep, torch.zeros(()))
            dst = rnd(pt * (dpt - delta[:, :, None, qs]) * scale)
            dv[:, :, ks] += mm(pdt, gf[:, :, qs])
            dk[:, :, ks] += mm(dst, qf[:, :, qs])
            partials[j][i] = mm(dst.transpose(-1, -2), kf[:, :, ks])

    def order(i):  # the key tiles whose partials query tile i takes, in turn
        first = i // (bk // bq) if rotate else 0
        return [(first - n) % nkt for n in range(nkt)] if rotate else range(nkt)

    dq = torch.cat([functools.reduce(torch.add, (partials[j][i] for j in order(i)))
                    for i in range(nqt)], dim=2)
    return tuple(x.permute(0, 2, 1, 3).to(dtype) for x in (dq, dk, dv))


def _one_key_inputs(t, dtype=torch.bfloat16):
    """Inputs with a half-padded, a fully padded and a one-key example: the
    last attends to key 3 alone, where a delta taken from the rounded output
    fails (the cancellation in dP - delta is exact only from P)."""
    q, k, v, bias, g = _inputs(b=4, t=t, d=32, seed=t)
    bias[3, :] = -1e9
    bias[3, 3] = 0.0
    return (*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
            torch.from_numpy(bias), torch.from_numpy(g).to(dtype))


# The fp32 schedule at toy size: as in the kernels (32 queries a step, 64
# keys a block at D <= 192), two query tiles to a key tile, the dQ partials
# in the rotated order
F32_SCHEDULE = dict(bq=8, bk=16, dtype=torch.float32, rotate=True)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [33, 48])
def test_emulated_bf16_schedule_matches_the_plain_backward(t, rate):
    q, k, v, bias, g = _one_key_inputs(t)
    seeds = torch.tensor([4, -9, 2 ** 31 - 1, 77], dtype=torch.int32)
    got = _emulated_schedule(q, k, v, bias, g, seeds, rate)
    want = ta.fused_attention_bwd_plain(q, k, v, bias, g, seeds, rate)
    for a, w in zip(got, want):
        assert torch.isfinite(a.float()).all()
        np.testing.assert_allclose(a.float().numpy(), w.float().numpy(), **TOL["bfloat16"])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [33, 48])
def test_emulated_fp32_schedule_matches_the_plain_backward(t, rate):
    q, k, v, bias, g = _one_key_inputs(t, torch.float32)
    seeds = torch.tensor([4, -9, 2 ** 31 - 1, 77], dtype=torch.int32)
    got = _emulated_schedule(q, k, v, bias, g, seeds, rate, **F32_SCHEDULE)
    want = ta.fused_attention_bwd_plain(q, k, v, bias, g, seeds, rate)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), w.numpy(), **TOL["float32"])


def _tf32_truncate(x):
    """What the tensor cores read of an fp32 operand: its TF32 part, the low
    13 bits of the mantissa dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _matmul_3xtf32(a, b):
    """The fp32 backward kernels' products: each operand split into hi, v
    rounded to TF32 (``tf32_round``), and lo = v - hi read truncated to TF32
    (``csrc/attention_bwd.cu::split_tf32_alu``), and lo·hi + hi·lo + hi·hi
    summed in fp32."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = _tf32_truncate(a - ah), _tf32_truncate(b - bh)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("split", ["lo_rounded", "lo_truncated"])
def test_emulated_fp32_schedule_in_3xtf32_holds_the_kernel_tolerance(split):
    """Every product of the fp32 schedule in 3xTF32, lo rounded to TF32 as
    ``einsum_3xtf32`` rounds it or read truncated as the kernels read it,
    against the fp32 plain backward at chip_smoke.py's fp32 tolerance."""
    q, k, v, bias, g = _one_key_inputs(48, torch.float32)
    seeds = torch.tensor([4, -9, 2 ** 31 - 1, 77], dtype=torch.int32)
    mm = (functools.partial(einsum_3xtf32, "...ij,...jk->...ik") if split == "lo_rounded"
          else _matmul_3xtf32)
    got = _emulated_schedule(q, k, v, bias, g, seeds, 0.1, **F32_SCHEDULE, mm=mm)
    want = ta.fused_attention_bwd_plain(q, k, v, bias, g, seeds, 0.1)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=KERNEL_TOL["rtol"],
                                   atol=KERNEL_TOL["atol"])


def test_query_tiles_of_the_counters_are_the_fused_passes():
    """The wrapper sizes the dQ counters by the fused passes' query tiles:
    ``_bwd_query_tile`` against the constants of csrc/attention_bwd.cu."""
    import pathlib
    import re

    src = (pathlib.Path(ta.__file__).parents[1] / "csrc" / "attention_bwd.cu").read_text()

    def bq(struct):
        body = src[src.index(f"struct {struct} {{"):]
        return re.search(r"static constexpr int BQ = ([^;]+);", body).group(1)

    assert bq("BwdFusedTc") == "64"
    assert bq("BwdFusedF32") == "D > 192 ? 16 : 32"
    for d in (32, 64, 96, 128, 192, 256):
        assert ta._bwd_query_tile(d, True) == 64
        assert ta._bwd_query_tile(d, False) == (16 if d > 192 else 32)


def test_keep_words_round_trip_the_philox_mask():
    seeds = torch.tensor([5, -6], dtype=torch.int32)
    keep = ta.philox_keep_mask(seeds, 2, 77, 0.1)
    words = _pack_keep_words(keep)
    assert words.shape == (2, 2, 3, 77) and int(words.max()) < 2 ** 32
    keys = torch.arange(77)
    back = ((words[:, :, keys // 32, :].transpose(-1, -2) >> (keys % 32)) & 1).bool()
    assert torch.equal(back, keep)


def test_emulated_bf16_schedule_matches_pallas_interpret_with_a_one_key_row():
    q, k, v, bias, g = _one_key_inputs(48)
    got = _emulated_schedule(q, k, v, bias, g, torch.zeros(4, dtype=torch.int32), 0.0)

    @jit
    def reference(q_, k_, v_, g_):
        _, vjp = jax.vjp(lambda a, b, c: fa.fused_attention(
            a, b, c, jnp.asarray(bias.numpy()), jnp.zeros((4,), jnp.int32), 0.0), q_, k_, v_)
        return vjp(g_)

    want = reference(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v, g)))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   **TOL["bfloat16"])
    # the one-key example: every query's weight on key 3, so only its dV
    assert torch.nonzero(got[2][3].float().abs().sum((-2, -1))).flatten().tolist() == [3]

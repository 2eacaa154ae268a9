"""The port's attention backward and dropout (emotts_torch/ops/attention.py)
held against the JAX package and against themselves on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
that covers rate 0 only (its dropout draws from the TPU's generator).  At
rate > 0 the port's plain versions use the Philox mask of the CUDA kernels,
which is checked here against published Philox vectors.  The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emotts.ops.attention as fa
from emotts_torch.ops import attention as ta
from tests.torch_port_util import jit, single_torch_thread  # noqa: F401


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
    before = ta.launch_count, ta.bwd_launch_count
    out = ta.fused_attention(q, k, v, bias, seeds, 0.1)
    # autograd hands a strided gradient over: the Function makes it contiguous
    got = torch.autograd.grad(out.transpose(1, 2), (q, k, v), g.transpose(1, 2))
    assert (ta.launch_count, ta.bwd_launch_count) == before
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

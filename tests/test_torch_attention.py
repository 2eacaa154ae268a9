"""The port's attention (emotts_torch/ops/attention.py, nn/blocks.py) held
against the JAX package on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do.
On the CPU the port's wrapper takes the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emotts.ops.attention as fa
from emotts.nn.blocks import MultiHeadSelfAttention as JaxMHSA
from emotts_torch.nn.blocks import MultiHeadSelfAttention
from emotts_torch.nn.convert import fs2_from_flax
from emotts_torch.ops import attention as ta
from tests.torch_port_util import (  # noqa: F401
    KERNEL_TOL, einsum_3xtf32, einsum_tf32, jit, single_torch_thread, within)

# fp32 on both sides; the two differ in summation order only
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret():
    fa._INTERPRET = True
    yield
    fa._INTERPRET = False


def _inputs(b=3, t=48, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    valid = np.ones((b, t), np.float32)
    valid[1, t // 2:] = 0.0  # half-padded row
    valid[2, :] = 0.0  # fully padded row
    return q, k, v, ((1.0 - valid) * -1e9).astype(np.float32)


@pytest.mark.parametrize("t", [48, 33])
def test_plain_attention_matches_pallas_interpret(t):
    q, k, v, bias = _inputs(t=t)
    ref = fa.fused_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias)), jnp.zeros((3,), jnp.int32), 0.0
    )
    got = ta.fused_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fully_padded_row_is_uniform_mean_of_values():
    """The bias is an additive -1e9, not -inf: a row with every key padded
    attends uniformly, in the reference and in the port."""
    q, k, v, bias = _inputs()
    got = ta.fused_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    want = np.broadcast_to(v[2].mean(axis=0, keepdims=True), v[2].shape)
    np.testing.assert_allclose(got[2].numpy(), want, **TOL)


def test_cpu_wrapper_counts_no_launch_and_dropout_is_refused():
    """Dropout is refused only where it cannot be drawn: without seeds, or
    at a rate outside [0, 1).  With seeds it runs, on the CPU through the
    plain version, and counts no launch."""
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs())
    before = ta.launch_count, ta.bwd_launch_count
    ta.fused_attention(q, k, v, bias)
    seeds = torch.arange(3, dtype=torch.int32)
    dropped = ta.fused_attention(q, k, v, bias, seeds, rate=0.1)
    assert dropped.shape == q.shape and torch.isfinite(dropped).all()
    assert (ta.launch_count, ta.bwd_launch_count) == before
    with pytest.raises(ValueError):
        ta.fused_attention(q, k, v, bias, rate=0.1)  # no seeds
    with pytest.raises(ValueError):
        ta.fused_attention(q, k, v, bias, seeds.long(), rate=0.1)  # not int32
    with pytest.raises(ValueError):
        ta.fused_attention(q, k, v, bias, seeds, rate=1.0)
    with pytest.raises(ValueError):
        ta.fused_attention(q, k, v, bias[:, :-1])


@pytest.mark.parametrize("fused", [True, False])
def test_multi_head_self_attention_matches_flax(fused):
    rng = np.random.default_rng(3)
    d_model, heads, b, t = 32, 2, 3, 24
    x = rng.standard_normal((b, t, d_model)).astype(np.float32)
    valid = np.ones((b, t), bool)
    valid[1, 10:] = False
    jm = JaxMHSA(d_model, heads, 0.0, fused=fused)
    shapes = jm.init({"params": __import__("jax").random.PRNGKey(0)},
                     jnp.asarray(x), jnp.asarray(valid), True)["params"]
    params = {
        name: {leaf: (0.2 * rng.standard_normal(np.shape(a))).astype(np.float32)
               for leaf, a in sorted(sub.items())}
        for name, sub in sorted(shapes.items())
    }
    ref = jit(lambda p, x, v: jm.apply(p, x, v, True))(  # one compilation
        {"params": params}, jnp.asarray(x), jnp.asarray(valid))

    tm = MultiHeadSelfAttention(d_model, heads, fused=fused)
    # the converter recognises attention projections by their "attn" parent
    sd = fs2_from_flax({"params": {"attn": params}})
    tm.load_state_dict({k[len("attn."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("code,reason", [
    (1001, "shape or size"), (1002, "shared memory"), (1003, "16-byte aligned"),
    (1004, "tensor map"), (700, "CUDA error 700"),
])
def test_kernel_return_codes_raise_with_their_reason(code, reason):
    """A C entry point's non-zero return is raised with what it means (the
    bf16 kernels add 1003 for misaligned data and 1004 for a TMA tensor map
    the driver refused); 0 passes."""
    from emotts_torch.ops import _build

    _build.check(0, "entry")
    with pytest.raises(RuntimeError, match=reason):
        _build.check(code, "entry")


def test_3xtf32_design_holds_the_fp32_tolerance(monkeypatch):
    """The fp32 CUDA kernels' arithmetic, emulated in plain torch: every
    product of the plain forward and backward as 3xTF32 stays within the
    kernels' fp32 tolerance of the fp32 plain versions; one TF32 product a
    term would not."""
    rng = np.random.default_rng(8)
    b, t, h, d = 2, 64, 2, 192
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
                     for _ in range(4))
    bias = torch.zeros(b, t)
    bias[1, 40:] = -1e9  # one padded row

    def run():
        return (ta.fused_attention_plain(q, k, v, bias),
                *ta.fused_attention_bwd_plain(q, k, v, bias, dout))

    want = run()
    for product, holds in ((einsum_3xtf32, True), (einsum_tf32, False)):
        with monkeypatch.context() as m:
            m.setattr(ta.torch, "einsum", product)
            got = run()
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            assert within(g, w, **KERNEL_TOL) == holds, (product.__name__, name)

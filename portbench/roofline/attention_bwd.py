"""Self-attention backward: 10·H·D·Σ_b T_b² operations (FlashAttention's
count: dV, dP, dQ, dK and the recomputed S), T_b as in the forward.
Bytes: q, k, v, dout read and dq, dk, dv written once, (B, T, H, D) each,
the key bias and the forward's row statistics (2·B·H·T float32)."""

from roofline.peaks import BYTES, bound_s


def ops(heads, head_dim, lengths) -> float:
    return 10.0 * heads * head_dim * sum(float(t) ** 2 for t in lengths)


def nbytes(batch, t, heads, head_dim, dtype) -> float:
    return (7.0 * batch * t * heads * head_dim * BYTES[dtype] + 4.0 * batch * t
            + 8.0 * batch * heads * t)


def bound(batch, t, heads, head_dim, lengths, dtype) -> float:
    return bound_s(ops(heads, head_dim, lengths), nbytes(batch, t, heads, head_dim, dtype), dtype)

"""Self-attention forward: 4·H·D·Σ_b T_b² operations (QKᵀ and PV), T_b
each row's valid length as its key mask gives it (the call's T without a
mask).  Bytes: q, k, v read and out written once, (B, T, H, D) each, and
the (B, T) float32 key bias."""

from roofline.peaks import BYTES, bound_s


def ops(heads, head_dim, lengths) -> float:
    return 4.0 * heads * head_dim * sum(float(t) ** 2 for t in lengths)


def nbytes(batch, t, heads, head_dim, dtype) -> float:
    return 4.0 * batch * t * heads * head_dim * BYTES[dtype] + 4.0 * batch * t


def bound(batch, t, heads, head_dim, lengths, dtype) -> float:
    return bound_s(ops(heads, head_dim, lengths), nbytes(batch, t, heads, head_dim, dtype), dtype)

"""The attention dropout's keep mask as the rank model's configuration
defines it: per example b and head h, Philox4x32-10 keyed by
(seed[b] + h·(−1640531527) mod 2³², 0), counter (query, key // 4, 0, 0),
word key % 4; an entry is kept where its word is at least
min(int(rate·2³²), 2³²−1).  Computed in int64 arithmetic."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_HEAD_MIX = -1640531527
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _philox(c0, c1, c2, c3, k0, k1):
    for _ in range(10):
        p0, p1 = c0 * _M0, c2 * _M1
        c0, c1, c2, c3 = ((p1 >> 32) & _M32) ^ c1 ^ k0, p1 & _M32, \
            ((p0 >> 32) & _M32) ^ c3 ^ k1, p0 & _M32
        k0, k1 = (k0 + _W0) & _M32, (k1 + _W1) & _M32
    return c0, c1, c2, c3


def keep_mask(seeds: torch.Tensor, heads: int, t: int, rate: float) -> torch.Tensor:
    """(B, H, T, T) bool, True where the probability is kept."""
    i64 = dict(dtype=torch.int64, device=seeds.device)
    key = (seeds.to(**i64)[:, None] + torch.arange(heads, **i64)[None] * _HEAD_MIX) & _M32
    groups = (t + 3) // 4
    zero = torch.zeros((), **i64)
    words = _philox(torch.arange(t, **i64)[None, None, :, None],
                    torch.arange(groups, **i64)[None, None, None, :], zero, zero,
                    key[:, :, None, None], zero)
    bits = torch.stack(words, -1).reshape(seeds.shape[0], heads, t, 4 * groups)[..., :t]
    return bits >= min(int(rate * 2.0 ** 32), 2 ** 32 - 1)

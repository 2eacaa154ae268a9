"""Weights made on the card from the seed, in a few large calls.

Each tensor of a model's state is one of: a matrix drawn N(0, 1/fan_in),
a vector of ones (norm scales, running variances) or of zeros (biases,
shifts, running means).  All matrices come from one normal draw on the
card, cut into views and scaled by one multiply; the caller names the
rule of each tensor.  The program and the reference are handed the same
tensors."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

# (rule, fan_in): rule is "normal", "ones" or "zeros"
Rule = Tuple[str, int]


def card_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def seeded_state(shapes: Dict[str, torch.Size], rule: Callable[[str, torch.Size], Rule],
                 gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    names = list(shapes)
    rules = {n: rule(n, shapes[n]) for n in names}
    normal = [n for n in names if rules[n][0] == "normal"]
    sizes = [shapes[n].numel() for n in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.repeat_interleave(
        torch.tensor([rules[n][1] ** -0.5 for n in normal], device=device),
        torch.tensor(sizes, device=device))
    flat.mul_(scale)
    out = dict(zip(normal, (v.view(shapes[n]) for n, v in
                            zip(normal, torch.split(flat, sizes)))))
    for n in names:
        kind = rules[n][0]
        if kind == "ones":
            out[n] = torch.ones(shapes[n], device=device)
        elif kind == "zeros":
            out[n] = torch.zeros(shapes[n], device=device)
        elif kind != "normal":
            raise ValueError(f"unknown rule {kind!r} for {n}")
    return {n: out[n] for n in names}

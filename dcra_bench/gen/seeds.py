"""Sub-seeds: one stream of random numbers per purpose, each derived from
the run's ``--seed`` (any whole number up to 2**63) and a fixed tag, so
that adding a draw for one purpose moves no other."""
from __future__ import annotations

MASK = (1 << 63) - 1
GOLDEN = 0x9E3779B97F4A7C15


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for purpose ``tag`` of run seed ``seed`` (splitmix64's
    finaliser over the pair)."""
    z = (int(seed) * GOLDEN + int(tag) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & MASK


def generator(seed: int, tag: int, device):
    """A ``torch.Generator`` on ``device`` seeded for purpose ``tag``."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    return gen


def sample(n: int, k: int, seed: int, tag: int) -> list:
    """``min(n, k)`` distinct indices of ``range(n)``, drawn from the seed,
    in increasing order: which answers of the window are checked."""
    import torch
    gen = torch.Generator()
    gen.manual_seed(sub_seed(seed, tag))
    return sorted(torch.randperm(int(n), generator=gen)[:int(k)].tolist())

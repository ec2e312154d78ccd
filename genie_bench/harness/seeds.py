"""Seeds: every input of a run is drawn from `--seed` through a named stream,
so a reference can draw any part again without drawing the rest."""
from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream `tags` of the run seed `seed` (any whole
    number, also past 32 bits)."""
    digest = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def generator(seed: int, *tags, device) -> torch.Generator:
    """A torch.Generator on `device` seeded for the stream `tags`."""
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))

"""Inputs made from ``--seed``: the host generators of its named streams,
the object population and the serving driver's stream seed.

The same seed gives the same inputs.  Sizes never depend on the seed:
seeds change which ids go where, not how much work a run does.  A
configuration's capacities come from its law (``laws/<kind>.py``), drawn
from the seed's stream 1.
"""

from __future__ import annotations

import numpy as np
import torch

from chipbench.reference.asura import M32, fmix32, mul32

ODD = 0x2545F491  # an odd multiplier: i -> i * ODD + salt is a bijection mod 2**32


def rng(seed: int, stream: int) -> np.random.Generator:
    """A host generator for one named stream of a run's seed."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def salt(seed: int, stream: int) -> int:
    return int(rng(seed, stream).integers(0, 2**32, dtype=np.uint64))


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> a uint32 tensor of the same bits."""
    return (((x & M32) ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.uint32)


def population(n: int, seed: int, device) -> torch.Tensor:
    """``n`` DISTINCT object ids (uint32, on ``device``): the salted
    bijection ``fmix32(i * ODD + salt)`` of 0 .. n - 1."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return to_u32(fmix32((mul32(i, ODD) + salt(seed, 3)) & M32))


def stream_seed(seed: int) -> int:
    """The serving driver's 32-bit stream seed, derived from the run's."""
    return int(rng(seed, 4).integers(0, 2**31))


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(salt(seed, stream) | (stream << 32))
    return g

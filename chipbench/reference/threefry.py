"""Counter-based selection words: Threefry-2x32 (Salmon et al., SC'11).

The serving driver takes each request's selection word from a
counter-based stream: the batch key is the stream key folded with the
batch's position, each lane folds in its index, and word ``j`` is
``y0 ^ y1`` of ``threefry2x32(lane key, (0, j))`` -- the construction of
``jax.random``'s partitionable mode, written here from the published
cipher (20 rounds, rotations 13 15 26 6 / 17 29 16 24, key parity
0x1BD11BDA).  ``threefry2x32`` takes Python ints and int64 tensors of
u32 values alike; ``lane_words`` runs the cipher on int32 tensors of the
same bits (adds wrap, right shifts masked), which moves half the bytes.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _add(a, b):
    return (a + b) & M32


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = _add(x0, ks[0])
    x1 = _add(x1, ks[1])
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = _add(x0, x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _add(x0, ks[(i + 1) % 3])
        x1 = _add(x1, _add(ks[(i + 2) % 3], i + 1))
    return x0, x1


def stream_key(seed: int) -> tuple[int, int]:
    """The key of a stream seeded with a 32-bit signed ``seed``."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"stream seed must fit in int32, got {seed}")
    return 0, seed & M32


def fold_in(key, data):
    return threefry2x32(key[0], key[1], 0, data & M32)


def _i32(v: int) -> int:
    """A u32 value as the int32 of the same bits."""
    v &= M32
    return v - (1 << 32) if v >> 31 else v


def _rotl32(x, r: int):
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry32(k0, k1, x0, x1):
    """``threefry2x32`` on int32 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _i32(PARITY))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl32(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def lane_words(key, step: int, lanes: torch.Tensor, n_words: int) -> torch.Tensor:
    """(len(lanes), n_words) int64 u32 words of the stream at ``step``."""
    b0, b1 = fold_in(key, int(step))
    lanes32 = (((lanes & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)
    zero = torch.zeros_like(lanes32)
    k0, k1 = _threefry32(zero + _i32(b0), zero + _i32(b1), zero, lanes32)
    words = []
    for j in range(n_words):
        y0, y1 = _threefry32(k0, k1, zero, zero + j)
        words.append((y0 ^ y1).to(torch.int64) & M32)
    return torch.stack(words, dim=1)

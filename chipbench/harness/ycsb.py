"""YCSB's scrambled zipfian request keys, on the device.

A copy of the arithmetic of YCSB's ``ScrambledZipfianGenerator`` (Cooper
et al., SoCC'10; ``site.ycsb.generator``), which core workload C uses
with ``requestdistribution=zipfian``:

  * a ``ZipfianGenerator`` over ``ITEM_COUNT = 10**10`` items (so
    ``10**10 + 1`` values) with constant 0.99 and YCSB's precomputed
    ``ZETAN = 26.46902820178302``: for ``u`` uniform on [0, 1),
    ``u * zetan < 1`` gives 0, ``< 1 + 0.5**theta`` gives 1, else
    ``floor(items * (eta * u - eta + 1) ** alpha)`` with ``alpha = 1 / (1
    - theta)`` and ``eta = (1 - (2 / items) ** (1 - theta)) / (1 -
    zeta(2, theta) / zetan)``;
  * the value is scrambled over the records by ``fnvhash64`` (FNV-1a
    over its 8 little-endian bytes, then ``Math.abs``) modulo the record
    count.

The 64-bit hash is carried as two u32 halves in int64, so no product
overflows.  ``Math.abs(Long.MIN_VALUE)`` stays negative in Java; here it
is taken as ``2**63`` (a case of probability ``2**-64``).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME_LOW = 0x1B3  # FNV_PRIME_64 = 2**40 + 0x1B3


def zipfian_values(u: torch.Tensor, *, items: int, theta: float, zetan: float) -> torch.Tensor:
    """``ZipfianGenerator.nextLong`` for uniform float64 draws ``u``."""
    zeta2 = 1.0 + 0.5**theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    uz = u * zetan
    ret = torch.floor(items * torch.pow(eta * u - eta + 1.0, alpha)).to(torch.int64)
    ret = torch.where(uz < 1.0 + 0.5**theta, torch.ones_like(ret), ret)
    return torch.where(uz < 1.0, torch.zeros_like(ret), ret)


def fnvhash64_mod(values: torch.Tensor, modulus: int) -> torch.Tensor:
    """``Math.abs(fnvhash64(v)) % modulus`` for non-negative int64 ``v``."""
    hi = torch.full_like(values, FNV_OFFSET >> 32)
    lo = torch.full_like(values, FNV_OFFSET & M32)
    v = values
    for _ in range(8):
        lo = lo ^ (v & 0xFF)
        v = v >> 8
        low = lo * FNV_PRIME_LOW
        hi = (hi * FNV_PRIME_LOW + (low >> 32) + (lo << 8)) & M32
        lo = low & M32
    neg = hi >= 0x80000000
    nlo = (-lo) & M32
    nhi = ((~hi) + (lo == 0).to(torch.int64)) & M32
    hi = torch.where(neg, nhi, hi)
    lo = torch.where(neg, nlo, lo)
    m = int(modulus)
    return ((hi % m) * ((1 << 32) % m) + lo) % m


def scrambled_zipfian(u: torch.Tensor, records: int, traffic: dict) -> torch.Tensor:
    """Record indices in [0, records) for the draws ``u``."""
    z = zipfian_values(u, items=int(traffic["zipfian_items"]) + 1,
                       theta=float(traffic["zipfian_constant"]),
                       zetan=float(traffic["zetan"]))
    return fnvhash64_mod(z, records)

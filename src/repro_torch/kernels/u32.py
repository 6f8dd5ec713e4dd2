"""Exact u32 arithmetic on torch tensors: the one rule the twins follow.

torch's ``uint32`` dtype stores bit patterns but lacks ``+``, ``<<``,
``>>``, ``<`` and ``searchsorted`` (CPU builds of torch 2.13), so every
plain-torch twin carries u32 values in ``int64`` and keeps them in
[0, 2**32):

  * ``x + y`` and ``x << s`` are masked with ``0xFFFFFFFF`` right after
    (``add32``, ``shl32``); ``>>``, ``^``, ``&``, ``|`` and compares need
    no mask on in-range values;
  * a u32 * u32 product needs 64 bits, which overflows signed ``int64``,
    so ``mul32`` multiplies by the 16-bit halves of one operand (each
    partial product stays below 2**48) and keeps the low 32 bits;
  * ``mulhi32`` is the high half ``(a * b) >> 32`` through the same
    halves -- the tail's 95-bit product needs it.

At the boundaries, ``as_u32`` widens any integer tensor (``uint32`` bit
patterns, ``int32``, ``int64``) to that representation and ``to_u32``
narrows it back to a ``uint32`` tensor the CUDA kernels read.  Both go
through ``int32`` views so they use only ops every torch build has on
every device.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_SIGN = 0x80000000


def add32(a, b):
    """(a + b) mod 2**32."""
    return (a + b) & M32


def shl32(a, s: int):
    """(a << s) mod 2**32 for 0 <= s < 32."""
    return (a << s) & M32


def mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2**32 for a, c in [0, 2**32) without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mulhi32(a: torch.Tensor, c) -> torch.Tensor:
    """floor(a * c / 2**32) for a, c in [0, 2**32), exact in int64."""
    return (a * (c >> 16) + ((a * (c & 0xFFFF)) >> 16)) >> 16


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its value mod 2**32."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & M32


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> a ``uint32`` tensor (same bits)."""
    signed = ((x & M32) ^ _SIGN) - _SIGN  # two's complement in int32 range
    return signed.to(torch.int32).view(torch.uint32)

"""Unsigned 64/32-bit arithmetic on signed torch tensors.

torch's uint64 supports only `&`, `^`, `==`, `*` and indexing on the CPU, so
the port keeps every 64-bit plane as int64 holding the uint64 bit pattern
(and every uint32 plane as int32). Addition, subtraction, multiplication,
`&`, `|`, `^` and `<<` are the same on both readings (two's complement
wraps); what differs is the right shift, the comparison and the leading-zero
count, which these helpers provide.
"""

from __future__ import annotations

import torch

_I64_MIN = -(1 << 63)


def s64(v: int) -> int:
    """A uint64 constant as the int64 with the same bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int64 plane read as uint64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b for int64 planes read as uint64."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of an int64 plane read as uint64 (64 for zero), as
    int64: a six-step binary search over the top bits."""
    n = torch.zeros_like(x)
    y = x
    for s in (32, 16, 8, 4, 2, 1):
        z = lsr(y, 64 - s) == 0
        n = n + z.to(x.dtype) * s
        y = torch.where(z, y << s, y)
    return torch.where(x == 0, torch.full_like(x, 64), n)


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same low 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF

"""Plain PyTorch k-mer window ops: packing, canonicalization, window OR and
minimum, minimizers.

Counterparts of krakenuniq_tpu.kmer.ops (reference semantics cited there) on
int64 planes that hold the uint64 k-mer bits (ints.py). A (B, LB) base-code
tensor yields all (B, LB-k+1) k-mers at once. On the card the classify step
runs these fused in the `kmer_front` kernel, and the minimizer bins of the
binary-search lookup in the `kmer_bins` kernel (classify/device_step.py);
these plain versions are their reference and their CPU path.
"""

from __future__ import annotations

import torch

from ..ints import lsr
from ..utils.bits import INDEX2_XOR_MASK

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF


def reverse_complement(kmer: torch.Tensor, n: int) -> torch.Tensor:
    """2-bit reverse complement of int64 k-mers (krakendb.cpp:218-225).
    Each masked swap clears the bits an arithmetic shift smears in, so only
    the two full-width shifts need the logical form."""
    x = kmer
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M4) | ((x & _M4) << 4)
    x = ((x >> 8) & _M8) | ((x & _M8) << 8)
    x = ((x >> 16) & _M16) | ((x & _M16) << 16)
    x = lsr(x, 32) | (x << 32)
    return lsr(~x, 64 - (n << 1))


def canonical_representation(kmer: torch.Tensor, n: int) -> torch.Tensor:
    """min(kmer, revcomp): both are below 2^62 for n <= 31, so the signed
    minimum equals the unsigned one."""
    return torch.minimum(kmer, reverse_complement(kmer, n))


def pack_windows(codes: torch.Tensor, n: int) -> torch.Tensor:
    """Pack every length-n window of 2-bit codes into int64, first base in
    the highest bits: (..., L) uint8 -> (..., L-n+1) int64."""
    length = codes.shape[-1]
    w = length - n + 1
    if w <= 0:
        raise ValueError(f"window {n} longer than axis {length}")
    c64 = codes.to(torch.int64)
    out = torch.zeros(codes.shape[:-1] + (w,), dtype=torch.int64, device=codes.device)
    for t in range(n):
        out |= c64[..., t : t + w] << (2 * (n - 1 - t))
    return out


def window_any(flags: torch.Tensor, n: int) -> torch.Tensor:
    """Per-window OR over length-n windows: (..., L) bool -> (..., L-n+1)
    bool (a k-mer is ambiguous iff any of its bases is, krakenutil.cpp:271-275)."""
    x = flags
    covered = 1
    # dilated OR cascade: after each step, x[i] = any(flags[i : i+covered])
    while covered < n:
        step = min(covered, n - covered)
        x = x[..., : x.shape[-1] - step] | x[..., step:]
        covered += step
    return x


def window_min(vals: torch.Tensor, n: int) -> torch.Tensor:
    """Sliding minimum over length-n windows: (..., L) -> (..., L-n+1)."""
    x = vals
    covered = 1
    while covered < n:
        step = min(covered, n - covered)
        x = torch.minimum(x[..., : x.shape[-1] - step], x[..., step:])
        covered += step
    return x


def minimizers(codes: torch.Tensor, k: int, nt: int) -> torch.Tensor:
    """Scrambled minimizer (bin key) of every k-mer window of a (B, LB)
    code batch, as int64 (below 4^nt): bin_key(canonical k-mer) of
    krakendb.cpp:200-215. The canonical nt-mers of a window are the same
    in both directions, so the bin key is the sliding minimum of the
    per-position (xor_mask ^ canonical nt-mer) values."""
    mask = (1 << (2 * nt)) - 1
    xm = int(INDEX2_XOR_MASK) & mask
    scrambled = xm ^ canonical_representation(pack_windows(codes, nt), nt)
    return window_min(scrambled, k - nt + 1)  # (..., L-k+1)
